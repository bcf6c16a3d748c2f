"""Validator client (Lighthouse's ``validator_client/*``), a duties-driven
signer: the port's copy of ``lighthouse_tpu/validator_client/``."""

from .beacon_node_fallback import AllErrored, BeaconNodeFallback, Health
from .doppelganger import DoppelgangerService
from .keymanager import KeymanagerServer
from .slashing_protection import NotSafe, SlashingDatabase
from .validator_store import ValidatorStore
from .web3signer import MockWeb3Signer, Web3SignerMethod
