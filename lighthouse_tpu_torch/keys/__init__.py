"""Key management: EIP-2333 derivation, EIP-2335 keystores, EIP-2386 wallets
(Lighthouse's ``crypto/eth2_key_derivation``, ``crypto/eth2_keystore`` and
``crypto/eth2_wallet``): the port's copy of ``lighthouse_tpu/keys/``.
"""

from .derivation import derive_child_sk, derive_master_sk, path_to_nodes, derive_sk_from_path  # noqa: F401
from .keystore import Keystore, KeystoreError  # noqa: F401
from .wallet import Wallet  # noqa: F401
