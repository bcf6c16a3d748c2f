"""Beacon-API HTTP server (Lighthouse's ``beacon_node/http_api``): the port's
copy of ``lighthouse_tpu/http_api/``.

Serves the validator-required slice of the Eth Beacon API over stdlib HTTP:
genesis/fork/finality/validators state queries, node syncing, proposer and
attester duties, attestation data, unsigned block production, and publication
of signed blocks and attestations. Container payloads travel as SSZ hex
inside JSON envelopes ({"data": "0x..."}) — the SSZ-wire flavor of the
Beacon API's dual JSON/SSZ content negotiation (``http_api/src/lib.rs``).
"""

from .server import BeaconApiServer  # noqa: F401
