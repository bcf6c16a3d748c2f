"""Typed Beacon-API HTTP client (Lighthouse's ``common/eth2``): the port's copy
of ``lighthouse_tpu/api_client/``.

Used by the validator client's services and by tests/tools; every method maps
one endpoint of ``http_api`` (``common/eth2/src/lib.rs`` BeaconNodeHttpClient).
"""

from .client import ApiClientError, BeaconNodeHttpClient  # noqa: F401
