"""Light-client server + verification: the port of ``lighthouse_tpu/light_client``
(ref ``consensus/types`` LightClient* containers,
``beacon_chain/src/light_client_server_cache.rs``, and the spec's altair
light-client sync protocol), over the port's ``ssz``, ``types``, ``store``,
``bls`` and ``ops``.

The server cache subscribes to block imports: every altair+ block whose sync
aggregate meets MIN_SYNC_COMMITTEE_PARTICIPANTS yields an optimistic update
(the aggregate attests the parent header) and, when the attested state knows a
finalized header, a finality update. Bootstraps (header + current sync
committee + merkle branch) are served per held block root. Branches are REAL
SSZ proofs generated from the state's field tree
(ssz.merkle.merkle_branch_from_chunks) and verify against the spec
generalized indices (current=54, next=55, finality root=105 for a 32-field
state tree).

``engine`` is the device-batched update verification (one combined pairing
check per batch of heterogeneous sessions behind ``set_lc_backend``, failing
CLOSED under the ``lc_device`` fault domain) and ``update_store`` the
period-indexed, spec-ranked ``LightClientUpdate`` archive behind the
LightClientUpdatesByRange Req/Resp method.
"""

from .engine import (
    LcEngine,
    get_lc_backend,
    set_lc_backend,
    verify_update_batch,
)
from .proofs import field_branch
from .server_cache import LightClientServerCache
from .types import light_client_types
from .update_store import LightClientUpdateStore, is_better_update
from .verify import verify_light_client_update

__all__ = [
    "LcEngine",
    "LightClientServerCache",
    "LightClientUpdateStore",
    "field_branch",
    "get_lc_backend",
    "is_better_update",
    "light_client_types",
    "set_lc_backend",
    "verify_light_client_update",
    "verify_update_batch",
]
