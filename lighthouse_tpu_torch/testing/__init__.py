"""In-process test harness (Lighthouse's test_utils.rs and simulator), the
port's copy of ``lighthouse_tpu/testing``: ``StateHarness``, the
``LocalNetwork`` simulator and the light-client session fabricator."""

from .harness import StateHarness  # noqa: F401
from .lc_workload import fabricate_lc_sessions, tamper_session  # noqa: F401
from .local_network import LocalNetwork  # noqa: F401
