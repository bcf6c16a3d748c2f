"""In-process test harness (Lighthouse's test_utils.rs), the port's copy of
``lighthouse_tpu/testing``: ``StateHarness`` only so far."""

from .harness import StateHarness  # noqa: F401
