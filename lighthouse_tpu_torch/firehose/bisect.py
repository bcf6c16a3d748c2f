"""Split-and-retry isolation of poisoned signature-set batches: the port's
copy of ``lighthouse_tpu/firehose/bisect.py``.

A random-linear-combination batch verify returns one bit for the whole
batch. When it fails, the reference re-verifies every set individually
(``attestation_verification/batch.rs:109-113``) — n extra verifies for one
bad set. Bisection does it in O(bad * log n): verify each half, recurse into
failing halves only. Every recursion level still runs as *batched* device
calls, so the device shapes stay in the compiled bucket family.
"""

from __future__ import annotations


def bisect_verify(groups, verify_fn, assume_failed: bool = False) -> list[bool]:
    """Per-group verdicts for a batch of signature-set groups.

    ``groups``: list of groups, each a list of signature-set items that must
    verify *together* (one item for an unaggregated attestation; three for a
    SignedAggregateAndProof). ``verify_fn(flat_items) -> bool`` is the
    batched verifier. ``assume_failed=True`` skips the initial whole-batch
    call (the caller already saw it fail).

    Exactly the groups whose own items fail verification come back False;
    an RLC batch failure anywhere above them never condemns a good group.
    """
    groups = list(groups)
    verdicts = [True] * len(groups)

    def rec(lo: int, hi: int, known_failed: bool) -> None:
        items = [item for g in groups[lo:hi] for item in g]
        if not items:
            return
        if not known_failed and verify_fn(items):
            return
        if hi - lo == 1:
            verdicts[lo] = False
            return
        mid = (lo + hi) // 2
        # a failed parent batch does NOT mean both halves fail — re-verify each
        rec(lo, mid, False)
        rec(mid, hi, False)

    rec(0, len(groups), assume_failed)
    return verdicts
