"""Req/Resp rate limiter: token buckets per (peer, protocol).

The twin of the reference's ``lighthouse_network/src/rpc/rate_limiter.rs:1-531``:
each inbound request spends tokens from a per-peer per-method bucket that
refills continuously over its quota period. A request that does not fit is
refused (the RPC error path — the reference responds with RateLimited);
sustained abuse is reported to the peer manager's score ledger by the
transport, which bans the flooder while honest peers stay unaffected.

Quotas mirror the reference's defaults in spirit: bulk data methods
(blocks/blobs/columns by range) get token counts proportional to the batch
sizes the sync pipeline legitimately requests; cheap control methods get
small steady allowances.
"""

from __future__ import annotations

import threading
import time


class Quota:
    """max_tokens per period_seconds; a request of size n spends n tokens."""

    __slots__ = ("max_tokens", "period")

    def __init__(self, max_tokens: float, period: float):
        self.max_tokens = float(max_tokens)
        self.period = float(period)


# method -> quota (rate_limiter.rs RPCRateLimiterBuilder defaults, adapted
# to this transport's method names)
DEFAULT_QUOTAS: dict[str, Quota] = {
    "status": Quota(5, 15.0),
    "ping": Quota(2, 10.0),
    "metadata": Quota(2, 5.0),
    "goodbye": Quota(1, 10.0),
    "blocks_by_range": Quota(1024, 10.0),   # tokens = blocks requested
    "blocks_by_root": Quota(128, 10.0),     # tokens = roots requested
    "blob_sidecars_by_range": Quota(768, 10.0),
    "blob_sidecars_by_root": Quota(128, 10.0),
    "data_column_sidecars_by_range": Quota(2048, 10.0),
    "data_column_sidecars_by_root": Quota(256, 10.0),
    "light_client_bootstrap": Quota(1, 10.0),
}
_DEFAULT = Quota(64, 10.0)  # unlisted methods


class _Bucket:
    __slots__ = ("tokens", "last")

    def __init__(self, tokens: float, last: float):
        self.tokens = tokens
        self.last = last


class RateLimiter:
    def __init__(self, quotas: dict[str, Quota] | None = None,
                 clock=time.monotonic):
        self.quotas = dict(DEFAULT_QUOTAS if quotas is None else quotas)
        self._buckets: dict[tuple[str, str], _Bucket] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._last_prune = clock()

    def allow(self, peer: str, method: str, tokens: float = 1.0) -> bool:
        """Spend ``tokens`` from (peer, method)'s bucket; False = refused.
        Oversized single requests (tokens > quota) are always refused."""
        quota = self.quotas.get(method, _DEFAULT)
        if tokens > quota.max_tokens:
            return False
        now = self._clock()
        rate = quota.max_tokens / quota.period
        with self._lock:
            b = self._buckets.get((peer, method))
            if b is None:
                b = self._buckets[(peer, method)] = _Bucket(
                    quota.max_tokens, now
                )
            b.tokens = min(
                quota.max_tokens, b.tokens + (now - b.last) * rate
            )
            b.last = now
            if b.tokens >= tokens:
                b.tokens -= tokens
                return True
            return False

    def prune(self, max_age: float = 60.0) -> None:
        """Drop idle buckets (the reference prunes by quota period)."""
        cutoff = self._clock() - max_age
        with self._lock:
            for key in [k for k, b in self._buckets.items()
                        if b.last < cutoff]:
                del self._buckets[key]

    def maybe_prune(self, max_age: float = 60.0) -> bool:
        """Time-gated :meth:`prune` — cheap enough for the transport's
        serve loop to call per request; actually prunes at most once per
        ``max_age``. Without this the per-(peer, method) bucket map grows
        without bound over long DHT walks. Returns True iff it pruned."""
        now = self._clock()
        with self._lock:
            if now - self._last_prune < max_age:
                return False
            self._last_prune = now
        self.prune(max_age)
        return True

    def wait_time(self, peer: str, method: str, tokens: float = 1.0) -> float:
        """Seconds until ``tokens`` would be available for (peer, method)
        — 0.0 if a request would be admitted now, ``inf`` if ``tokens``
        exceeds the quota outright. Does NOT spend tokens: the client-side
        self-limiter uses this to pace itself below a peer's refill rate."""
        quota = self.quotas.get(method, _DEFAULT)
        if tokens > quota.max_tokens:
            return float("inf")
        now = self._clock()
        rate = quota.max_tokens / quota.period
        with self._lock:
            b = self._buckets.get((peer, method))
            if b is None:
                return 0.0
            have = min(quota.max_tokens, b.tokens + (now - b.last) * rate)
        if have >= tokens:
            return 0.0
        return (tokens - have) / rate


def request_cost(method: str, payload) -> float:
    """Token cost of a request: bulk methods cost what they ask for."""
    if method.endswith("_by_range"):
        # codec payloads are (start, count) tuples; object/dict forms carry
        # a count attribute/key
        count = None
        if isinstance(payload, tuple) and len(payload) >= 2:
            count = payload[1]
        elif isinstance(payload, dict):
            count = payload.get("count")
        else:
            count = getattr(payload, "count", None)
        return float(max(int(count or 1), 1))
    if method.endswith("_by_root"):
        try:
            return float(max(len(payload), 1))
        except TypeError:
            return 1.0
    return 1.0
