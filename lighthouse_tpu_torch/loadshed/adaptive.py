"""Adaptive client-side pacing: RTT-derived timeouts, jittered backoff,
and self-limiting against a peer's published rate quotas.

Three policies, all host-side and allocation-free on the hot path:

* ``RttEstimator`` — Jacobson/Karels RTO (RFC 6298): per-peer smoothed RTT
  + variance derive the Req/Resp timeout instead of a fixed 10 s, with
  exponential backoff on timeout until a fresh sample lands.
* ``BackoffPolicy`` — jittered exponential backoff with a per-peer
  cooldown, for sync's peer-rotation retry loop: a failing peer is not
  re-asked until its cooldown expires, and consecutive failures grow it.
* ``SelfLimiter`` — a client-side shadow of the peer's token buckets
  (``rate_limiter.DEFAULT_QUOTAS`` scaled by a safety margin): an honest
  node paces itself below the peer's refill rate so it NEVER trips the
  remote limiter and never takes the -20 score hit.

Jitter is seeded from ``LIGHTHOUSE_RESILIENCE_SEED`` (the same knob that
pins the resilience retry jitter) so chaos runs stay deterministic.
"""

from __future__ import annotations

import os
import random
import threading
import time

# NOTE: ..network.rate_limiter is imported lazily inside SelfLimiter.
# A module-level import would execute network/__init__ (which imports
# socket_transport, which imports this module) whenever loadshed loads
# before the network package — a hard import cycle.


class RttEstimator:
    """Per-peer adaptive Req/Resp timeout (RFC 6298 shape).

    Not internally locked: the owning transport serializes access under its
    own lock (never while blocking on the wire).
    """

    def __init__(self, min_timeout: float = 0.25, max_timeout: float = 10.0,
                 k: float = 4.0, alpha: float = 0.125, beta: float = 0.25):
        self.min_timeout = float(min_timeout)
        self.max_timeout = float(max_timeout)
        self.k = float(k)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.srtt: float | None = None
        self.rttvar: float = 0.0
        self.samples = 0
        self._backoff = 1.0

    def observe(self, rtt: float) -> None:
        rtt = max(float(rtt), 1e-6)
        if self.srtt is None:
            self.srtt = rtt
            self.rttvar = rtt / 2.0
        else:
            self.rttvar = (
                (1.0 - self.beta) * self.rttvar
                + self.beta * abs(self.srtt - rtt)
            )
            self.srtt = (1.0 - self.alpha) * self.srtt + self.alpha * rtt
        self.samples += 1
        self._backoff = 1.0  # a fresh sample resets timeout inflation

    def on_timeout(self) -> None:
        """Exponentially inflate until a successful sample arrives."""
        self._backoff = min(self._backoff * 2.0, 16.0)

    def timeout(self) -> float:
        """Current request timeout: srtt + k*rttvar, inflated by timeout
        backoff, clamped to [min_timeout, max_timeout]. With no samples yet
        the ceiling applies (the conservative legacy behaviour)."""
        if self.srtt is None:
            return self.max_timeout
        rto = (self.srtt + self.k * max(self.rttvar, 1e-3)) * self._backoff
        return min(self.max_timeout, max(self.min_timeout, rto))


def _default_seed():
    s = os.environ.get("LIGHTHOUSE_RESILIENCE_SEED")
    return int(s) if s else None


class BackoffPolicy:
    """Jittered exponential backoff with per-peer cooldown.

    ``record_failure(peer)`` starts/grows the peer's cooldown; ``ready``
    gates rotation so a failing peer is skipped until it expires.
    ``attempt_delay(n)`` is the inter-attempt sleep inside one retry loop
    (0 for the first attempt).
    """

    def __init__(self, base: float = 0.2, factor: float = 2.0,
                 max_attempt_delay: float = 2.0, cooldown_cap: float = 30.0,
                 jitter: float = 0.5, seed=None, clock=time.monotonic):
        self.base = float(base)
        self.factor = float(factor)
        self.max_attempt_delay = float(max_attempt_delay)
        self.cooldown_cap = float(cooldown_cap)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = random.Random(
            seed if seed is not None else _default_seed()
        )
        self._lock = threading.Lock()
        self._fails: dict[str, int] = {}
        self._until: dict[str, float] = {}

    def _jittered(self, delay: float) -> float:
        # full-jitter lower half: uniform in [delay*(1-jitter), delay]
        with self._lock:
            u = self._rng.random()
        return delay * (1.0 - self.jitter * u)

    def record_failure(self, peer: str) -> float:
        """Grow ``peer``'s cooldown; returns the cooldown applied (s)."""
        now = self._clock()
        with self._lock:
            n = self._fails.get(peer, 0) + 1
            self._fails[peer] = n
            delay = min(self.base * self.factor ** (n - 1),
                        self.cooldown_cap)
            delay *= 1.0 - self.jitter * self._rng.random()
            self._until[peer] = now + delay
        return delay

    def record_success(self, peer: str) -> None:
        with self._lock:
            self._fails.pop(peer, None)
            self._until.pop(peer, None)

    def ready(self, peer: str) -> bool:
        now = self._clock()
        with self._lock:
            return now >= self._until.get(peer, 0.0)

    def cooldown_remaining(self, peer: str) -> float:
        now = self._clock()
        with self._lock:
            return max(0.0, self._until.get(peer, 0.0) - now)

    def failures(self, peer: str) -> int:
        with self._lock:
            return self._fails.get(peer, 0)

    def attempt_delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based) within one loop."""
        if attempt <= 0:
            return 0.0
        return self._jittered(
            min(self.base * self.factor ** (attempt - 1),
                self.max_attempt_delay)
        )

    def forget(self, peer: str) -> None:
        self.record_success(peer)


class SelfLimiter:
    """Client-side shadow of a peer's Req/Resp rate limiter.

    Before sending, ``throttle(peer, method, cost)`` spends from a local
    bucket mirroring the peer's quota scaled by ``margin`` (< 1.0 absorbs
    clock skew). It returns the seconds the caller must wait before the
    send is safe (0.0 = send now — the tokens are already spent).
    """

    def __init__(self, quotas=None, margin: float = 0.9,
                 clock=time.monotonic):
        from ..network.rate_limiter import DEFAULT_QUOTAS, Quota, RateLimiter

        src = DEFAULT_QUOTAS if quotas is None else quotas
        self.margin = float(margin)
        scaled = {
            m: Quota(max(1.0, q.max_tokens * self.margin), q.period)
            for m, q in src.items()
        }
        self._limiter = RateLimiter(quotas=scaled, clock=clock)

    def throttle(self, peer: str, method: str, cost: float = 1.0) -> float:
        if self._limiter.allow(peer, method, cost):
            return 0.0
        return self._limiter.wait_time(peer, method, cost)

    def wait_time(self, peer: str, method: str, cost: float = 1.0) -> float:
        return self._limiter.wait_time(peer, method, cost)
