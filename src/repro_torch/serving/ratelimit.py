"""Per-tenant admission rate limiting for the HTTP front-end.

Classic token bucket: a tenant's bucket holds up to ``burst`` tokens and
refills continuously at ``rate`` tokens/second; each accepted request
spends ``cost`` tokens.  An empty bucket answers with the EXACT number of
seconds until the requested cost will have refilled — the server forwards
that as the 429 ``Retry-After`` header, so well-behaved clients back off
precisely instead of hammering.

The clock is injectable (``clock=lambda: t``) so the refill law is
property-testable deterministically: over ANY acquire sequence spanning
``T`` seconds, a bucket can never grant more than ``burst + rate * T``
tokens — the conservation invariant tests/test_server.py sweeps.

Thread-safety: buckets are mutated under one lock per limiter.  The HTTP
server calls ``acquire`` from asyncio callbacks while metric scrapes read
counters from other threads; everything stays consistent without the
serving loop ever blocking on the limiter.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class TokenBucket:
    """One tenant's bucket.  Not locked — ``TenantRateLimiter`` serializes
    access; standalone use from a single thread is fine."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be positive "
                             f"(got rate={rate}, burst={burst})")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)          # start full: bursts up front
        self._t_last = clock()
        self.n_granted = 0
        self.n_rejected = 0

    def _refill(self, now: float) -> None:
        # monotonic clocks can still tie; never move backwards
        dt = max(0.0, now - self._t_last)
        self._t_last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def acquire(self, cost: float = 1.0) -> float:
        """Try to spend ``cost`` tokens NOW.  Returns 0.0 on success, else
        the seconds until the deficit will have refilled (retry-after)."""
        if cost > self.burst:
            raise ValueError(
                f"cost {cost} can never fit burst {self.burst}")
        self._refill(self._clock())
        if self._tokens >= cost:
            self._tokens -= cost
            self.n_granted += 1
            return 0.0
        self.n_rejected += 1
        return (cost - self._tokens) / self.rate

    @property
    def available(self) -> float:
        self._refill(self._clock())
        return self._tokens


class TenantRateLimiter:
    """Lazy per-tenant bucket map with one shared (rate, burst) policy.
    ``acquire(tenant)`` returns 0.0 (admitted) or retry-after seconds;
    unknown tenants get a fresh full bucket on first sight, so the limiter
    needs no tenant pre-registration."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}

    def acquire(self, tenant: str, cost: float = 1.0) -> float:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    self.rate, self.burst, self._clock)
            return bucket.acquire(cost)

    def bucket(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            return self._buckets.get(tenant)

    def counters(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant grant/reject counters for the /metrics exporter."""
        with self._lock:
            return {t: {"granted": float(b.n_granted),
                        "rejected": float(b.n_rejected)}
                    for t, b in self._buckets.items()}
