"""The arithmetic of a measured window, from the token events and the
requests' own timestamps (all on the window's clock, seconds from its
start).  Copied from the port's ``serving/metrics.py`` and extended: a
request that has no first token when the window ends counts with its wait
so far, and gaps are taken only between two tokens that both fall in the
window."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    pos = min(max(q, 0.0), 100.0) / 100.0 * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def ttfts(arrivals: Dict[int, float], first: Dict[int, float],
          end: float) -> List[float]:
    """Time to first token of every request that arrived (as scheduled)
    in the window: from its scheduled arrival to its first token, or to
    ``end`` where it has none yet."""
    return [min(first.get(rid, end), end) - t
            for rid, t in arrivals.items() if t <= end]


def gaps(events: Iterable[Tuple[int, float]], end: float) -> List[float]:
    """Every gap between consecutive tokens of one request, where both
    tokens fall in the window [0, end]; ``events`` is (request, time) in
    emission order."""
    last: Dict[int, float] = {}
    out: List[float] = []
    for rid, t in events:
        if not 0.0 <= t <= end:
            continue
        if rid in last:
            out.append(t - last[rid])
        last[rid] = t
    return out


def tokens_per_s(events: Iterable[Tuple[int, float]], end: float) -> float:
    """Output tokens emitted in the window per second of it."""
    return sum(1 for _, t in events if 0.0 <= t <= end) / end


def queue_waits(arrivals: Dict[int, float], admitted: Dict[int, float],
                end: float) -> List[float]:
    """Time from scheduled arrival to admission of every request that
    arrived in the window (to ``end`` where it was not admitted)."""
    return [min(admitted.get(rid, end), end) - t
            for rid, t in arrivals.items() if t <= end]


def first_times(events: Iterable[Tuple[int, float]]) -> Dict[int, float]:
    out: Dict[int, float] = {}
    for rid, t in events:
        out.setdefault(rid, t)
    return out


def lateness(arrivals: Dict[int, float],
             boundaries: Sequence[float]) -> List[float]:
    """How late each arrival was injected: the runtime injects at the
    first iteration boundary at or past its scheduled time (boundaries
    sorted; arrivals past the last boundary are left out)."""
    import bisect
    out = []
    for t in arrivals.values():
        i = bisect.bisect_left(boundaries, t)
        if i < len(boundaries):
            out.append(boundaries[i] - t)
    return out


def end_to_end(arrivals: Dict[int, float],
               events: List[Tuple[int, float]], end: float
               ) -> Dict[str, Optional[float]]:
    """The cell's end-to-end readings of one window (ms, tokens/s)."""
    first = first_times(events)
    tt = ttfts(arrivals, first, end)
    gp = gaps(events, end)
    return {"ttft_p50_ms": percentile(tt, 50) * 1e3 if tt else None,
            "tbt_p95_ms": percentile(gp, 95) * 1e3 if gp else None,
            "output_tokens_per_s": tokens_per_s(events, end),
            "n_ttft": len(tt), "n_first_tokens": sum(
                1 for rid in arrivals if rid in first and first[rid] <= end),
            "n_gaps": len(gp)}
