"""The yardstick's peaks and the work of each kernel call, counted from
the operation's inputs, whatever implements it: K1 from the real routed
assignments and the distinct experts it reads (not the tile-padded rows),
attention from the valid query and key counts (not the cache's max_len).

Peaks: one NVIDIA H100 SXM (data sheet, dense, no sparsity): 989 TFLOP/s
in bf16, 3.35 TB/s of HBM.  A call's bound is the larger of its
operations over the first and its bytes over the second; each input byte
is counted read once and each output byte written once.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12       # HBM3, H100 SXM
ELT = 2                    # bf16


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1(assignments: int, experts: int, d: int, f: int
       ) -> Tuple[float, float]:
    """The ragged grouped SwiGLU over ``assignments`` routed (token,
    expert) pairs that use ``experts`` distinct experts of width d -> f:
    (flops, bytes).  Gate and up (2 d f each) and down (2 f d) per
    assignment; each used expert's three matrices read once, each
    assignment's row read once and its output row written once."""
    flops = 6.0 * assignments * d * f
    nbytes = ELT * (3.0 * experts * d * f + 2.0 * assignments * d)
    return flops, nbytes


def attention(rows: Iterable[Tuple[int, int]], h: int, hkv: int, dk: int,
              dv: int) -> Tuple[float, float]:
    """Causal attention of ``n`` new queries at offset ``o`` for each
    (o, n) of ``rows``, over the o + n keys of its row: query i sees
    o + i + 1 keys.  (flops, bytes): QK and PV, 2 (dk + dv) a head and a
    visible key; the queries, the row's keys and values and the outputs
    once.  Decode is the case n = 1."""
    flops = nbytes = 0.0
    for o, n in rows:
        if n <= 0:
            continue
        keys = n * o + n * (n + 1) // 2
        flops += 2.0 * h * (dk + dv) * keys
        nbytes += ELT * (n * h * dk + (o + n) * hkv * (dk + dv)
                         + n * h * dv)
    return flops, nbytes
