"""Layer-group partitioning — §4.4 of the paper.

``num_groups`` implements G(L) = max(1, ceil(L / work_quantum)) with the
paper's work_quantum = 512 ("an arbitrary value... chosen to match chunked
prefill with chunk size 512"), capped at the number of blocks. ``partition``
splits the stack into G contiguous groups whose sizes differ by at most one
(the paper's future-work case of L % G != 0 is handled here)."""

from __future__ import annotations

import math
from typing import List, Tuple

DEFAULT_QUANTUM = 512


def num_groups(prompt_len: int, n_blocks: int,
               quantum: int = DEFAULT_QUANTUM) -> int:
    g = max(1, math.ceil(prompt_len / quantum))
    return min(g, n_blocks)


def partition(n_blocks: int, g: int) -> List[Tuple[int, int]]:
    """G contiguous (start, end) groups covering [0, n_blocks), balanced to
    within one block."""
    assert 1 <= g <= n_blocks, (g, n_blocks)
    base, rem = divmod(n_blocks, g)
    groups = []
    start = 0
    for i in range(g):
        size = base + (1 if i < rem else 0)
        groups.append((start, start + size))
        start += size
    assert start == n_blocks
    return groups

def partition_weighted(costs, g: int):
    """Adaptive layer grouping (the paper's §7 future work): split the
    stack into g contiguous groups balancing per-group COST rather than
    block count. ``costs`` is one non-negative weight per block — the
    scheduler uses per-block prefill weight-bytes from the cost model, so
    heterogeneous stacks (RecurrentGemma's 2:1 RG-LRU:attention pattern,
    DeepSeek's dense block 0, MoE-vs-dense depth profiles) get groups with
    near-equal per-iteration work, tightening the TBT envelope that the
    one-group-per-iteration rule produces.

    Greedy prefix-quantile split with a contiguity constraint; exact
    balance is NP-ish, but prefix splitting is optimal-in-class for the
    contiguous-group requirement and is what pipeline-parallel stage
    balancing uses."""
    n = len(costs)
    assert 1 <= g <= n, (g, n)
    total = float(sum(costs)) or 1.0
    bounds = [0]
    acc = 0.0
    target_idx = 1
    for i, c in enumerate(costs):
        acc += float(c)
        # close the current group once its share reaches the target
        # quantile, leaving at least one block per remaining group
        while (target_idx < g and acc >= total * target_idx / g
               and i + 1 - bounds[-1] >= 1
               and n - (i + 1) >= g - target_idx):
            bounds.append(i + 1)
            target_idx += 1
    while len(bounds) < g:
        bounds.append(n - (g - len(bounds)))
    bounds.append(n)
    groups = [(bounds[i], bounds[i + 1]) for i in range(g)]
    assert groups[0][0] == 0 and groups[-1][1] == n
    assert all(b > a for a, b in groups)
    return groups
