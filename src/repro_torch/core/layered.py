"""Layered prefill — THE PAPER'S CONTRIBUTION (§4).

Layer-axis scheduling: the decoder stack is partitioned into G contiguous
layer groups (G = max(1, ceil(L/512)), capped at n_blocks — §4.4). Each
iteration, exactly ONE designated group runs prefill (co-scheduled with the
always-running decode batch); the other groups run decode only. A request's
prefill therefore finishes in exactly G iterations, each layer sees the
prompt exactly once, and no chunk-induced expert reloads occur.

Concurrent small arrivals admitted in the same iteration are merged into a
*cohort* that advances through the groups together (§4.4 "when multiple
small inputs arrive concurrently, we merge them into a single batch").
Cohorts are strictly serial — one-group-per-iteration is a global rule, so
a new cohort starts only after the previous finished its last group.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core import layer_groups
from repro_torch.core.base import Scheduler, register
from repro_torch.core.plan import IterationPlan, PrefillSlice


@register
class LayeredPrefillScheduler(Scheduler):
    name = "layered"

    def __init__(self, n_blocks: int, *, merge_cohort: bool = True,
                 block_costs=None, **kw):
        super().__init__(n_blocks, **kw)
        self.merge_cohort = merge_cohort
        # adaptive grouping (paper §7 future work): per-block cost weights
        # (e.g. prefill weight-bytes from the cost model) balance per-group
        # WORK instead of block count on heterogeneous stacks
        self.block_costs = list(block_costs) if block_costs is not None \
            else None
        # active cohort: (request ids, group boundaries, next group index)
        self._cohort: Optional[Tuple[List[int], List[Tuple[int, int]], int]] = None

    def max_stash_tokens(self, req, prompt_len=None) -> int:
        # layered prefill stashes the FULL prompt's boundary activations
        # between layer groups
        return req.prompt_len if prompt_len is None else prompt_len

    def _on_preempt(self, req_id: int) -> None:
        """Drop an evicted request from the in-flight cohort; the survivors
        keep advancing through the remaining groups."""
        if self._cohort is None:
            return
        rids, groups, gi = self._cohort
        if req_id not in rids:
            return
        rids = [r for r in rids if r != req_id]
        self._cohort = (rids, groups, gi) if rids else None

    def _start_cohort(self, now: float) -> None:
        limit = None if self.merge_cohort else 1
        admitted = self.admit(now, limit=limit)
        if not admitted:
            return
        # prefix-cached tokens (tokens_done > 0 straight out of admit) are
        # never prefilled, so they don't count toward the group-count budget
        total_tokens = sum(self.requests[rid].remaining_prompt
                           for rid in admitted)
        g = layer_groups.num_groups(total_tokens, self.n_blocks, self.quantum)
        if self.block_costs is not None:
            groups = layer_groups.partition_weighted(self.block_costs, g)
        else:
            groups = layer_groups.partition(self.n_blocks, g)
        self._cohort = (admitted, groups, 0)

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        plan.decode_ids = self.decode_ids()

        if self._cohort is None:
            self._start_cohort(now)
            if self._cohort is not None:
                plan.admitted_ids = list(self._cohort[0])

        if self._cohort is not None:
            rids, groups, gi = self._cohort
            b0, b1 = groups[gi]
            last = gi == len(groups) - 1
            for rid in rids:
                r = self.requests[rid]
                # start past the cached block boundary: per-layer-group KV is
                # complete for prefix-cache-hit blocks, so every group skips
                # the same leading token range uniformly
                plan.prefill.append(PrefillSlice(
                    req_id=rid, token_start=r.tokens_done,
                    token_end=r.prompt_len,
                    block_start=b0, block_end=b1, emits_first_token=last))
                if last:
                    r.tokens_done = r.prompt_len
                r.blocks_done = b1
            self._cohort = None if last else (rids, groups, gi + 1)

        self._finish_decode_bookkeeping(plan)
        return plan
