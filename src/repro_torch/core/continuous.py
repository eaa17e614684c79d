"""Orca-style continuous batching (OSDI'22) — baseline.

Iteration-level scheduling: newly admitted requests run their FULL prefill
(all tokens × all blocks) in one iteration, co-scheduled with decode. No
stall-free guarantee: a long prefill inflates that iteration's duration and
every concurrent decode's TBT — the failure mode chunked/layered prefill
were designed to fix."""

from __future__ import annotations

from repro_torch.core.base import Scheduler, register
from repro_torch.core.plan import IterationPlan, PrefillSlice


@register
class ContinuousBatchingScheduler(Scheduler):
    name = "continuous"

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        plan.decode_ids = self.decode_ids()
        plan.admitted_ids = self.admit(now)
        for rid in plan.admitted_ids:
            r = self.requests[rid]
            plan.prefill.append(PrefillSlice(
                req_id=rid, token_start=r.tokens_done,
                token_end=r.prompt_len,
                block_start=0, block_end=self.n_blocks,
                emits_first_token=True))
            r.tokens_done = r.prompt_len
        self._finish_decode_bookkeeping(plan)
        return plan
