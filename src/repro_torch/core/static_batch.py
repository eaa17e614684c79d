"""FasterTransformer-style static batching — baseline.

Requests are processed in fixed batches from start to finish: a batch is
admitted only when the previous one fully drains. Stall-free within a batch
(decode-only iterations) but TTFT for queued requests includes the whole
residency time of the batch ahead of them."""

from __future__ import annotations

from repro_torch.core.base import Scheduler, register
from repro_torch.core.plan import IterationPlan, PrefillSlice


@register
class StaticBatchScheduler(Scheduler):
    name = "static"

    def __init__(self, n_blocks: int, *, batch_size: int = 8, **kw):
        super().__init__(n_blocks, **kw)
        self.batch_size = min(batch_size, self.n_slots)

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        if self.n_active == 0 and self.waiting:
            plan.admitted_ids = self.admit(now, limit=self.batch_size)
            for rid in plan.admitted_ids:
                r = self.requests[rid]
                plan.prefill.append(PrefillSlice(
                    req_id=rid, token_start=r.tokens_done,
                    token_end=r.prompt_len,
                    block_start=0, block_end=self.n_blocks,
                    emits_first_token=True))
                r.tokens_done = r.prompt_len
        else:
            plan.decode_ids = self.decode_ids()
        self._finish_decode_bookkeeping(plan)
        return plan
