"""Chunked prefill (Sarathi-Serve, OSDI'24) — the paper's baseline.

Token-axis scheduling: each iteration forms a hybrid batch of all decode
tokens plus a prefill chunk filling the remaining token budget; the chunk
traverses ALL blocks. Short waiting requests are coalesced into one chunk.
This is the scheduler whose MoE expert-reload amplification (#chunks ×
expert loads) the paper eliminates.
"""

from __future__ import annotations

from repro_torch.core.base import Scheduler, register
from repro_torch.core.plan import IterationPlan, PrefillSlice, RequestState


@register
class ChunkedPrefillScheduler(Scheduler):
    name = "chunked"

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        plan.decode_ids = self.decode_ids()

        # Sarathi: decode tokens count against the iteration token budget.
        budget = max(self.token_budget - len(plan.decode_ids), 0)

        # serve in-flight prefills first (FCFS by admit order = req_id order),
        # then admit more while budget remains.
        while budget > 0:
            pending = [r for r in self.active
                       if r.state == RequestState.PREFILL and r.remaining_prompt > 0
                       and all(s.req_id != r.req_id for s in plan.prefill)]
            pending.sort(key=lambda r: (r.admit_time, r.req_id))
            if not pending:
                newly = self.admit(now, limit=1)
                if not newly:
                    break
                plan.admitted_ids.extend(newly)
                continue
            r = pending[0]
            take = min(budget, r.remaining_prompt)
            sl = PrefillSlice(
                req_id=r.req_id,
                token_start=r.tokens_done,
                token_end=r.tokens_done + take,
                block_start=0,
                block_end=self.n_blocks,
                emits_first_token=(r.tokens_done + take == r.prompt_len),
            )
            plan.prefill.append(sl)
            r.tokens_done += take
            budget -= take

        self._finish_decode_bookkeeping(plan)
        return plan
