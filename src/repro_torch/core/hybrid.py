"""Hybrid layered × chunked prefill — the paper's §4.3 generalization.

The two axes are orthogonal: split the prompt into large chunks (large
enough that per-expert batch clears the accelerator's ridge point, making
MoE compute-bound) AND spread each chunk across layer groups to stay within
the per-iteration stall-free budget. Work per iteration is one
(chunk × group) rectangle.

With chunk_size >= prompt length this degenerates to pure layered prefill;
with group count 1 it degenerates to chunked prefill — both covered by the
property tests. The default chunk_size = quantum * n_blocks is the largest
chunk whose per-group work still matches a 512-token chunked iteration.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from repro_torch.core import layer_groups
from repro_torch.core.base import Scheduler, register
from repro_torch.core.plan import IterationPlan, PrefillSlice


@register
class HybridPrefillScheduler(Scheduler):
    name = "hybrid"

    def __init__(self, n_blocks: int, *, chunk_size: Optional[int] = None,
                 **kw):
        super().__init__(n_blocks, **kw)
        self.chunk_size = chunk_size or self.quantum * n_blocks
        # (req id, chunk boundaries, chunk idx, group boundaries, group idx)
        self._run: Optional[Tuple[int, List[Tuple[int, int]], int,
                                  List[Tuple[int, int]], int]] = None

    def max_stash_tokens(self, req, prompt_len=None) -> int:
        # hybrid stashes one chunk's boundary activations at a time
        return min(self.chunk_size,
                   req.prompt_len if prompt_len is None else prompt_len)

    def _on_preempt(self, req_id: int) -> None:
        if self._run is not None and self._run[0] == req_id:
            self._run = None

    def _chunks(self, prompt_len: int, start: int = 0) -> List[Tuple[int, int]]:
        n = max(1, math.ceil((prompt_len - start) / self.chunk_size))
        out = []
        for i in range(n):
            end = min(start + self.chunk_size, prompt_len)
            out.append((start, end))
            start = end
        return out

    def _start_run(self, now: float) -> None:
        admitted = self.admit(now, limit=1)
        if not admitted:
            return
        rid = admitted[0]
        r = self.requests[rid]
        # chunking starts past the prefix-cached boundary (tokens_done set by
        # admit on a cache hit) — cached tokens are never prefilled
        chunks = self._chunks(r.prompt_len, start=r.tokens_done)
        g = layer_groups.num_groups(chunks[0][1] - chunks[0][0],
                                    self.n_blocks, self.quantum)
        groups = layer_groups.partition(self.n_blocks, g)
        self._run = (rid, chunks, 0, groups, 0)

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        plan.decode_ids = self.decode_ids()

        if self._run is None:
            self._start_run(now)
            if self._run is not None:
                plan.admitted_ids = [self._run[0]]

        if self._run is not None:
            rid, chunks, ci, groups, gi = self._run
            r = self.requests[rid]
            t0, t1 = chunks[ci]
            b0, b1 = groups[gi]
            last_group = gi == len(groups) - 1
            last_chunk = ci == len(chunks) - 1
            plan.prefill.append(PrefillSlice(
                req_id=rid, token_start=t0, token_end=t1,
                block_start=b0, block_end=b1,
                emits_first_token=last_group and last_chunk))
            if last_group:
                r.tokens_done = t1
                if last_chunk:
                    self._run = None
                else:
                    nxt = chunks[ci + 1]
                    g = layer_groups.num_groups(nxt[1] - nxt[0],
                                                self.n_blocks, self.quantum)
                    self._run = (rid, chunks, ci + 1,
                                 layer_groups.partition(self.n_blocks, g), 0)
            else:
                self._run = (rid, chunks, ci, groups, gi + 1)

        self._finish_decode_bookkeeping(plan)
        return plan


# ensure registry side-effects when importing repro_torch.core
from repro_torch.core import chunked as _chunked          # noqa: E402,F401
from repro_torch.core import continuous as _continuous    # noqa: E402,F401
from repro_torch.core import layered as _layered          # noqa: E402,F401
from repro_torch.core import static_batch as _static      # noqa: E402,F401
