"""The serving engine of the port: executes IterationPlans from the layered
or chunked scheduler against a REAL torch model.

Execution model per iteration (the JAX engine's, main path only):

  1. admissions — allocate a KV slot row.
  2. prefill slices — each slice is a (token-range x block-range)
     rectangle.  All slices of a plan sharing (block_start, block_end,
     emits_first_token) run as ONE packed batch over a slot vector; token
     ranges pad to power-of-two buckets with a validity mask.  Boundary
     activations between layer groups are stashed on the engine (layered
     prefill's carry state).  The final slice computes the request's
     FIRST token.
  3. decode — ONE fixed-shape step over the whole slot pool; non-decoding
     slots are masked (their KV writes are dropped).

Expert-load accounting (paper §5.4): each forward returns per-block expert
activation counts from the real router; per (iteration, block) the engine
takes the union of experts activated by decode and by every prefill slice
touching that block and accumulates ``nnz(union) * bytes_per_expert``.

Hot-path contract:

  * The KV pool is preallocated once; prefill and decode update it IN
    PLACE (``index_copy_`` of the packed rows' slot vector, ``index_put_``
    of the decode step's tokens) — the stand-in for the JAX engine's
    donated buffers.
  * ONE host sync per iteration: launches return device tensors, and a
    single ``.cpu()`` of the flattened tokens and expert masks fetches
    everything the host bookkeeping needs.  Host-to-device index copies go
    through pinned memory without blocking.
  * PyTorch runs eagerly: there is no executable cache.

Only the main path is ported: recompute preemption; ``prefix_cache`` is
off by default and ``True`` raises, as do ``preemption_mode`` other than
"recompute", ``spec_mode`` other than "off", ``moe_dispatch`` other than
"ragged" and encoder inputs (``enc_frames``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.base import Scheduler, make_scheduler
from repro_torch.core.plan import (IterationPlan, PrefillSlice, Request,
                                   RequestState, SubmitSpec)
from repro_torch.device import to_device
from repro_torch.kernels.ops import gather_slot_rows, scatter_slot_rows
from repro_torch.models.config import dtype_bytes
from repro_torch.models.model import DecoderModel
from repro_torch.serving.kvcache import PagedKVAllocator
from repro_torch.serving.runtime import (EngineExecutor, RunResult,
                                         ServingRuntime, TokenEvent,
                                         timestamp_events)

Tensor = torch.Tensor


def _bucket(n: int, minimum: int = 16, cap: Optional[int] = None) -> int:
    """Next power-of-two padding bucket >= n, clamped to ``cap``."""
    b = minimum
    while b < n:
        b *= 2
    if cap is not None:
        b = min(b, max(cap, n))
    return b


class Engine:
    def __init__(self, model: DecoderModel, params, scheduler, *,
                 n_slots: int = 8, max_len: int = 512,
                 pages: Optional[int] = None, page_size: int = 16,
                 preemption_mode: str = "recompute",
                 decode_reserve: Optional[int] = None,
                 eos_token: Optional[int] = None,
                 moe_dispatch: str = "ragged",
                 prefix_cache: bool = False, spec_mode: str = "off"):
        """``pages``/``page_size`` size the paged KV pool shared with the
        scheduler (default: enough pages to fill every slot row); memory
        pressure evicts by recompute.  ``prefix_cache`` defaults to False
        here (the JAX engine defaults to True): prefix caching, swap
        preemption, speculative decode and the dense MoE dispatch are not
        ported yet and raise."""
        if prefix_cache:
            raise NotImplementedError("prefix caching is not ported yet")
        if preemption_mode != "recompute":
            raise NotImplementedError(
                f"preemption_mode={preemption_mode!r}: only recompute is ported")
        if spec_mode != "off":
            raise NotImplementedError("speculative decode is not ported yet")
        if moe_dispatch != "ragged":
            raise NotImplementedError(
                f"moe_dispatch={moe_dispatch!r}: only ragged is ported")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.params = params
        self.moe_dispatch = moe_dispatch
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler, model.n_blocks,
                                       n_slots=n_slots)
        assert scheduler.n_slots <= n_slots, "scheduler must fit slot pool"
        self.scheduler: Scheduler = scheduler
        stash_factor = self.cfg.stash_token_factor()
        if pages is None:
            reserve = page_size if decode_reserve is None else decode_reserve
            per_slot = (-(-(max_len + reserve) // page_size)
                        + -(-int(max_len * stash_factor + 1) // page_size))
            pages = n_slots * per_slot
        self.alloc = PagedKVAllocator(pages, page_size,
                                      stash_factor=stash_factor,
                                      n_host_pages=0, prefix_caching=False)
        self.scheduler.attach_kv(self.alloc, decode_reserve=decode_reserve,
                                 mode="recompute")
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_token = eos_token

        # physical slot rows (the contiguous per-request realization of the
        # allocator's logical block tables)
        self._free_slots = list(range(n_slots))[::-1]
        self._slot_of: Dict[int, int] = {}
        self.cache = model.init_cache(n_slots, max_len)
        self.offsets = np.zeros(n_slots, np.int32)       # true filled length
        self.last_tok = np.zeros(n_slots, np.int32)

        self._next_id = 0
        self.requests: Dict[int, Request] = {}
        self.prompts: Dict[int, np.ndarray] = {}
        self.outputs: Dict[int, List[int]] = {}
        # req -> (packed boundary batch, row index, token count): cohort
        # members share ONE (B, P, d) batch tensor
        self.stash: Dict[int, Tuple[Tensor, int, int]] = {}

        # metrics
        self.iteration = 0
        self._step_events: List[TokenEvent] = []
        self.n_preempted = 0
        self.expert_load_bytes = 0
        self.iter_log: List[dict] = []
        self._expert_bytes = self.cfg.expert_bytes(
            dtype_bytes(self.cfg.param_dtype))
        # engine-level launches (embed / prefill batch / decode / stash
        # regather) and packed prefill batches
        self.n_dispatches = 0
        self.n_prefill_dispatches = 0

    # ------------------------------------------------------------------ API

    def submit_spec(self, spec: SubmitSpec) -> Request:
        """The ingestion door: every submission path lands here with one
        ``SubmitSpec``.  A spec without ``arrival_time`` is stamped at the
        engine's current iteration."""
        if spec.prompt_tokens is None:
            raise ValueError("engine submission needs real token ids — build "
                             "the SubmitSpec with prompt_tokens")
        if spec.enc_frames is not None:
            raise NotImplementedError("encoder inputs are not ported")
        rid = self._next_id
        self._next_id += 1
        prompt = np.asarray(spec.prompt_tokens, np.int32)
        if len(prompt) + spec.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {rid}: prompt {len(prompt)} + max_new "
                f"{spec.max_new_tokens} exceeds max_len {self.max_len}")
        req = Request.from_spec(
            spec, rid,
            arrival_time=float(self.iteration)
            if spec.arrival_time is None else spec.arrival_time,
            prompt_tokens=prompt)
        self.requests[rid] = req
        self.prompts[rid] = prompt
        self.outputs[rid] = []
        self.scheduler.submit(req)
        return req

    def submit(self, prompt_tokens, max_new_tokens: int) -> int:
        """Positional convenience wrapper over ``submit_spec``; returns the
        request id."""
        return self.submit_spec(SubmitSpec(
            max_new_tokens=max_new_tokens, prompt_tokens=prompt_tokens)).req_id

    def run(self, max_iterations: int = 10_000) -> RunResult:
        """Closed-loop drain of everything already submitted, through the
        shared ServingRuntime loop on the iteration clock."""
        runtime = ServingRuntime(EngineExecutor(self), clock="iteration")
        return runtime.run((), max_iterations=max_iterations)

    def step(self) -> IterationPlan:
        """Plan + execute one iteration with iteration-clock timestamps
        (for tests and tools that drive iterations by hand)."""
        plan = self.scheduler.next_plan(now=float(self.iteration))
        events = self.execute_plan(plan)
        timestamp_events(self.scheduler, events, float(self.iteration))
        return plan

    # ------------------------------------------------------------- device fns

    def _h2d(self, a: np.ndarray) -> Tensor:
        return to_device(a, self.device)

    def _decode_step_impl(self, tokens: Tensor, offsets: Tensor,
                          valid_rows: Tensor):
        """tokens: (n_slots, 1).  One decode token for every slot; masked
        rows are no-ops.  Returns next tokens and the per-(block, expert)
        activation MASK."""
        logits, _, aux = self.model.forward(
            self.params, tokens, positions=offsets.long()[:, None],
            offset=offsets, cache=self.cache, valid=valid_rows[:, None],
            moe_dispatch=self.moe_dispatch)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, aux["expert_counts"] > 0

    def _prefill_impl(self, start: int, n: int, emit: bool, hidden: Tensor,
                      valid: Tensor, slots: np.ndarray, offset: Tensor,
                      length: Tensor):
        """One packed layer-group batch: hidden (B, P, d), one row per
        prefill slice; slots are host-side, offset/length (B,) on the
        device.  Padding rows (valid all-False, slot id == n_slots) are
        no-ops end to end: their KV writes are masked and their writeback
        is dropped by ``scatter_slot_rows``."""
        rows = gather_slot_rows(self.cache, slots)
        p = hidden.shape[1]
        positions = offset.long()[:, None] + torch.arange(
            p, device=self.device)[None]
        x, rows, auxes = self.model.run_blocks(
            self.params, hidden, start, n, positions=positions,
            offset=offset, cache=rows, valid=valid,
            moe_dispatch=self.moe_dispatch)
        scatter_slot_rows(self.cache, rows, slots)
        loads = torch.stack([a["expert_counts"] > 0 for a in auxes])
        if emit:
            h_last = x[torch.arange(x.shape[0], device=self.device),
                       length.long() - 1]
            tokens = torch.argmax(self.model.logits(self.params, h_last),
                                  dim=-1)
        else:
            tokens = torch.full((x.shape[0],), -1, dtype=torch.long,
                                device=self.device)
        return x, loads, tokens

    # -------------------------------------------------------------- stepping

    def execute_plan(self, plan: IterationPlan) -> List[TokenEvent]:
        """Execute one scheduler-produced plan and return the tokens it
        emitted.  Prefill groups and the decode step are LAUNCHED first
        (device tensors only), then ONE ``.cpu()`` fetches every emitted
        token and expert-activation mask, and all bookkeeping (offsets,
        EOS, token events, expert union) runs on the fetched values."""
        self._step_events = []
        dispatches0 = self.n_dispatches
        block_expert_union = np.zeros(
            (self.model.n_blocks, max(self.cfg.moe.n_experts, 1)), bool)

        for rid in plan.preempted_ids:
            self._preempt(rid)
        if plan.swapped_out_ids or plan.swapped_in_ids:
            raise NotImplementedError("swap preemption is not ported yet")
        for rid in plan.admitted_ids:
            self._admit(rid)

        groups = self._pack_slices(plan.prefill)
        launched = [self._launch_prefill_group(*g) for g in groups]
        prefill_tokens = sum(sl.n_tokens for sl in plan.prefill)

        decode_slot_req = decode_out = None
        if plan.decode_ids:
            decode_slot_req, decode_out = self._launch_decode(plan.decode_ids)

        # ---- the ONE host sync per iteration ----
        parts = [t for pair in launched for t in pair]
        if decode_out is not None:
            parts += list(decode_out)
        fetched = []
        if parts:
            flat = torch.cat([t.reshape(-1).to(torch.int32) for t in parts])
            host = flat.cpu().numpy()
            i = 0
            for t in parts:
                fetched.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
                i += t.numel()

        for gi, (start, end, emit, slices) in enumerate(groups):
            loads, toks = fetched[2 * gi], fetched[2 * gi + 1]
            block_expert_union[start:end] |= loads.astype(bool)
            for i, sl in enumerate(slices):
                self._finish_prefill_slice(sl, int(toks[i]))
        if decode_out is not None:
            next_tok, loads = fetched[-2], fetched[-1]
            block_expert_union |= loads.astype(bool)
            for slot, rid in decode_slot_req.items():
                tok = int(next_tok[slot])
                self.offsets[slot] += 1
                self.last_tok[slot] = tok
                self._record_token(rid, tok, first=False)
                self._maybe_finish(rid, tok)

        loaded = int(block_expert_union.sum()) if self.cfg.moe.enabled else 0
        self.expert_load_bytes += loaded * self._expert_bytes
        self.iter_log.append({
            "iteration": self.iteration,
            "n_decode": len(plan.decode_ids),
            "prefill_tokens": prefill_tokens,
            "expert_load_bytes": loaded * self._expert_bytes,
            "pages_in_use": self.alloc.pages_in_use(),
            "n_preempted": len(plan.preempted_ids),
            "n_dispatches": self.n_dispatches - dispatches0,
        })
        self.iteration += 1
        return self._step_events

    def release_request(self, rid: int) -> None:
        """Drop every physical resource a SHED request still holds (slot
        row, boundary stash) without touching its token buffers."""
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        self.stash.pop(rid, None)

    # -------------------------------------------------------------- helpers

    def _preempt(self, rid: int) -> None:
        """Execute a scheduler eviction: release the slot row and the
        boundary stash, and fold the tokens generated so far into the
        recompute prompt (matching the scheduler's prompt_len fold)."""
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        self.stash.pop(rid, None)
        # append only the tokens generated since the last fold
        tail = self.requests[rid].prompt_len - len(self.prompts[rid])
        if tail:
            self.prompts[rid] = np.concatenate(
                [self.prompts[rid],
                 np.asarray(self.outputs[rid][-tail:], np.int32)])
        assert len(self.prompts[rid]) == self.requests[rid].prompt_len, \
            (rid, len(self.prompts[rid]), self.requests[rid].prompt_len)
        self.n_preempted += 1

    def _admit(self, rid: int) -> None:
        slot = self._free_slots.pop()
        self._slot_of[rid] = slot
        self.offsets[slot] = 0

    def _pack_slices(self, slices: List[PrefillSlice]):
        """Group the plan's prefill slices by layer-group rectangle: every
        (block_start, block_end, emits_first_token) group runs as ONE batch
        over a slot vector (a request appears at most once per plan, so
        rows are independent)."""
        grouped: OrderedDict = OrderedDict()
        for sl in slices:
            key = (sl.block_start, sl.block_end, sl.emits_first_token)
            grouped.setdefault(key, []).append(sl)
        return [(start, end, emit, sls)
                for (start, end, emit), sls in grouped.items()]

    def _launch_prefill_group(self, start: int, end: int, emit: bool,
                              slices: List[PrefillSlice]):
        """Launch one packed layer-group batch; returns DEVICE tensors (per-
        block expert-activation mask, per-row first tokens).  Rows pad to a
        power-of-two batch bucket (padding rows carry the out-of-range slot
        id and an all-False valid mask), tokens to a power-of-two bucket."""
        b = len(slices)
        b_pad = _bucket(b, minimum=1, cap=self.n_slots)
        if start == 0:
            p = _bucket(max(sl.n_tokens for sl in slices), cap=self.max_len)
            toks = np.zeros((b_pad, p), np.int64)
            for i, sl in enumerate(slices):
                toks[i, :sl.n_tokens] = \
                    self.prompts[sl.req_id][sl.token_start:sl.token_end]
            hidden = self.model.embed(self.params, self._h2d(toks))
            self.n_dispatches += 1
        else:
            hidden = self._stash_hidden(slices, b_pad)
            p = hidden.shape[1]
        valid = np.zeros((b_pad, p), bool)
        slots = np.full(b_pad, self.n_slots, np.int64)   # OOB: writes dropped
        offs = np.zeros(b_pad, np.int32)
        lens = np.ones(b_pad, np.int32)
        for i, sl in enumerate(slices):
            valid[i, :sl.n_tokens] = True
            slots[i] = self._slot_of[sl.req_id]
            offs[i] = sl.token_start
            lens[i] = sl.n_tokens
        x, loads, tokens = self._prefill_impl(
            start, end - start, emit, hidden, self._h2d(valid), slots,
            self._h2d(offs), self._h2d(lens))
        self.n_dispatches += 1
        self.n_prefill_dispatches += 1
        if end < self.model.n_blocks:
            # the whole packed boundary activation is stashed ONCE; each
            # request holds a (batch, row) reference into it
            for i, sl in enumerate(slices):
                self.stash[sl.req_id] = (x, i, sl.n_tokens)
        else:
            for sl in slices:
                self.stash.pop(sl.req_id, None)
        return loads, tokens

    def _stash_hidden(self, slices: List[PrefillSlice], b_pad: int) -> Tensor:
        """Boundary activations for a block_start > 0 group.  A layered
        cohort whose membership is unchanged reuses the stashed packed
        batch WHOLESALE; after a mid-cohort preemption or under shape drift
        the surviving rows are regathered into a fresh batch."""
        entries = []
        for sl in slices:
            src, row, n_tok = self.stash[sl.req_id]
            assert n_tok == sl.n_tokens, "stash/token-range mismatch"
            entries.append((src, row))
        src0 = entries[0][0]
        rows = [row for _, row in entries]
        same_src = all(src is src0 for src, _ in entries)
        if same_src and rows == list(range(len(slices))) \
                and src0.shape[0] == b_pad:
            return src0
        p = max(src.shape[1] for src, _ in entries)
        if same_src:
            h = src0.index_select(0, self._h2d(np.asarray(rows, np.int64)))
        else:
            h = torch.stack([F.pad(src[row], (0, 0, 0, p - src.shape[1]))
                             for src, row in entries])
        h = F.pad(h, (0, 0, 0, p - h.shape[1], 0, b_pad - h.shape[0]))
        self.n_dispatches += 1
        return h

    def _finish_prefill_slice(self, sl: PrefillSlice, tok: int) -> None:
        """Host bookkeeping for one executed slice (post-fetch): offsets,
        the emitted first token and EOS."""
        rid = sl.req_id
        slot = self._slot_of[rid]
        req = self.requests[rid]
        if sl.block_end == self.model.n_blocks:
            self.offsets[slot] = sl.token_end
        if sl.emits_first_token:
            self._record_token(rid, tok, first=True)
            self.offsets[slot] = req.prompt_len
            self.last_tok[slot] = tok
            # EOS can end a request on its very first token
            self._maybe_finish(rid, tok)

    def _launch_decode(self, decode_ids: List[int]):
        """Launch the full-pool decode step; returns the slot -> request map
        and DEVICE tensors (next tokens, expert-activation mask).  Slots
        mid-prefill carry stale offsets — harmless, their rows are
        valid-masked no-ops."""
        tokens = np.zeros((self.n_slots, 1), np.int64)
        valid = np.zeros(self.n_slots, bool)
        slot_req = {}
        for rid in decode_ids:
            slot = self._slot_of[rid]
            tokens[slot, 0] = self.last_tok[slot]
            valid[slot] = True
            slot_req[slot] = rid
        out = self._decode_step_impl(self._h2d(tokens),
                                     self._h2d(self.offsets),
                                     self._h2d(valid))
        self.n_dispatches += 1
        return slot_req, out

    def _record_token(self, rid: int, tok: int, *, first: bool) -> None:
        """Append the token to the request's output and report it as an
        event (timestamps are the ServingRuntime's job)."""
        self.outputs[rid].append(tok)
        self._step_events.append(TokenEvent(rid, tok, first=first))

    def _maybe_finish(self, rid: int, tok: int) -> None:
        req = self.requests[rid]
        eos = self.eos_token is not None and tok == self.eos_token
        if eos and req.state != RequestState.DONE:
            self.scheduler.finish(rid)
        if req.state == RequestState.DONE:
            slot = self._slot_of.pop(rid)
            self._free_slots.append(slot)
            if self.alloc.owns(rid):        # EOS path frees via scheduler
                self.alloc.free(rid)
            self.stash.pop(rid, None)
