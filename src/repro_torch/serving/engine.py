"""The serving engine of the port: executes IterationPlans from any
scheduler against a REAL torch model.

Execution model per iteration (the JAX engine's, main path only):

  1. admissions — allocate a KV slot row; a prompt that hits the prefix
     cache has its slot row seeded from the cached snapshot and starts
     prefill past the cached tokens.
  2. prefill slices — each slice is a (token-range x block-range)
     rectangle.  All slices of a plan sharing (block_start, block_end,
     emits_first_token) run as ONE packed batch over a slot vector; token
     ranges pad to power-of-two buckets with a validity mask.  With
     ``packed=False`` (the per-slice reference path) every slice runs as
     its own batch of one, at its own offset.  Boundary
     activations between layer groups are stashed on the engine (layered
     prefill's carry state).  The final slice computes the request's
     FIRST token.
  3. decode — ONE fixed-shape step over the whole slot pool; non-decoding
     slots are masked (their KV writes are dropped).  With speculation on
     (``spec_mode`` "ngram" or "draft"), the scheduler's drafting rows
     instead run ONE verify window over their slot rows: [last token,
     d_1..d_k] at positions offset..offset+k through the whole stack; the
     host accepts the prefix of drafts that match the target's own argmax
     and emits it plus the target's next token.  Rows the drafter skipped
     fall back to the plain decode step.

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
    through pinned memory without blocking.  A swap victim's row is
    copied into pinned host memory with a ``non_blocking`` copy that the
    same ``.cpu()`` completes; a swap-in copies it back without blocking.
  * PyTorch runs eagerly: there is no executable cache, so the JAX
    engine's bounded LRU of prefill, verify and draft executables and its
    ``n_prefill_compiles`` / ``n_verify_compiles`` counters have no
    counterpart here.
  * Speculation adds no sync: proposals, the verify window's tokens and
    its expert masks stay device tensors until the iteration's one
    ``.cpu()``; the draft model's proposals are written into the verify
    window's token tensor on the device.  Rollback needs no code: KV
    written past the committed offset is never read (attention masks keys
    past ``offset + i``) and a later window overwrites it.

Snapshots are COPIES.  The JAX engine's row slices are immutable device
arrays; here the cache is written in place, so a view of a slot row would
see the slot's later occupants.  Swap victims and prefix-cache rows are
therefore copied, and only the positions a restore can read: a swap
victim's ``[0, offset)``, a prefix row's ``[0, deepest chain x
page_size)``.  Positions past those are masked by the offset on every
read, so restores are identical to the JAX engine's whole-row ones.

Recurrent state (the RG-LRU, mLSTM and sLSTM blocks) has no position
axis, so the copies above take a recurrent block's whole slot state: a
swap, an export and a group-granular handoff chunk (final when the
group's last token range ends at the prompt, where staging happens).
Every admission puts the slot's state back to its init values: the JAX
engine does not, and a request admitted into a used slot there starts
from the previous occupant's state (ROADMAP §3); the port follows the
model.  A recurrent stack refuses the prefix cache (a restore re-prefills
from a page boundary on top of the whole prompt's state) and speculation
(rejected drafts would stay in the state).

MoE runs dropless under either ``moe_dispatch``: "ragged" (the default)
or "dense" (the (E, C, d) capacity buffer with C = the batch's token
count).  Routing is the same under both, so are the expert-load counters.
The stateless draft model runs as the JAX engine's does, ``forward`` with
its defaults: the capacity-limited dense dispatch over the whole padded
batch, padding routed as tokens.  So an MoE draft's proposals for a row
depend on the other rows and on the padding, which fill the capacity of
the experts they route to (ROADMAP §3); a dense draft's do not.

Disaggregated serving (``EngineHandoff``, driven by ``DisaggRuntime``):
two engines over one model and one set of weights, a prefill pool and a
decode pool.  With ``handoff_staging`` on, the prefill pool copies each
layer group's KV into pinned host memory as soon as the group's last
token range completes (positions ``[0, prompt_len)`` of the group's
blocks, queued right after the group's launch); the iteration's one
``.cpu()`` completes the copies, so at export the chunks ARE the transfer.
Without staging, or after a preemption voided the chunks, the export
copies every layer's ``[0, offset)`` and syncs once.  The decode pool
scatters the chunks into a fresh slot with ``non_blocking`` copies from
pinned memory.  Only the prompt's positions move, as in a swap; the JAX
engine moves each block's whole ``max_len`` slot row, so per migration
``handoff bytes x max_len`` here equals the JAX engine's ``x prompt_len``.

Encoder-decoder stacks (whisper).  A request's ``enc_frames`` (n_frames,
d_model) go up with one non-blocking copy at admission, where ``encode``
and ``precompute_cross_kv`` (batch 1) run and every cross-attention
block's K/V are written into the slot's ``xk``/``xv``; a request without
frames gets zeros there (which the JAX engine leaves as a fresh slot has
them, or as the slot's last occupant left them).  The cross K/V have a
frame axis: every copy of a slot (swap, export, handoff chunk) moves them
whole beside the KV rows' filled positions, and a two-pool migration
carries the frames, for a re-admission on the prefill pool.  Prefix-cache
snapshots leave them out (each admission installs its own).  The prefix
chains of a request with frames are rooted at a digest of them: the JAX
engine roots every chain at the tokens alone, so a hit there reuses
decoder K/V computed under another request's audio (ROADMAP §3).  A
decoder-only stack refuses frames at submission.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.base import Scheduler, make_scheduler
from repro_torch.core.plan import (IterationPlan, PrefillSlice, Request,
                                   RequestState, SubmitSpec)
from repro_torch.device import to_device
from repro_torch.kernels.ops import (gather_slot_rows, scatter_slot_rows,
                                     tree_map)
from repro_torch.models.attention import CROSS_LEAVES
from repro_torch.models.config import dtype_bytes
from repro_torch.models.model import DecoderModel
from repro_torch.serving.kvcache import PagedKVAllocator
from repro_torch.serving.runtime import (EngineExecutor, Migration,
                                         RunResult, ServingRuntime,
                                         TokenEvent, timestamp_events)
from repro_torch.serving.spec import (NgramDrafter, accepted_prefix,
                                      build_draft_model)

Tensor = torch.Tensor


def _bucket(n: int, minimum: int = 16, cap: Optional[int] = None) -> int:
    """Next power-of-two padding bucket >= n, clamped to ``cap``."""
    b = minimum
    while b < n:
        b *= 2
    if cap is not None:
        b = min(b, max(cap, n))
    return b


def _fetch(groups):
    """ONE ``.cpu()`` for every tensor of ``groups`` (a list of tuples of
    device tensors, or None): the same structure of numpy arrays."""
    flat = [t for g in groups if g is not None for t in g]
    if not flat:
        return groups
    host = torch.cat([t.reshape(-1).to(torch.int32) for t in flat]) \
        .cpu().numpy()
    out, i = [], 0
    for g in groups:
        if g is None:
            out.append(None)
            continue
        arrays = []
        for t in g:
            arrays.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        out.append(tuple(arrays))
    return out


def _chunks_cover(chunks, n_blocks: int) -> bool:
    """True iff the staged handoff chunks tile every block [0, n_blocks)
    — the export can then be assembled without touching the device."""
    nxt = 0
    for b0, b1 in sorted((b0, b1) for b0, b1, _ in chunks):
        if b0 > nxt:
            return False
        nxt = max(nxt, b1)
    return nxt >= n_blocks


def _nbytes(tree) -> int:
    """Bytes of every tensor of a (nested list / tuple / dict) tree."""
    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def _without_cross(cache) -> list:
    """The cache's segment lists without the read-only cross K/V leaves
    (what a prefill or verify batch writes back)."""
    return [[{k: v for k, v in c.items() if k not in CROSS_LEAVES}
             for c in seg] for seg in cache]


def frames_digest(frames: np.ndarray) -> bytes:
    """The prefix-chain root of a request with encoder frames: a digest
    of their shape and values."""
    h = hashlib.blake2b(repr(frames.shape).encode(), digest_size=16)
    h.update(np.ascontiguousarray(frames, np.float32).tobytes())
    return h.digest()


def _snapshot(c: Tensor, slot: int, n: int, host: bool,
              whole: bool = False) -> Tensor:
    """A COPY of positions ``[0, n)`` of one slot row of a cache leaf
    ``(reps, n_slots, max_len, ...)`` -> ``(reps, n, ...)`` or, with
    ``whole`` (a recurrent state leaf, which has no position axis, or the
    cross K/V, whose axis holds frames), of the slot's whole leaf.  With
    ``host`` and a CUDA leaf the copy lands in
    pinned host memory without blocking: the caller's next sync completes
    it, and later writes to the slot are ordered after it on the stream."""
    src = c[:, slot] if whole else c[:, slot, :n]
    if not (host and c.is_cuda):
        return src.clone()
    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    return dst


class Engine:
    def __init__(self, model: DecoderModel, params, scheduler, *,
                 n_slots: int = 8, max_len: int = 512,
                 pages: Optional[int] = None, page_size: int = 16,
                 preemption: bool = True,
                 preemption_mode: str = "recompute",
                 host_pages: Optional[int] = None,
                 swap_in_budget: Optional[int] = None,
                 swap_cost_fn=None,
                 decode_reserve: Optional[int] = None,
                 class_headroom: Optional[Dict[str, int]] = None,
                 eos_token: Optional[int] = None,
                 moe_dispatch: str = "ragged", packed: bool = True,
                 prefix_cache: bool = True,
                 prefix_lru_pages: Optional[int] = None,
                 spec_mode: str = "off", spec_k: int = 4,
                 spec_adaptive: bool = True, spec_ngram_n: int = 3,
                 draft_model: Optional[DecoderModel] = None,
                 draft_params=None, draft_config: Optional[str] = None):
        """``pages``/``page_size`` size the paged KV pool shared with the
        scheduler (default: enough pages to fill every slot row).
        ``preemption`` enables memory-pressure eviction;
        ``preemption_mode`` picks its flavour ("recompute" | "swap" |
        "auto"): under swap, victims' cache rows are copied to pinned host
        memory and restored verbatim on swap-in (gated by
        ``swap_in_budget`` KV tokens per iteration), sized by ``host_pages``
        (default 4x the device pool).  ``swap_cost_fn`` prices swap vs
        recompute per victim for "auto".  ``class_headroom`` reserves
        admission pages per SLO class.  ``prefix_cache`` (default on, as
        in the JAX engine) content-hashes completed prompts' full KV pages;
        an admission whose prompt matches a cached chain restores the
        cached row and skips the matched tokens.  ``prefix_lru_pages`` caps
        the reclaimable cached pages kept resident.  ``moe_dispatch``
        selects the dropless MoE data path: "ragged" or "dense".
        ``packed`` enables packed layer-group execution (one batch per
        layer-group rectangle of the plan's prefill slices);
        ``packed=False`` launches every prefill slice on its own (the
        per-slice reference path: same tokens, more launches).

        ``spec_mode`` enables speculative verify-k decoding ("ngram" =
        draft-free prompt/self-lookup; "draft" = a tiny stateless draft
        model — pass ``draft_model``/``draft_params`` directly or name a
        registered config via ``draft_config``, whose smoke variant is
        built on this engine's device in this model's dtype).
        ``spec_k`` caps the per-request draft budget; ``spec_adaptive``
        lets a per-request acceptance EMA shrink the draft-model budget;
        ``spec_ngram_n`` is the n-gram drafter's longest suffix.  Greedy token streams are those of
        ``spec_mode="off"``: speculation only changes how many tokens
        each launch commits."""
        if moe_dispatch not in ("dense", "ragged"):
            raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
        mixers = sorted({sp.mixer for sp in model.specs
                         if sp.is_recurrent()})
        if mixers and prefix_cache:
            raise ValueError(
                f"{model.cfg.name}: the prefix cache restores a prompt's "
                f"rows at page boundaries, but the recurrent state of "
                f"{mixers} has no position axis to cut there: construct "
                "the engine with prefix_cache=False")
        if mixers and spec_mode != "off":
            raise ValueError(
                f"{model.cfg.name}: speculative verify writes rejected "
                f"drafts into the recurrent state of {mixers}, which has "
                "no position axis to roll back: use spec_mode='off'")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.params = params
        self.moe_dispatch = moe_dispatch
        self.packed = packed
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
        if host_pages is None:
            host_pages = 4 * pages if preemption_mode != "recompute" else 0
        self.alloc = PagedKVAllocator(pages, page_size,
                                      stash_factor=stash_factor,
                                      n_host_pages=host_pages,
                                      prefix_caching=prefix_cache,
                                      prefix_lru_pages=prefix_lru_pages)
        self.prefix_cache = prefix_cache
        # digest -> (device row snapshot, usable tokens): the physical
        # realization of the allocator's shared-prefix index; the reclaim
        # hook drops a row the moment its index entry dies
        self._prefix_rows: Dict[bytes, Tuple[object, int]] = {}
        rows = self._prefix_rows        # (not self: no engine cycle)
        self.alloc.on_prefix_evict = lambda digest: rows.pop(digest, None)
        self.scheduler.attach_kv(self.alloc, decode_reserve=decode_reserve,
                                 preemption=preemption,
                                 mode=preemption_mode,
                                 swap_in_budget=swap_in_budget,
                                 swap_cost_fn=swap_cost_fn,
                                 class_headroom=class_headroom)
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_token = eos_token

        # speculative verify-k decoding
        if spec_mode not in ("off", "ngram", "draft"):
            raise ValueError(f"unknown spec_mode {spec_mode!r}")
        self.spec_mode = spec_mode
        self.spec_k = spec_k
        self.drafter = NgramDrafter(spec_ngram_n) \
            if spec_mode == "ngram" else None
        self.draft_model: Optional[DecoderModel] = None
        self.draft_params = None
        if spec_mode == "draft":
            if draft_model is not None:
                self.draft_model, self.draft_params = draft_model, \
                    draft_params
            elif draft_config is not None:
                self.draft_model, self.draft_params = build_draft_model(
                    draft_config, self.cfg.vocab_size, device=self.device,
                    dtype=self.cfg.dtype)
            else:
                raise ValueError(
                    "spec_mode='draft' needs draft_model/draft_params or a "
                    "draft_config name")
            if self.draft_model.cfg.encoder.enabled:
                raise ValueError(
                    "the stateless draft model has no encoder output to "
                    "attend over: draft with a decoder-only model")
            if self.draft_model.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError("draft model must share the target vocab")
        if spec_mode != "off":
            self.scheduler.configure_speculation(spec_mode, spec_k,
                                                 adaptive=spec_adaptive)

        # physical slot rows (the contiguous per-request realization of the
        # allocator's logical block tables)
        self._free_slots = list(range(n_slots))[::-1]
        self._slot_of: Dict[int, int] = {}
        self.cache = model.init_cache(n_slots, max_len)
        # (segment, pattern position, one slot's state at its init
        # values) of every recurrent block: each admission copies it into
        # the slot (KV rows need no reset, the offset masks them)
        fresh = model.init_cache(1, 1)
        self._fresh_state = [
            (s, p, {k: v[:, 0] for k, v in fresh[s][p].items()})
            for s, recs in enumerate(model.recurrent)
            for p, rec in enumerate(recs) if rec]
        self.state_bytes_per_slot = sum(
            v.numel() * v.element_size()
            for _, _, state in self._fresh_state for v in state.values())
        self.offsets = np.zeros(n_slots, np.int32)       # true filled length
        self.last_tok = np.zeros(n_slots, np.int32)

        self._next_id = 0
        self.requests: Dict[int, Request] = {}
        self.prompts: Dict[int, np.ndarray] = {}
        self.outputs: Dict[int, List[int]] = {}
        # req -> (packed boundary batch, row index, token count): cohort
        # members share ONE (B, P, d) batch tensor
        self.stash: Dict[int, Tuple[Tensor, int, int]] = {}
        # encoder frames (n_frames, d_model) of the requests that have them
        self.enc_frames: Dict[int, np.ndarray] = {}
        # swapped-out requests: req -> (host row copy, offset, last_tok)
        self.host_kv: Dict[int, Tuple[object, int, int]] = {}
        # disaggregated handoff: with staging on (this engine is a prefill
        # pool), each layer group whose KV completes is copied per block
        # into pinned host memory, completed by the iteration's one
        # ``.cpu()``; at export the chunks ARE the transfer.
        # req -> [(block_start, block_end, host rows per block)]
        self.handoff_staging = False
        self._handoff_chunks: Dict[int, List[Tuple[int, int, list]]] = {}
        self.n_handoffs_out = 0
        self.n_handoffs_in = 0
        self.handoff_bytes = 0

        # metrics
        self.iteration = 0
        self._step_events: List[TokenEvent] = []
        self.n_preempted = 0
        self.n_swapped_out = 0
        self.n_swapped_in = 0
        self.expert_load_bytes = 0
        self.iter_log: List[dict] = []
        self._expert_bytes = self.cfg.expert_bytes(
            dtype_bytes(self.cfg.param_dtype))
        # engine-level launches (embed / prefill batch / decode / stash
        # regather) and packed prefill batches
        self.n_dispatches = 0
        self.n_prefill_dispatches = 0
        # prefix-cache accounting: restores = admissions that seeded their
        # slot row from a cached prefix (the allocator counts hits/tokens)
        self.n_prefix_restores = 0
        self._prefix_seen = (0, 0)          # (n_prefix_hits, n_prefix_tokens)
        # cross-K/V installs of an encoder stack: one per admission (the
        # encoder's K/V, or zeros for a request without frames)
        self.n_cross_installs = 0
        # speculative-decode accounting
        self.n_verify_dispatches = 0
        self.n_draft_dispatches = 0
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        # per-iteration record of what was ACTUALLY verified (rid -> k_eff;
        # may be smaller than plan.verify_len when a drafter found nothing)
        self.last_verify_executed: Dict[int, int] = {}

    # ------------------------------------------------------------------ API

    def submit_spec(self, spec: SubmitSpec) -> Request:
        """The ingestion door: every submission path lands here with one
        ``SubmitSpec``.  A spec without ``arrival_time`` is stamped at the
        engine's current iteration."""
        if spec.prompt_tokens is None:
            raise ValueError("engine submission needs real token ids — build "
                             "the SubmitSpec with prompt_tokens")
        frames = None
        if spec.enc_frames is not None:
            enc = self.cfg.encoder
            if not enc.enabled:
                raise ValueError(f"{self.cfg.name} has no encoder: a "
                                 "request cannot carry encoder frames")
            frames = np.asarray(spec.enc_frames, np.float32)
            if frames.shape != (enc.n_frames, self.cfg.d_model):
                raise ValueError(f"encoder frames must be (n_frames, "
                                 f"d_model) = ({enc.n_frames}, "
                                 f"{self.cfg.d_model}), got {frames.shape}")
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
        if frames is not None:
            self.enc_frames[rid] = frames
            req.prefix_root = frames_digest(frames)
        self.scheduler.submit(req)
        return req

    def submit(self, prompt_tokens, max_new_tokens: int,
               enc_frames=None, *, slo_class: str = "interactive",
               arrival_time: Optional[float] = None) -> int:
        """Positional convenience wrapper over ``submit_spec`` (the JAX
        engine's signature); returns the request id."""
        return self.submit_spec(SubmitSpec(
            max_new_tokens=max_new_tokens, prompt_tokens=prompt_tokens,
            slo_class=slo_class, arrival_time=arrival_time,
            enc_frames=enc_frames)).req_id

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
            dropless=True, moe_dispatch=self.moe_dispatch)
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
            offset=offset, cache=rows, valid=valid, dropless=True,
            moe_dispatch=self.moe_dispatch)
        scatter_slot_rows(_without_cross(self.cache), rows, slots)
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

    def _verify_impl(self, tokens: Tensor, valid: Tensor, slots: np.ndarray,
                     offset: Tensor):
        """Verify-k window for a cohort of drafting slots in ONE pass:
        ``tokens`` (B, P) holds per row [last_tok, d_1..d_k, pad...] fed at
        positions offset..offset+P-1 through the FULL stack, over the
        gathered slot rows (as ``_prefill_impl``).  Row j of the returned
        argmax grid is the target's greedy token AFTER window position j
        — the host accepts the matching draft prefix.  The window's KV is
        written in place; what lies past the offset the host commits is
        never read and is overwritten by a later window.  Padding rows
        (slot id == n_slots, valid all-False) are no-ops end to end."""
        rows = gather_slot_rows(self.cache, slots)
        positions = offset.long()[:, None] + torch.arange(
            tokens.shape[1], device=self.device)[None]
        hidden = self.model.embed(self.params, tokens, positions=positions)
        x, rows, auxes = self.model.run_blocks(
            self.params, hidden, 0, self.model.n_blocks, positions=positions,
            offset=offset, cache=rows, valid=valid, dropless=True,
            moe_dispatch=self.moe_dispatch)
        scatter_slot_rows(_without_cross(self.cache), rows, slots)
        loads = torch.stack([a["expert_counts"] > 0 for a in auxes])
        toks = torch.argmax(self.model.logits(self.params, x), dim=-1)
        return loads, toks                                    # (B, P)

    def _draft_impl(self, k: int, tokens: Tensor, lengths: Tensor) -> Tensor:
        """Greedy k-step extension by the STATELESS draft model: each step
        re-runs the draft over the (padded) full history — no draft KV
        cache exists, so preemption/fold/swap need zero draft-side
        bookkeeping.  Each step is the JAX draft's ``forward`` with its
        defaults (capacity-limited dense MoE dispatch, no padding mask),
        with logits computed only at each row's last token (the JAX engine
        takes the argmax of the same row of its full (B, P, V) logits).
        Returns the (B, k) proposals as a device tensor."""
        dm, dp = self.draft_model, self.draft_params
        b, n_pos = tokens.shape
        arange = torch.arange(n_pos, device=self.device)
        positions = arange[None].expand(b, n_pos)
        rows = torch.arange(b, device=self.device)
        toks, lens = tokens, lengths.long()
        props = []
        for _ in range(k):
            hidden = dm.embed(dp, toks, positions=positions)
            x, _, _ = dm.run_blocks(dp, hidden, 0, dm.n_blocks,
                                    positions=positions, dropless=False,
                                    moe_dispatch="dense")
            tok = torch.argmax(dm.logits(dp, x[rows, lens - 1]), dim=-1)
            toks = torch.where(arange[None] == lens[:, None], tok[:, None],
                               toks)
            lens = lens + 1
            props.append(tok)
        return torch.stack(props, dim=1)

    # -------------------------------------------------------------- stepping

    def execute_plan(self, plan: IterationPlan) -> List[TokenEvent]:
        """Execute one scheduler-produced plan and return the tokens it
        emitted.  Prefill groups, the verify window (with its draft) and
        the decode step are LAUNCHED first (device tensors only), then ONE
        ``.cpu()`` fetches every emitted token, proposal and expert-
        activation mask (and completes this iteration's swap-out copies),
        and all bookkeeping (offsets, EOS, token events, expert union,
        acceptance) runs on the fetched values.  With ``handoff_staging``
        on, the copies of every layer group that completes a prompt are
        queued right after the group's launch and completed by the same
        ``.cpu()``."""
        self._step_events = []
        dispatches0 = self.n_dispatches
        prefix_hits0, prefix_toks0 = self._prefix_seen
        block_expert_union = np.zeros(
            (self.model.n_blocks, max(self.cfg.moe.n_experts, 1)), bool)

        # memory-pressure victims first: their slot rows and stash must be
        # released before this iteration's swap-ins/admissions reuse them
        for rid in plan.preempted_ids:
            self._preempt(rid)
        for rid in plan.swapped_out_ids:
            self._swap_out(rid)
        for rid in plan.swapped_in_ids:
            self._swap_in(rid)
        for rid in plan.admitted_ids:
            self._admit(rid)

        groups = self._pack_slices(plan.prefill)
        launched = []
        for g in groups:
            launched.append(self._launch_prefill_group(*g))
            if self.handoff_staging:
                self._stage_handoff(g[3])
        prefill_tokens = sum(sl.n_tokens for sl in plan.prefill)

        # speculative verify-k: draft + verify are LAUNCHED here (device
        # tensors only); rows the drafter skipped fall through to the plain
        # decode step below
        spec_rows, spec_skipped, spec_fetch = [], [], None
        if plan.verify_len and self.spec_mode != "off":
            spec_rows, spec_skipped, spec_fetch = self._launch_verify(plan)
        spec_rids = {rid for rid, _, _, _, _ in spec_rows}

        decode_slot_req = decode_out = None
        plain_ids = [rid for rid in plan.decode_ids if rid not in spec_rids]
        if plain_ids:
            decode_slot_req, decode_out = self._launch_decode(plain_ids)

        # ---- the ONE host sync per iteration ----
        *launched, spec_fetch, decode_out = _fetch(
            launched + [spec_fetch, decode_out])

        for (start, end, emit, slices), (loads, toks) in zip(groups,
                                                             launched):
            block_expert_union[start:end] |= loads.astype(bool)
            for i, sl in enumerate(slices):
                self._finish_prefill_slice(sl, int(toks[i]))
        n_verify_tokens = n_spec_accepted = 0
        self.last_verify_executed = {}
        if spec_fetch is not None:
            loads, toks, *props = spec_fetch
            block_expert_union |= loads.astype(bool)
            n_verify_tokens, n_spec_accepted = self._finish_verify(
                spec_rows, toks, props[0] if props else None)
        if decode_out is not None:
            next_tok, loads = decode_out
            block_expert_union |= loads.astype(bool)
            for slot, rid in decode_slot_req.items():
                tok = int(next_tok[slot])
                self.offsets[slot] += 1
                self.last_tok[slot] = tok
                self._record_token(rid, tok, first=False)
                self._maybe_finish(rid, tok)
        for rid in spec_skipped:
            # a 0-proposal commit releases the scheduler's page pre-charge
            self.last_verify_executed[rid] = 0
            self.scheduler.commit_speculation(rid, proposed=0, accepted=0,
                                              extra=0)

        loaded = int(block_expert_union.sum()) if self.cfg.moe.enabled else 0
        self.expert_load_bytes += loaded * self._expert_bytes
        self.iter_log.append({
            "iteration": self.iteration,
            "n_decode": len(plan.decode_ids),
            "prefill_tokens": prefill_tokens,
            "expert_load_bytes": loaded * self._expert_bytes,
            "pages_in_use": self.alloc.pages_in_use(),
            "host_pages_in_use": self.alloc.host_pages_in_use(),
            "n_preempted": len(plan.preempted_ids),
            "n_swapped_out": len(plan.swapped_out_ids),
            "n_swapped_in": len(plan.swapped_in_ids),
            "n_dispatches": self.n_dispatches - dispatches0,
            "n_verify_tokens": n_verify_tokens,
            "n_spec_accepted": n_spec_accepted,
            "n_spec_rows": len(spec_rows),
            "n_prefix_hits": self.alloc.n_prefix_hits - prefix_hits0,
            "prefix_cached_tokens": (self.alloc.n_prefix_tokens
                                     - prefix_toks0),
        })
        self._prefix_seen = (self.alloc.n_prefix_hits,
                             self.alloc.n_prefix_tokens)
        self.iteration += 1
        return self._step_events

    # ------------------------------------------------ disaggregated handoff

    def _stage_handoff(self, slices: List[PrefillSlice]) -> None:
        """Group-granular streaming: a slice whose token range ends at the
        prompt completes its blocks' KV in this launch — queue the copies
        of those blocks' rows now, before any later write to the slot."""
        for sl in slices:
            if sl.token_end == self.requests[sl.req_id].prompt_len:
                rows = self._slice_block_rows(sl.req_id, sl.block_start,
                                              sl.block_end)
                self._handoff_chunks.setdefault(sl.req_id, []).append(
                    (sl.block_start, sl.block_end, rows))
                self.handoff_bytes += _nbytes(rows)

    def _slice_block_rows(self, rid: int, b0: int, b1: int) -> list:
        """Copies of one slot's positions ``[0, prompt_len)`` for blocks
        ``[b0, b1)``, each ``(1, prompt_len, ...)`` per leaf — the group-
        granular handoff chunk, in pinned host memory on the card (no
        host sync: the iteration's ``.cpu()`` completes it)."""
        slot = self._slot_of[rid]
        n = self.requests[rid].prompt_len
        rows = []
        for b in range(b0, b1):
            s, r, p_idx = self.model.index_map[b]
            rows.append({k: _snapshot(c[r:r + 1], slot, n, host=True,
                                      whole=self.model.whole_leaf(s, p_idx, k))
                         for k, c in self.cache[s][p_idx].items()})
        return rows

    def _scatter_block_rows(self, slot: int, b0: int, b1: int,
                            rows: list) -> None:
        """Install imported per-block chunk rows into ``slot`` (the decode-
        side half of the streaming handoff; no host sync)."""
        for b, row in zip(range(b0, b1), rows):
            s, r, p_idx = self.model.index_map[b]
            for k, x in row.items():
                c = self.cache[s][p_idx][k]
                dst = c[r:r + 1, slot] if self.model.whole_leaf(s, p_idx, k) \
                    else c[r:r + 1, slot, :x.shape[1]]
                dst.copy_(x, non_blocking=True)

    def export_request(self, rid: int) -> dict:
        """Pull a migrating request's state off this engine (the prefill
        pool): the staged KV chunks (or, when they do not tile the stack
        — staging off, or a preemption dropped them — a one-off copy of
        every layer's ``[0, offset)``), the token buffers, and the
        allocator-level page export (shared-prefix pages stay warm in THIS
        pool's LRU).  The caller has already ``pop_request``-ed the id
        from the scheduler."""
        req = self.requests.pop(rid)
        slot = self._slot_of.pop(rid)
        offset = int(self.offsets[slot])
        last = int(self.last_tok[slot])
        chunks = self._handoff_chunks.pop(rid, [])
        row = None
        if not _chunks_cover(chunks, self.model.n_blocks):
            # whole-prompt fallback: the only host sync outside the
            # per-iteration fetch (the payload is complete on the host
            # before it leaves the pool), taken exactly when streaming
            # was off
            row = self._copy_row(slot, offset, host=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            chunks = []
        self._free_slots.append(slot)
        self.stash.pop(rid, None)
        self.n_handoffs_out += 1
        return {"req": req, "prompt": self.prompts.pop(rid),
                "outputs": self.outputs.pop(rid),
                "enc_frames": self.enc_frames.pop(rid, None),
                "offset": offset, "last_tok": last,
                "chunks": chunks, "row": row,
                "kv": self.alloc.export_pages(rid)}

    def import_request(self, payload: dict):
        """Install an exported request on this engine (the decode pool):
        land its pages (warm shared chains link for free), copy the staged
        chunks — or the fallback row — into a fresh slot without blocking,
        and resume decode where the prefill pool left off.  Returns the
        allocator's ``KVImport``.  The caller adopts the request into this
        engine's scheduler AFTER this lands."""
        req = payload["req"]
        rid = req.req_id
        imp = self.alloc.import_pages(payload["kv"])
        slot = self._free_slots.pop()
        self._slot_of[rid] = slot
        if payload["row"] is not None:
            self._restore_row(slot, payload["row"])
        else:
            for b0, b1, rows in payload["chunks"]:
                self._scatter_block_rows(slot, b0, b1, rows)
        self.offsets[slot] = payload["offset"]
        self.last_tok[slot] = payload["last_tok"]
        self.requests[rid] = req
        self.prompts[rid] = payload["prompt"]
        self.outputs[rid] = payload["outputs"]
        if payload["enc_frames"] is not None:
            self.enc_frames[rid] = payload["enc_frames"]
        self.n_handoffs_in += 1
        return imp

    def release_request(self, rid: int) -> None:
        """Drop every physical resource a SHED request still holds (slot
        row, boundary stash, host copy, staged handoff chunks) without
        touching its token buffers."""
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        self.host_kv.pop(rid, None)
        self.stash.pop(rid, None)
        self._handoff_chunks.pop(rid, None)
        self.enc_frames.pop(rid, None)

    # -------------------------------------------------------------- helpers

    def _preempt(self, rid: int) -> None:
        """Execute a scheduler eviction: release the slot row and the
        boundary stash, and fold the tokens generated so far into the
        recompute prompt (matching the scheduler's prompt_len fold).  A
        demoted SWAPPED victim holds no slot: its host copy is dropped."""
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        else:
            self.host_kv.pop(rid, None)
        self.stash.pop(rid, None)
        self._handoff_chunks.pop(rid, None)   # staged KV is void post-fold
        # append only the tokens generated since the last fold
        tail = self.requests[rid].prompt_len - len(self.prompts[rid])
        if tail:
            self.prompts[rid] = np.concatenate(
                [self.prompts[rid],
                 np.asarray(self.outputs[rid][-tail:], np.int32)])
        assert len(self.prompts[rid]) == self.requests[rid].prompt_len, \
            (rid, len(self.prompts[rid]), self.requests[rid].prompt_len)
        self.n_preempted += 1

    def _copy_row(self, slot: int, n: int, host: bool = False,
                  cross: bool = True):
        """A copy of positions ``[0, n)`` of one slot row, every layer (a
        recurrent block's whole state, the whole cross K/V unless
        ``cross`` is False)."""
        whole = self.model.whole_leaf
        return [[{k: _snapshot(v, slot, n, host, whole=whole(s, p, k))
                  for k, v in c.items() if cross or k not in CROSS_LEAVES}
                 for p, c in enumerate(seg)]
                for s, seg in enumerate(self.cache)]

    def _restore_row(self, slot: int, row) -> None:
        """Write a row copy back into positions ``[0, n)`` of ``slot`` (a
        recurrent block's whole state, the whole cross K/V), from pinned
        host memory without blocking."""
        for s, (seg, seg_row) in enumerate(zip(self.cache, row)):
            for p, (c, c_row) in enumerate(zip(seg, seg_row)):
                for k, r in c_row.items():
                    dst = c[k][:, slot] if self.model.whole_leaf(s, p, k) \
                        else c[k][:, slot, :r.shape[1]]
                    dst.copy_(r, non_blocking=True)

    def _reset_state(self, slot: int) -> None:
        """Put ``slot``'s recurrent state back to its init values (device
        copies, no host sync).  A slot's last occupant leaves its final
        state behind; the JAX engine never resets it, so a request
        admitted into a used slot starts from that state.  The port
        follows the model here: every admission starts from init."""
        for s, p, state in self._fresh_state:
            for k, v in state.items():
                self.cache[s][p][k][:, slot].copy_(v, non_blocking=True)

    def _swap_out(self, rid: int) -> None:
        """Execute a swap-to-host eviction: copy the victim's filled
        positions (every layer's K/V) to pinned host memory and release
        the slot.  The copy is queued on the stream before any later write
        to the slot, and the iteration's one ``.cpu()`` completes it.  The
        scheduler already moved the allocator pages to the host pool."""
        slot = self._slot_of.pop(rid)
        assert rid not in self.stash, rid       # swap victims are DECODE
        offset = int(self.offsets[slot])
        self.host_kv[rid] = (self._copy_row(slot, offset, host=True), offset,
                             int(self.last_tok[slot]))
        self._free_slots.append(slot)
        self.n_swapped_out += 1

    def _swap_in(self, rid: int) -> None:
        """Restore the host copy into a fresh slot row and resume decode
        where the victim left off (bit-identical KV)."""
        slot = self._free_slots.pop()
        self._slot_of[rid] = slot
        row, offset, last = self.host_kv.pop(rid)
        self._restore_row(slot, row)
        self.offsets[slot] = offset
        self.last_tok[slot] = last
        self.n_swapped_in += 1

    def _admit(self, rid: int) -> None:
        slot = self._free_slots.pop()
        self._slot_of[rid] = slot
        self.offsets[slot] = 0
        self._reset_state(slot)
        hit = self.alloc.prefix_hit(rid)
        if hit.cached_tokens:
            # seed the slot row with the cached prefix KV (positions
            # 0..usable-1 of the registering request; on a COW hit the
            # tail page's extra positions are re-prefilled or masked)
            row, usable = self._prefix_rows[hit.leaf]
            assert usable >= hit.cached_tokens, (rid, usable, hit)
            self._restore_row(slot, row)
            self.offsets[slot] = hit.cached_tokens
            self.n_prefix_restores += 1
        if self.cfg.encoder.enabled:
            self._install_cross_kv(rid, slot)

    def _install_cross_kv(self, rid: int, slot: int) -> None:
        """Write ``rid``'s cross K/V into ``slot``: its frames go up with
        one non-blocking copy, then ``encode`` and ``install_cross_kv``
        at batch 1 (no host sync); a request without frames gets zeros."""
        frames = self.enc_frames.get(rid)
        if frames is None:
            for seg, (pattern, _) in zip(self.cache, self.model.segments):
                for c, sp in zip(seg, pattern):
                    if sp.cross_attn:
                        c["xk"][:, slot].zero_()
                        c["xv"][:, slot].zero_()
        else:
            enc = self.model.encode(self.params, self._h2d(frames[None]))
            self.model.install_cross_kv(self.params, self.cache, enc, slot)
        self.n_cross_installs += 1

    def _pack_slices(self, slices: List[PrefillSlice]):
        """Group the plan's prefill slices by layer-group rectangle: every
        (block_start, block_end, emits_first_token) group runs as ONE batch
        over a slot vector (a request appears at most once per plan, so
        rows are independent).  With packing disabled each slice is its
        own group of one (the per-slice reference path)."""
        if not self.packed:
            return [(sl.block_start, sl.block_end, sl.emits_first_token,
                     [sl]) for sl in slices]
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
        offs = np.zeros(b_pad, np.int32)
        for i, sl in enumerate(slices):
            offs[i] = sl.token_start
        offs_dev = self._h2d(offs)
        if start == 0:
            p = _bucket(max(sl.n_tokens for sl in slices), cap=self.max_len)
            toks = np.zeros((b_pad, p), np.int64)
            for i, sl in enumerate(slices):
                toks[i, :sl.n_tokens] = \
                    self.prompts[sl.req_id][sl.token_start:sl.token_end]
            # every row's positions, padding rows' from 0 (the JAX
            # engine's): learned positions are added at the embedding
            positions = offs_dev.long()[:, None] + torch.arange(
                p, device=self.device)[None]
            hidden = self.model.embed(self.params, self._h2d(toks),
                                      positions=positions)
            self.n_dispatches += 1
        else:
            hidden = self._stash_hidden(slices, b_pad)
            p = hidden.shape[1]
        valid = np.zeros((b_pad, p), bool)
        slots = np.full(b_pad, self.n_slots, np.int64)   # OOB: writes dropped
        lens = np.ones(b_pad, np.int32)
        for i, sl in enumerate(slices):
            valid[i, :sl.n_tokens] = True
            slots[i] = self._slot_of[sl.req_id]
            lens[i] = sl.n_tokens
        x, loads, tokens = self._prefill_impl(
            start, end - start, emit, hidden, self._h2d(valid), slots,
            offs_dev, self._h2d(lens))
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
            if self.prefix_cache:
                # snapshot BEFORE _maybe_finish can free the allocator
                # state of an instantly-done (EOS-on-first-token) request
                self._snapshot_prefix_rows(rid, slot)
            self._record_token(rid, tok, first=True)
            self.offsets[slot] = req.prompt_len
            self.last_tok[slot] = tok
            # EOS can end a request on its very first token
            self._maybe_finish(rid, tok)

    def _snapshot_prefix_rows(self, rid: int, slot: int) -> None:
        """Copy the completed prompt's KV row once and file it under every
        shared-index chain this request's own pages serve (registration
        happened scheduler-side at plan time).  Only positions up to the
        deepest new chain are copied: no restore reads past them."""
        req = self.requests[rid]
        chains = self.alloc.owned_chains(rid, req.cacheable_prompt,
                                         req.prefix_root)
        missing = [(d, depth) for d, depth in chains
                   if d not in self._prefix_rows]
        if not missing:
            return
        ps = self.alloc.page_size
        row = self._copy_row(slot, max(depth for _, depth in missing) * ps,
                             cross=False)
        for d, depth in missing:
            self._prefix_rows[d] = (row, depth * ps)

    def _history(self, rid: int) -> np.ndarray:
        """Full token sequence so far (recompute prompt + the generated
        tail not yet folded into it); its last element is last_tok and its
        length is offsets[slot] + 1."""
        req = self.requests[rid]
        tail = self.outputs[rid][req.n_folded:]
        return np.concatenate([self.prompts[rid],
                               np.asarray(tail, np.int32)])

    def _launch_verify(self, plan: IterationPlan):
        """Launch the drafting cohort's verify window (plus, in draft mode,
        the draft model's k steps that feed it); returns host row metadata
        (rid, slot, offset, k_eff, host proposals or None), the ids that
        fell back to plain decode this iteration, and the device tensors
        for the one fetch.

        Window safety: per-row KV writes cover offset..offset+P-1 (the
        BUCKETED window — ``_write_cache`` drops out-of-range token writes,
        but a window that would spill past max_len has nowhere to store
        accepted tokens, so it must not launch).  Rows where the worst-case
        bucket does not fit fall back to plain decode."""
        budgets = sorted(plan.verify_len.items())
        p_worst = _bucket(self.spec_k + 1, minimum=2, cap=self.spec_k + 1)
        rows: List[Tuple[int, int, int, int, Optional[np.ndarray]]] = []
        skipped: List[int] = []
        for rid, k in budgets:
            slot = self._slot_of[rid]
            off = int(self.offsets[slot])
            if off + p_worst > self.max_len:
                skipped.append(rid)
                continue
            if self.spec_mode == "ngram":
                prop = self.drafter.propose(self._history(rid), k)
                if len(prop) == 0:
                    skipped.append(rid)
                    continue
                rows.append((rid, slot, off, len(prop),
                             prop.astype(np.int32)))
            else:
                rows.append((rid, slot, off, k, None))
        if not rows:
            return [], skipped, None

        k_max = max(k_eff for _, _, _, k_eff, _ in rows)
        p = _bucket(k_max + 1, minimum=2, cap=self.spec_k + 1)
        b_pad = _bucket(len(rows), minimum=1, cap=self.n_slots)
        tokens = np.zeros((b_pad, p), np.int64)
        valid = np.zeros((b_pad, p), bool)
        slots = np.full(b_pad, self.n_slots, np.int64)   # OOB: writes dropped
        offs = np.zeros(b_pad, np.int32)
        for i, (rid, slot, off, k_eff, prop) in enumerate(rows):
            tokens[i, 0] = self.last_tok[slot]
            if prop is not None:
                tokens[i, 1:1 + k_eff] = prop
            valid[i, :k_eff + 1] = True
            slots[i] = slot
            offs[i] = off
        tok_dev = self._h2d(tokens)

        props_dev = None
        if self.spec_mode == "draft":
            hists = [self._history(rid) for rid, _, _, _, _ in rows]
            p_hist = _bucket(max(len(h) for h in hists) + k_max,
                             cap=self.max_len + self.spec_k)
            hist_toks = np.zeros((b_pad, p_hist), np.int64)
            hist_lens = np.ones(b_pad, np.int32)
            for i, h in enumerate(hists):
                hist_toks[i, :len(h)] = h
                hist_lens[i] = len(h)
            props_dev = self._draft_impl(k_max, self._h2d(hist_toks),
                                         self._h2d(hist_lens))
            self.n_dispatches += 1
            self.n_draft_dispatches += 1
            # the proposals go into the window on the device: no sync
            tok_dev[:, 1:1 + k_max] = props_dev

        loads, toks = self._verify_impl(tok_dev, self._h2d(valid), slots,
                                        self._h2d(offs))
        self.n_dispatches += 1
        self.n_verify_dispatches += 1
        fetch = (loads, toks) if props_dev is None else (loads, toks,
                                                         props_dev)
        return rows, skipped, fetch

    def _finish_verify(self, rows, toks, props) -> Tuple[int, int]:
        """Host bookkeeping for the fetched verify grid: accept the
        matching draft prefix, emit accepted drafts plus the target's own
        next token, advance the committed offset (the rollback — stale KV
        past it is dead), and feed acceptance back to the scheduler."""
        n_proposed = n_accepted = 0
        for i, (rid, slot, off, k_eff, prop) in enumerate(rows):
            if prop is None:
                prop = np.asarray(props[i, :k_eff])
            tgt = np.asarray(toks[i])
            a = accepted_prefix(prop[:k_eff], tgt[:k_eff])
            emitted = [int(t) for t in prop[:a]] + [int(tgt[a])]
            if self.eos_token is not None:
                for j, t in enumerate(emitted):
                    if t == self.eos_token:
                        emitted = emitted[:j + 1]
                        break
            self.offsets[slot] = off + len(emitted)
            self.last_tok[slot] = emitted[-1]
            for t in emitted:
                self._record_token(rid, t, first=False)
            n_proposed += k_eff
            n_accepted += a
            self.n_spec_proposed += k_eff
            self.n_spec_accepted += a
            self.last_verify_executed[rid] = k_eff
            self.scheduler.commit_speculation(
                rid, proposed=k_eff, accepted=a, extra=len(emitted) - 1,
                committed_len=int(self.offsets[slot]))
            self._maybe_finish(rid, emitted[-1])
        return n_proposed, n_accepted

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
            self._handoff_chunks.pop(rid, None)
            self.enc_frames.pop(rid, None)


class EngineHandoff:
    """``HandoffBridge`` over two Engines sharing one model + params.
    With ``streaming=True`` the source engine stages each completed layer
    group through its per-iteration fetch, so exports assemble from
    chunks with zero extra host syncs; ``streaming=False`` is the whole-
    prompt baseline (one copy and one sync per migration).  The transfer
    is host-to-host, so ``ready_time == export_time``."""

    def __init__(self, src: Engine, dst: Engine, *,
                 streaming: bool = True):
        if src.cfg is not dst.cfg and src.cfg != dst.cfg:
            raise ValueError("prefill/decode engines must share the model "
                             "config (KV layouts must match)")
        src.handoff_staging = streaming
        self.src = src
        self.dst = dst

    def decode_free_pages(self) -> int:
        return self.dst.alloc.n_free_pages

    def stage(self, plan, requests, t_end, duration) -> None:
        pass            # the engine stages inside execute_plan

    def export(self, req, now) -> Migration:
        payload = self.src.export_request(req.req_id)
        blob = [rows for _, _, rows in payload["chunks"]] \
            if payload["row"] is None else payload["row"]
        return Migration(req=req, payload=payload, export_time=now,
                         ready_time=now, n_chunks=len(payload["chunks"]),
                         bytes_total=float(_nbytes(blob)))

    def can_import(self, m: Migration) -> bool:
        return bool(self.dst._free_slots) \
            and self.dst.alloc.can_import(m.payload["kv"])

    def do_import(self, m: Migration, now) -> Dict[str, int]:
        imp = self.dst.import_request(m.payload)
        return {"linked_tokens": imp.linked_tokens,
                "moved_tokens": imp.moved_tokens}

    def drop(self, req_id: int) -> None:
        self.src._handoff_chunks.pop(req_id, None)

    def abort_export(self, m: Migration) -> None:
        """A link failure lost migration ``m``'s payload in flight.
        Reinstall its token buffers on the prefill engine — the generated
        tail folds into the prompt array (the runtime already folded the
        Request itself to PREEMPTED) — so the whole-prompt retry re-
        prefills bit-identically.  The exported KV pages died with the
        link: ``export_pages`` already freed them from this pool."""
        req = m.req
        rid = req.req_id
        p = m.payload
        prompt = np.asarray(p["prompt"], np.int32)
        tail = req.prompt_len - len(prompt)
        if tail:
            prompt = np.concatenate(
                [prompt, np.asarray(p["outputs"][-tail:], np.int32)])
        assert len(prompt) == req.prompt_len, \
            (rid, len(prompt), req.prompt_len)
        self.src.requests[rid] = req
        self.src.prompts[rid] = prompt
        self.src.outputs[rid] = p["outputs"]
        if p["enc_frames"] is not None:
            self.src.enc_frames[rid] = p["enc_frames"]

    def return_to_prefill(self, req) -> None:
        rid = req.req_id
        for src_d, dst_d in ((self.dst.requests, self.src.requests),
                             (self.dst.prompts, self.src.prompts),
                             (self.dst.outputs, self.src.outputs)):
            dst_d[rid] = src_d.pop(rid)
        if rid in self.dst.enc_frames:
            self.src.enc_frames[rid] = self.dst.enc_frames.pop(rid)
