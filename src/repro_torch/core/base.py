"""Scheduler base: request table, memory-pressure-aware admission, decode
bookkeeping, and preemption.

Schedulers are *pure control logic* — no jax, no timing. The same scheduler
instance drives either the real-execution engine (serving/engine.py) or the
discrete-event simulator (serving/simulator.py); that the two share this
code is what makes the functional-equivalence tests meaningful.

Invariants enforced here and asserted by tests/test_scheduler_invariants.py:
  I1 (stall-free): every iteration's plan decodes EVERY request in DECODE
      state — decode work is never preempted by prefill.  (A memory-pressure
      eviction moves its victim OUT of DECODE before the plan is built, so
      I1 is stated over the post-eviction decode set.)
  I2 (coverage): over a prefill *epoch* (admission → completion or
      preemption) a request's slices tile the rectangle
      [0, prompt_len) x [0, n_blocks) at most once, and the final epoch
      tiles it exactly once — each layer sees each prompt token exactly
      once per epoch (the paper's anti-amplification property is I2 plus
      the per-iteration shape of the slices).
  I3 (order): slices of a request are emitted in block-major/token-major
      order consistent with causal dependencies (restarting at (0, 0) on a
      new epoch).

Memory model (DESIGN.md §Paged KV memory): when a ``PagedKVAllocator`` is
attached, admission reserves ``prompt_len + decode_reserve`` tokens of KV
plus the scheduler's worst-case boundary-activation stash up front, so
prefill never runs out of pages mid-flight; decode growth past the
reservation is charged page-by-page at the top of ``next_plan`` and, when
the pool is dry, evicts victims latest-arrival-first.  Without an
allocator the schedulers behave exactly as before (slot-bound admission
only).

Eviction is mode-aware (DESIGN.md §Swap-to-host preemption):

  * "recompute" — free the victim's pages and fold its generated tokens
    into the recompute prompt; the request re-enters PREFILL at the head
    of the queue (the PR-2 behaviour, always available as a fallback).
  * "swap" — move the victim's KV pages to the allocator's host pool
    intact (``RequestState.SWAPPED``).  Re-admission is a DMA-back gated
    on free HBM pages AND the per-iteration swap-in token budget
    (``swap_in_budget``); the request then resumes DECODE directly.
    Only complete-KV victims (DECODE state, no live stash) are swappable;
    mid-prefill victims and host-pool overflow fall back to recompute.
  * "auto" — per victim, swap iff ``swap_cost_fn`` (wired by the executor
    from the hardware cost model) says the DMA round-trip is cheaper than
    re-running the recompute prefill; without a cost hook, auto prefers
    swap whenever the victim is swappable.

Multi-tenant SLO classes (DESIGN.md §Serving runtime): every request
carries a ``slo_class`` ("interactive" | "batch" | operator-defined).
The eviction victim walk is class-aware — candidates are ranked by
``CLASS_EVICT_RANK`` FIRST (batch victims go before interactive ones) and
latest-arrival within a class — and admission can reserve per-class
headroom pages: with ``class_headroom={"interactive": k}``, a request of
any OTHER class must leave k pages free, so a batch burst cannot starve
interactive admissions.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from repro_torch.core.plan import IterationPlan, Request, RequestState

if TYPE_CHECKING:  # avoid core <-> serving import cycle at runtime
    from repro_torch.serving.kvcache import PagedKVAllocator

# Eviction priority per SLO class: HIGHER rank is evicted first.  Unknown
# classes rank with "interactive" (never evicted ahead of batch work).
CLASS_EVICT_RANK: Dict[str, int] = {"interactive": 0, "batch": 1}


def fold_for_recompute(r: Request) -> None:
    """Fold ``r``'s generated tokens into its recompute prompt and reset
    the prefill counters for a fresh epoch (PREEMPTED state).  Recompute
    prefill covers prompt + everything generated so far; its final slice
    then emits generation token n_generated + 1 (greedy decode of token
    g+1 given the g-token prefix is the same function whether reached by
    a decode step or by prefill over the prefix).  Only the NOT-yet-
    folded tail is appended — a second fold must not duplicate tokens
    folded by the first.  Module-level because the disaggregated runtime
    folds in-flight migrations that belong to NO scheduler (a dropped
    link's victim); callers queue/route the request themselves."""
    if r.orig_prompt_len is None:
        r.orig_prompt_len = r.prompt_len
    r.prompt_len += r.n_generated - r.n_folded
    r.n_folded = r.n_generated
    r.tokens_done = 0
    r.blocks_done = 0
    r.n_preemptions += 1
    r.state = RequestState.PREEMPTED


class Scheduler:
    name = "base"

    def __init__(self, n_blocks: int, *, n_slots: int = 16,
                 token_budget: int = 512, quantum: int = 512):
        self.n_blocks = n_blocks
        self.n_slots = n_slots
        self.token_budget = token_budget
        self.quantum = quantum
        self.requests: Dict[int, Request] = {}
        self.waiting: deque = deque()
        self.iteration = 0
        # paged KV memory (optional — None means unbounded memory)
        self.kv: Optional["PagedKVAllocator"] = None
        self.decode_reserve = 0
        self.preemption_enabled = True
        self.preemption_mode = "recompute"
        self.swap_in_budget: Optional[int] = None
        self.swap_cost_fn: Optional[Callable[[Request], bool]] = None
        self.class_headroom: Dict[str, int] = {}
        self.n_preemptions = 0
        self.n_swap_outs = 0
        # speculative verify-k decoding (configure_speculation): budgets are
        # planned here, executed by the engine/simulator, and fed back via
        # commit_speculation
        self.spec_mode = "off"
        self.spec_k = 0
        self.spec_adaptive = True
        self._spec_ema: Dict[int, float] = {}

    # -- memory subsystem ------------------------------------------------------

    def attach_kv(self, kv: "PagedKVAllocator", *,
                  decode_reserve: Optional[int] = None,
                  preemption: bool = True, mode: str = "recompute",
                  swap_in_budget: Optional[int] = None,
                  swap_cost_fn=None,
                  class_headroom: Optional[Dict[str, int]] = None) -> None:
        """Share a paged allocator with this scheduler. ``decode_reserve``
        is the per-request decode KV reservation in tokens (default: one
        page); growth beyond it triggers the preemption path.  ``mode``
        selects the eviction flavour ("recompute" | "swap" | "auto");
        ``swap_in_budget`` caps the KV tokens DMA'd back from host per
        iteration (None = unlimited); ``swap_cost_fn(req) -> bool`` prices
        swap vs recompute per victim for "auto" (True = swap is cheaper).
        ``class_headroom`` maps an SLO class to pages reserved for it:
        admission of any OTHER class must leave that many pages free."""
        if mode not in ("recompute", "swap", "auto"):
            raise ValueError(f"unknown preemption mode {mode!r}")
        if mode != "recompute" and kv.n_host_pages <= 0:
            raise ValueError(
                f"preemption mode {mode!r} needs a host pool; construct "
                "PagedKVAllocator with n_host_pages > 0")
        self.kv = kv
        self.decode_reserve = kv.page_size if decode_reserve is None \
            else decode_reserve
        self.preemption_enabled = preemption
        self.preemption_mode = mode
        self.swap_in_budget = swap_in_budget
        self.swap_cost_fn = swap_cost_fn
        self.class_headroom = dict(class_headroom or {})

    def configure_speculation(self, mode: str = "off", k: int = 4,
                              adaptive: bool = True) -> None:
        """Enable speculative verify-k decoding.  ``mode`` selects the
        drafter the executor runs ("ngram" | "draft"; "off" disables);
        ``k`` is the per-request draft budget ceiling; ``adaptive`` scales
        the draft-model budget by a per-request acceptance EMA (n-gram
        proposals are already self-limiting, so the EMA only gates the
        draft-model path)."""
        if mode not in ("off", "ngram", "draft"):
            raise ValueError(f"unknown speculation mode {mode!r}")
        if mode != "off" and k < 1:
            raise ValueError("speculation needs k >= 1")
        self.spec_mode = mode
        self.spec_k = k if mode != "off" else 0
        self.spec_adaptive = adaptive

    def _spec_budget(self, r: Request) -> int:
        """Draft budget for ``r`` this iteration: the configured k, shrunk
        by the acceptance EMA (draft mode), and capped so the base token
        plus every accepted draft can never exceed max_new_tokens."""
        cap = r.max_new_tokens - r.n_generated - 1
        if cap <= 0:
            return 0
        k = self.spec_k
        if self.spec_adaptive and self.spec_mode == "draft":
            ema = self._spec_ema.get(r.req_id, 1.0)
            k = max(1, int(round(ema * self.spec_k)))
        return min(k, cap)

    def _spec_budgets(self) -> Dict[int, int]:
        """Per-request draft budgets for this iteration's decode set, with
        the verify window's worst-case KV pre-charged (``reserve_spec``).
        Speculation is opportunistic: it never evicts — when the pool
        cannot cover the full window the budget shrinks (possibly to 0)
        instead, so spec on/off admission and eviction decisions are
        identical."""
        if self.spec_mode == "off":
            return {}
        budgets: Dict[int, int] = {}
        decodes = sorted((r for r in self.requests.values()
                          if r.state == RequestState.DECODE
                          and r.use_speculation),
                         key=lambda r: r.req_id)
        for r in decodes:
            k = self._spec_budget(r)
            if k <= 0:
                continue
            if self.kv is not None:
                base = r.prompt_len + r.n_generated - r.n_folded
                while k > 0 and self.kv.growth_deficit(r.req_id, base + k) \
                        > self.kv.n_free_pages:
                    k -= 1
                if k <= 0:
                    continue
                self.kv.reserve_spec(r.req_id, base + k)
            budgets[r.req_id] = k
        return budgets

    def commit_speculation(self, req_id: int, *, proposed: int,
                           accepted: int, extra: int,
                           committed_len: Optional[int] = None) -> None:
        """Executor feedback after verifying ``req_id``'s drafts:
        ``proposed`` tokens were drafted, ``accepted`` matched the target
        argmax, and ``extra`` tokens were emitted BEYOND the base decode
        token (normally == accepted; EOS truncation can make it smaller).
        Updates generation counters, the acceptance EMA, and trims the
        speculative page reservation back to ``committed_len`` (the filled
        KV length; inferred from the allocator record when omitted).  MUST
        be called for every id in ``plan.verify_len`` — a 0-proposal call
        is how the page pre-charge of a skipped row is released."""
        r = self.requests[req_id]
        if proposed > 0:
            r.n_spec_rounds += 1
            r.n_drafted += proposed
            r.n_draft_accepted += accepted
            r.accepted_lens.append(accepted)
            ema = self._spec_ema.get(req_id, 1.0)
            self._spec_ema[req_id] = 0.5 * ema + 0.5 * (accepted / proposed)
        if extra > 0:
            r.n_generated += extra
            assert r.n_generated <= r.max_new_tokens, req_id
            if r.n_generated >= r.max_new_tokens \
                    and r.state == RequestState.DECODE:
                r.state = RequestState.DONE
        if self.kv is not None and self.kv.is_resident(req_id):
            if r.state == RequestState.DONE:
                self.kv.free(req_id)
            else:
                if committed_len is None:
                    committed_len = self.kv.length(req_id) + extra
                self.kv.grow_to(req_id, committed_len)
                self.kv.release_spec(req_id)
        if r.state == RequestState.DONE:
            self._spec_ema.pop(req_id, None)

    def _headroom_for(self, slo_class: str) -> int:
        """Pages a request of ``slo_class`` must leave free at admission:
        the headroom reserved for every OTHER class."""
        return sum(pages for cls, pages in self.class_headroom.items()
                   if cls != slo_class)

    def max_stash_tokens(self, req: Request,
                         prompt_len: Optional[int] = None) -> int:
        """Worst-case boundary-activation stash (in prompt tokens) this
        scheduler will hold live for ``req`` — charged against the page
        pool at admission. Token-axis schedulers carry no stash.
        ``prompt_len`` overrides the request's current value (used to
        evaluate eligibility at the POST-fold recompute length)."""
        return 0

    # -- lifecycle -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        assert req.req_id not in self.requests
        req.state = RequestState.WAITING
        self.requests[req.req_id] = req
        self.waiting.append(req.req_id)

    def finish(self, req_id: int) -> None:
        """Executor signals EOS / client cancel before max_new_tokens."""
        self.requests[req_id].state = RequestState.DONE
        self._spec_ema.pop(req_id, None)
        if self.kv is not None and self.kv.owns(req_id):
            self.kv.free(req_id)

    # -- inter-pool migration (disaggregated serving) --------------------------

    def can_adopt(self, req: Request) -> bool:
        """True iff an imported request (KV already landed on this
        scheduler's allocator) can join the resident set right now."""
        return self.n_active < self.n_slots

    def adopt(self, req: Request) -> None:
        """Place a migrated request directly into DECODE.  The caller has
        already materialized its KV on this scheduler's allocator
        (``import_pages``) — adoption is pure bookkeeping; the next plan
        decodes it under invariant I1 like any other resident."""
        assert req.req_id not in self.requests, req.req_id
        assert self.kv is None or self.kv.is_resident(req.req_id), req.req_id
        req.state = RequestState.DECODE
        self.requests[req.req_id] = req

    def pop_request(self, req_id: int) -> Request:
        """Remove a request from this scheduler entirely (migration out).
        Its KV, if any, must already have been exported/freed — this drops
        only control state.  The mirror of ``adopt``/``submit``."""
        r = self.requests.pop(req_id)
        try:
            self.waiting.remove(req_id)
        except ValueError:
            pass
        self._spec_ema.pop(req_id, None)
        return r

    def readmit(self, req: Request) -> None:
        """Accept a recompute victim routed back from another pool (the
        decode pool cannot prefill, so its fold-to-recompute victims return
        here).  The fold already ran on the evicting scheduler; requeue at
        the HEAD exactly like a local preemption so the victim is not
        starved behind never-admitted arrivals."""
        assert req.req_id not in self.requests, req.req_id
        assert req.state == RequestState.PREEMPTED, req.state
        self.requests[req.req_id] = req
        self.waiting.appendleft(req.req_id)

    @property
    def active(self) -> List[Request]:
        return [r for r in self.requests.values()
                if r.state in (RequestState.PREFILL, RequestState.DECODE)]

    @property
    def n_active(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.n_active > 0

    def decode_ids(self) -> List[int]:
        return sorted(r.req_id for r in self.requests.values()
                      if r.state == RequestState.DECODE)

    # -- admission ------------------------------------------------------------

    def _kv_admissible(self, r: Request) -> bool:
        if self.kv is None:
            return True
        need = r.prompt_len + self.decode_reserve
        stash = self.max_stash_tokens(r)
        headroom = self._headroom_for(r.slo_class)
        # a request that cannot fit even an EMPTY pool (minus the headroom
        # reserved for other classes) would wait forever — surface it
        # instead of deadlocking the queue (queued requests have
        # n_generated == n_folded, so prompt_len + remaining generation is
        # the true final sequence length).  The worst case is deliberately
        # NOT prefix-aware: shared pages can be reclaimed under pressure.
        worst = r.prompt_len + (r.max_new_tokens - r.n_folded)
        if not self.kv.fits_pool(worst, stash, headroom_pages=headroom):
            reserved = f" minus {headroom} headroom pages" if headroom else ""
            raise RuntimeError(
                f"request {r.req_id} needs {worst} KV tokens "
                f"(+{stash} stash) but the pool holds only "
                f"{self.kv.n_pages * self.kv.page_size} tokens{reserved}; "
                f"enlarge --pages or shard the request")
        # prefix-aware admission: matched prefix tokens are charged zero new
        # pages (can_admit links, not allocates, shared pages) and the stash
        # only ever carries the UNCACHED tail of the prompt
        hit = self.kv.lookup_prefix(r.cacheable_prompt, r.prefix_root)
        stash = self.max_stash_tokens(
            r, prompt_len=r.prompt_len - hit.cached_tokens)
        return self.kv.can_admit(need, stash, headroom_pages=headroom,
                                 prompt_tokens=r.cacheable_prompt,
                                 root=r.prefix_root)

    def admit(self, now: float, limit: Optional[int] = None) -> List[int]:
        """FCFS admission, gated on BOTH a free slot and the page pool
        holding the request's prompt KV + decode reservation + stash.
        Head-of-line blocking is deliberate: bypassing a big request with
        later small ones would starve it under sustained load."""
        admitted = []
        while self.waiting and self.n_active < self.n_slots:
            if limit is not None and len(admitted) >= limit:
                break
            rid = self.waiting[0]
            r = self.requests[rid]
            if r.state == RequestState.SWAPPED:
                # swapped requests re-enter ONLY via the swap-in pass at the
                # top of next_plan (HBM pages + bandwidth budget gates);
                # bypassing this head-of-line victim would starve it
                break
            if not self._kv_admissible(r):
                break
            self.waiting.popleft()
            if self.kv is not None:
                hit = self.kv.lookup_prefix(r.cacheable_prompt,
                                            r.prefix_root)
                stash = self.max_stash_tokens(
                    r, prompt_len=r.prompt_len - hit.cached_tokens)
                hit = self.kv.reserve(rid, r.prompt_len + self.decode_reserve,
                                      stash, prompt_tokens=r.cacheable_prompt,
                                      root=r.prefix_root)
                # matched prefix tokens are already computed: this prefill
                # epoch starts past the cached boundary (every layer group
                # skips them uniformly — per-group KV is complete for
                # cached blocks)
                r.tokens_done = hit.cached_tokens
                r.cached_prompt_tokens += hit.cached_tokens
            r.admitted_prompt_tokens += r.prompt_len
            r.state = RequestState.PREFILL
            if r.admit_time is None:        # queueing delay = FIRST admission
                r.admit_time = now
            admitted.append(rid)
        return admitted

    # -- preemption ------------------------------------------------------------

    def _evictable(self, r: Request) -> bool:
        """True iff ``r`` would still fit an EMPTY pool after the
        restore-by-recompute fold (prompt + generated-so-far, with the
        stash re-evaluated at the folded length, and the same per-class
        headroom its re-admission will be gated on)."""
        folded = r.prompt_len + (r.n_generated - r.n_folded)
        worst = folded + (r.max_new_tokens - r.n_generated)
        return self.kv.fits_pool(worst,
                                 self.max_stash_tokens(r, prompt_len=folded),
                                 headroom_pages=self._headroom_for(r.slo_class))

    def _on_preempt(self, req_id: int) -> None:
        """Scheduler-specific cleanup (drop the victim from in-flight cohort
        / chunk-run state). Base schedulers keep no such state."""

    def swap_out(self, req_id: int, now: float = 0.0) -> None:
        """Evict ``req_id`` by swapping its KV pages to the host pool
        (``SWAPPED`` state): no pages are lost, no tokens are folded, and
        re-admission resumes DECODE directly after the DMA-back.  Requeued
        at the head like a recompute victim."""
        r = self.requests[req_id]
        assert r.state == RequestState.DECODE, r.state
        self._on_preempt(req_id)
        self.kv.swap_out(req_id)
        r.state = RequestState.SWAPPED
        r.n_swaps += 1
        r.swap_out_times.append(now)
        self.waiting.appendleft(req_id)
        self.n_swap_outs += 1

    def preempt(self, req_id: int) -> None:
        """Evict ``req_id`` (restore-by-recompute): free its pages, fold the
        tokens it already generated into the recompute prompt, and requeue
        it ahead of never-admitted arrivals (earliest-arrival first)."""
        r = self.requests[req_id]
        assert r.state in (RequestState.PREFILL, RequestState.DECODE), r.state
        self._on_preempt(req_id)
        if self.kv is not None and self.kv.owns(req_id):
            self.kv.free(req_id)
        fold_for_recompute(r)
        self.waiting.appendleft(req_id)
        self.n_preemptions += 1

    def shed(self, req_id: int, reason: str = "deadline") -> None:
        """Remove ``req_id`` from service without completing it (deadline
        expiry, retry exhaustion, client disconnect, load shedding):
        release every page it holds — resident, swapped, or stash — drop
        it from the waiting queue, and mark it DONE with ``shed_reason``
        so metrics can tell a shed stream from a finished one.  Unlike
        ``finish`` this handles any pre-DONE state and scrubs the waiting
        deque (a DONE rid left at the head would corrupt ``admit``)."""
        r = self.requests[req_id]
        assert r.state != RequestState.DONE, req_id
        self._on_preempt(req_id)
        try:
            self.waiting.remove(req_id)
        except ValueError:
            pass
        self._spec_ema.pop(req_id, None)
        if self.kv is not None and self.kv.owns(req_id):
            self.kv.free(req_id)
        r.state = RequestState.DONE
        r.shed_reason = reason

    def fail_swap_out(self, req_id: int) -> None:
        """A swap-out DMA failed mid-flight: the host copy is void, so the
        victim cannot be restored by swap-in.  Demote it to a recompute
        eviction — free its pages (dropping the dead host copy), un-record
        the swap, and fold for a fresh prefill epoch.  The request is
        already queued at the head from ``swap_out``; only the state and
        the pages change, exactly like ``_demote_swapped``."""
        r = self.requests[req_id]
        assert r.state == RequestState.SWAPPED, r.state
        self.kv.free(req_id)
        r.n_swaps -= 1
        if r.swap_out_times:
            r.swap_out_times.pop()
        self.n_swap_outs -= 1
        fold_for_recompute(r)
        self.n_preemptions += 1

    def _evict_route(self, r: Request) -> Optional[str]:
        """Eviction flavour available for victim ``r``: "swap" (KV pages to
        host, no work lost), "recompute" (fold + re-prefill), or None when
        neither leaves the request restorable.  Swap requires a complete KV
        (DECODE state — mid-prefill boundary stashes are execution state,
        not KV) and host-pool room; "auto" additionally asks the executor's
        cost hook whether the DMA round-trip beats the recompute prefill."""
        swappable = (self.preemption_mode != "recompute"
                     and r.state == RequestState.DECODE
                     and self.kv.can_swap_out(r.req_id))
        recomputable = self._evictable(r)
        if swappable:
            if self.preemption_mode == "swap":
                return "swap"
            if (self.swap_cost_fn is None or self.swap_cost_fn(r)
                    or not recomputable):
                return "swap"
        return "recompute" if recomputable else None

    def _reserve_decode_growth(self, now: float):
        """Pre-charge this iteration's decode KV growth (one token per
        DECODE request), evicting victims latest-arrival-first while the
        pool cannot cover the deficit. Runs BEFORE the plan is built so I1
        is stated over the surviving decode set.  Returns the recompute
        and swap victim id lists."""
        if self.kv is None:
            return [], []
        preempted: List[int] = []
        swapped: List[int] = []
        decodes: List[Request] = []
        while True:
            decodes = [r for r in self.requests.values()
                       if r.state == RequestState.DECODE]
            # KV after this iteration's write: recompute prompt plus the
            # tokens generated SINCE the last fold (folded ones are already
            # inside prompt_len)
            deficit = sum(
                self.kv.growth_deficit(
                    r.req_id,
                    r.prompt_len + r.n_generated - r.n_folded)
                for r in decodes)
            if deficit <= self.kv.n_free_pages:
                break
            if not self.preemption_enabled:
                # let grow_to below surface PagedPoolExhausted — the
                # operator chose queueing-only (--preemption off)
                break
            # eligible victims: eviction must leave the request restorable
            # (swap: host-pool room; recompute: the post-fold footprint
            # still fits an empty pool).  The earliest-arrival resident is
            # never evicted: admission guarantees a lone request always
            # fits, so keeping it guarantees forward progress.  The guard
            # is CLASS-AWARE: protect the earliest within the highest-
            # priority class present — a batch-class earliest resident
            # must not shield itself while interactive requests starve.
            residents = self.active
            best_rank = min(CLASS_EVICT_RANK.get(r.slo_class, 0)
                            for r in residents)
            earliest = min((r for r in residents
                            if CLASS_EVICT_RANK.get(r.slo_class, 0)
                            == best_rank),
                           key=lambda r: (r.arrival_time, r.req_id))
            # walk candidates class-rank-first (batch victims before
            # interactive — CLASS_EVICT_RANK), latest-arrival within a
            # class, and take the FIRST with an eviction route — identical
            # victim to scoring them all, but the route (and the auto-mode
            # cost hook behind it) is evaluated only until a victim is
            # found, not per resident
            victim = route = None
            for r in sorted((r for r in self.active if r is not earliest),
                            key=lambda r: (CLASS_EVICT_RANK.get(r.slo_class, 0),
                                           r.arrival_time, r.req_id),
                            reverse=True):
                route = self._evict_route(r)
                if route:
                    victim = r
                    break
            if victim is None:
                # every resident is shielded: the pool must be pinned by
                # SWAPPED requests' shared prefix pages.  Demote one to a
                # recompute victim (releasing its pin + host copy) before
                # declaring the pool undersized.
                demoted = self._demote_swapped(exclude=swapped)
                if demoted is not None:
                    preempted.append(demoted)
                    continue
                raise RuntimeError(
                    "paged KV pool cannot cover decode growth and no "
                    "evictable resident remains — enlarge the pool")
            if route == "swap":
                self.swap_out(victim.req_id, now)
                swapped.append(victim.req_id)
            else:
                self.preempt(victim.req_id)
                preempted.append(victim.req_id)
        for r in decodes:
            self.kv.grow_to(r.req_id,
                            r.prompt_len + r.n_generated - r.n_folded)
        return preempted, swapped

    def _demote_swapped(self, exclude: List[int] = ()) -> Optional[int]:
        """Pressure valve for the swap-pin deadlock: a SWAPPED request's
        shared prefix pages stay pinned in HBM, so enough swapped victims
        can starve the lone protected resident's decode growth with no
        resident evictable (acute on a disaggregated decode pool, whose
        imports register every prompt page as shared).  Fold the lowest-
        priority latest-arrival swapped request to a recompute victim —
        the only transition that unpins without a swap-in.  It is already
        queued at the head from its swap-out; only the state and the
        pages change.  ``exclude`` holds THIS iteration's swap victims
        (demoting one would undo the swap it just paid for).  Returns
        the demoted id, or None if no swapped request qualifies."""
        cands = [r for r in self.requests.values()
                 if r.state == RequestState.SWAPPED
                 and r.req_id not in exclude and self._evictable(r)]
        if not cands:
            return None
        victim = max(cands,
                     key=lambda r: (CLASS_EVICT_RANK.get(r.slo_class, 0),
                                    r.arrival_time, r.req_id))
        rid = victim.req_id
        self.kv.free(rid)
        fold_for_recompute(victim)
        self.n_preemptions += 1
        return rid

    def _readmit_swapped(self, now: float,
                         exclude: List[int] = ()) -> List[int]:
        """DMA-back pass: restore SWAPPED requests from the head of the
        queue while (a) a slot is free, (b) the HBM pool holds their pages,
        and (c) the per-iteration swap-in token budget allows.  At least
        one restore is always allowed once pages fit — a budget smaller
        than the smallest request must throttle, not deadlock.  Restored
        requests resume DECODE directly (their KV is intact).  ``exclude``
        holds THIS iteration's swap victims: restoring one of them would
        be a zero-progress DMA round trip (it would retake the very pages
        it just vacated and be evicted again next iteration), so the pass
        stops at them until at least one iteration has elapsed."""
        if self.kv is None:
            return []
        budget = self.swap_in_budget
        swapped_in: List[int] = []
        while self.waiting and self.n_active < self.n_slots:
            rid = self.waiting[0]
            r = self.requests[rid]
            if r.state != RequestState.SWAPPED or rid in exclude:
                break
            if not self.kv.can_swap_in(rid):
                break
            # the DMA-back is a re-admission: it must leave the same
            # per-class headroom free that queue admission enforces, or a
            # swapped batch request would retake the interactive reserve
            if self.kv.n_free_pages - self.kv.swapped_pages(rid) \
                    < self._headroom_for(r.slo_class):
                break
            need = self.kv.length(rid)
            if budget is not None and need > budget and swapped_in:
                break
            self.waiting.popleft()
            r.swap_in_times.append(now)
            self.kv.swap_in(rid)
            r.state = RequestState.DECODE
            swapped_in.append(rid)
            if budget is not None:
                budget -= need
                if budget <= 0:
                    break
        return swapped_in

    # -- per-iteration hooks ----------------------------------------------------

    def next_plan(self, now: float = 0.0) -> IterationPlan:
        """Template method: resolve memory pressure (possibly evicting via
        recompute-fold or swap-to-host), restore swapped requests within
        the DMA budget, then delegate iteration planning to ``_plan``."""
        preempted, swapped_out = self._reserve_decode_growth(now)
        # draft budgets over the post-eviction decode set; requests swapped
        # IN below decode plainly their first iteration back (their budget
        # pass already ran)
        spec = self._spec_budgets()
        swapped_in = self._readmit_swapped(now, exclude=swapped_out)
        plan = self._plan(now)
        plan.preempted_ids = preempted
        plan.swapped_out_ids = swapped_out
        plan.swapped_in_ids = swapped_in
        if spec:
            in_plan = set(plan.decode_ids)
            plan.verify_len = {rid: k for rid, k in spec.items()
                               if rid in in_plan}
            if self.kv is not None:      # defensive: never strand a charge
                for rid in spec:
                    if rid not in in_plan:
                        self.kv.release_spec(rid)
        return plan

    def _plan(self, now: float) -> IterationPlan:
        raise NotImplementedError

    def _finish_decode_bookkeeping(self, plan: IterationPlan) -> None:
        """Advance decode counters; retire requests that hit max_new_tokens.
        The first token of a prefill epoch is produced by its final prefill
        slice, so a fresh request entering DECODE has n_generated == 1 (a
        recompute-restored one continues from its pre-eviction count)."""
        for rid in plan.decode_ids:
            r = self.requests[rid]
            r.n_generated += 1
            if r.n_generated >= r.max_new_tokens:
                r.state = RequestState.DONE
                if self.kv is not None and self.kv.owns(rid):
                    self.kv.free(rid)
        for sl in plan.prefill:
            if sl.emits_first_token:
                r = self.requests[sl.req_id]
                if self.kv is not None and self.kv.owns(sl.req_id):
                    self.kv.set_length(sl.req_id, r.prompt_len)
                    self.kv.release_stash(sl.req_id)
                    # publish the completed prompt's full pages into the
                    # shared-prefix index (idempotent — the engine may have
                    # registered already when snapshotting its KV row) so
                    # later admissions can link them refcounted
                    self.kv.register_prefix(sl.req_id, r.cacheable_prompt,
                                            r.prefix_root)
                r.state = RequestState.DECODE
                r.n_generated += 1
                if r.n_generated >= r.max_new_tokens:
                    r.state = RequestState.DONE
                    if self.kv is not None and self.kv.owns(sl.req_id):
                        self.kv.free(sl.req_id)
        self.iteration += 1


SCHEDULERS: Dict[str, type] = {}

# Schedulers resolvable by make_scheduler but absent from the public
# SCHEDULERS enumeration (CLI choices, invariant sweeps): pool-internal
# roles that are not standalone serving policies.
_INTERNAL_SCHEDULERS: Dict[str, type] = {}


def register(cls):
    SCHEDULERS[cls.name] = cls
    return cls


def register_internal(cls):
    _INTERNAL_SCHEDULERS[cls.name] = cls
    return cls


def make_scheduler(name: str, n_blocks: int, **kw) -> Scheduler:
    cls = SCHEDULERS.get(name) or _INTERNAL_SCHEDULERS.get(name)
    if cls is None:
        raise KeyError(f"unknown scheduler {name!r}; known: {list(SCHEDULERS)}")
    return cls(n_blocks, **kw)


@register_internal
class DecodeOnlyScheduler(Scheduler):
    """The decode pool's scheduler in disaggregated serving: residents
    arrive exclusively via ``adopt`` (KV imported from the prefill pool),
    so ``_plan`` never admits and never emits prefill slices — the pool's
    iteration clock contains ONLY decode work, which is what makes the
    decode pool's TBT provably prefill-free.  Memory pressure still runs:
    decode growth can evict (swap victims restore locally through
    ``_readmit_swapped``; recompute victims fold and are routed BACK to
    the prefill pool by the disaggregated runtime)."""

    name = "decode"

    def _plan(self, now: float = 0.0) -> IterationPlan:
        plan = IterationPlan()
        plan.decode_ids = self.decode_ids()
        self._finish_decode_bookkeeping(plan)
        return plan
