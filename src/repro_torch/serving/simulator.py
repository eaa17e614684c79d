"""Discrete-event serving simulator — the port's copy of the JAX
package's ``serving/simulator.py``.

Drives the SAME scheduler classes as the real-execution engine through the
analytic cost model (``serving/cost_model.py``), producing paper-scale
latency/energy numbers on the host: iterations are events whose durations
come from ``CostModel``; arrivals are an exogenous trace (Poisson or
bursty).  This is the apparatus behind the paper's Figures 3/5 and Tables
2/6/7/8.  It launches nothing on a device, and its times are modelled.

The serving loop itself — arrival injection, stepping, timestamping — is
the shared ``serving.runtime.ServingRuntime`` (the loop that drives the
real engine, backed here by ``SimExecutor``); this module only prices
iterations and aggregates the analytic accounting into a ``SimResult``.
Only TIME and TRAFFIC are modelled: the tokens are the engine's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.base import Scheduler, make_scheduler
from repro_torch.core.plan import Request
from repro_torch.models.config import ModelConfig
from repro_torch.serving.cost_model import CostModel, HardwareSpec, kv_pool_pages
from repro_torch.serving.kvcache import PagedKVAllocator
from repro_torch.serving.runtime import (DisaggRuntime, Migration, ServingRuntime,
                                   SimExecutor)
from repro_torch.serving.traffic import TraceRequest


@dataclass
class SimResult:
    requests: List[Request]
    total_energy: float = 0.0
    total_expert_bytes: float = 0.0
    total_hbm_bytes: float = 0.0
    total_flops: float = 0.0
    n_iterations: int = 0
    sim_time: float = 0.0
    decode_batch_sizes: List[int] = field(default_factory=list)
    # paged-KV memory subsystem accounting
    n_preemptions: int = 0
    recompute_tokens: int = 0      # prefill tokens re-run due to preemption
    pages_high_water: int = 0
    n_pool_pages: int = 0
    # swap-to-host accounting
    n_swap_outs: int = 0
    n_swap_ins: int = 0
    swap_bytes: float = 0.0        # host-link traffic, both directions
    swap_dma_time: float = 0.0     # host-link busy time, both directions
    swap_stall_time: float = 0.0   # DMA time the iteration compute could
    #                                not hide (== swap_dma_time when the
    #                                serial model is selected)
    host_pages_high_water: int = 0
    n_host_pages: int = 0
    # speculative decode accounting (analytic acceptance)
    total_drafted: int = 0
    total_accepted: int = 0
    # automatic prefix caching (traces must carry prompt_tokens to hit)
    n_prefix_hits: int = 0
    prefix_cached_tokens: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        """Token-weighted: cached prompt tokens over all admitted prompt
        tokens (recompute re-admissions included)."""
        admitted = sum(r.admitted_prompt_tokens for r in self.requests)
        return self.prefix_cached_tokens / admitted if admitted else 0.0

    @property
    def acceptance_rate(self) -> float:
        return self.total_accepted / self.total_drafted \
            if self.total_drafted else float("nan")

    @property
    def total_tokens(self) -> int:
        """prompt + generated tokens (paper's energy/token denominator).
        Folded recompute tokens are already inside prompt_len — subtract
        them so preempted requests are not counted twice."""
        return sum(r.prompt_len - r.n_folded + r.n_generated
                   for r in self.requests)

    @property
    def energy_per_token(self) -> float:
        t = self.total_tokens
        return self.total_energy / t if t else float("nan")

    @property
    def mean_decode_batch(self) -> float:
        xs = [b for b in self.decode_batch_sizes if b > 0]
        return sum(xs) / len(xs) if xs else 0.0


class Simulator:
    def __init__(self, cfg: ModelConfig, scheduler, hw: HardwareSpec,
                 moe_dispatch: str = "ragged", n_pages: Optional[int] = None,
                 page_size: int = 16, preemption: bool = True,
                 preemption_mode: str = "recompute",
                 host_pages: Optional[int] = None,
                 swap_in_budget: Optional[int] = None,
                 decode_reserve: Optional[int] = None,
                 swap_overlap: bool = True,
                 class_headroom: Optional[Dict[str, int]] = None,
                 prefix_cache: bool = True,
                 prefix_lru_pages: Optional[int] = None,
                 spec_mode: str = "off", spec_k: int = 4,
                 spec_adaptive: bool = True,
                 spec_acceptance: float = 0.7, spec_seed: int = 0,
                 **sched_kw):
        """The simulator shares the scheduler's ``PagedKVAllocator`` so page
        occupancy, queueing delay, preemption counts and recompute/swap cost
        are first-class outputs of the paper-scale sweeps. ``n_pages``
        defaults to the page count the hardware's HBM can actually hold
        after model weights (see cost_model.kv_pool_pages);
        ``preemption_mode`` picks the eviction flavour ("recompute" |
        "swap" | "auto" — auto prices each victim's DMA round-trip against
        its recompute prefill on this hardware), ``host_pages`` sizes the
        host pool (default 4x the device pool) and ``swap_in_budget`` caps
        DMA-back KV tokens per iteration.  ``swap_overlap`` charges swap
        DMA as overlappable with the iteration's compute (stall =
        max(0, dma - compute)); False restores the PR-3 fully-serial stall
        for comparison.  ``class_headroom`` reserves admission pages per
        SLO class (see core.base.Scheduler.attach_kv).

        ``prefix_cache`` (default on) enables automatic prefix caching on
        the shared allocator; hits need traces that carry
        ``prompt_tokens`` (see traffic.attach_prompt_tokens /
        shared_prefix_trace) — the cost model then prices only the
        uncached prefill rectangles, mirroring the engine.
        ``prefix_lru_pages`` caps retained refcount-0 cached pages.

        ``spec_mode``/``spec_k`` enable speculative verify-k decoding in
        the planned iterations; the simulator has no tokens, so acceptance
        is ANALYTIC — a run of consecutive Bernoulli(``spec_acceptance``)
        successes per verify window, seeded by ``spec_seed`` (token
        counts and durations are deterministic per seed).  The cost model
        prices each window's extra decode-query tokens and the MoE
        expert-load amortization they ride on."""
        self.cfg = cfg
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler, cfg.n_layers, **sched_kw)
        self.scheduler: Scheduler = scheduler
        self.cost = CostModel(cfg, hw, moe_dispatch=moe_dispatch)
        if n_pages is None:
            n_pages = kv_pool_pages(cfg, hw, page_size)
        if host_pages is None:
            host_pages = 4 * n_pages if preemption_mode != "recompute" else 0
        self.kv = PagedKVAllocator(n_pages, page_size,
                                   stash_factor=cfg.stash_token_factor(),
                                   n_host_pages=host_pages,
                                   prefix_caching=prefix_cache,
                                   prefix_lru_pages=prefix_lru_pages)
        swap_cost_fn = None
        if preemption_mode == "auto":
            swap_cost_fn = lambda r: self.cost.swap_beats_recompute(  # noqa: E731
                r.prompt_len + r.n_generated - r.n_folded)
        self.scheduler.attach_kv(self.kv, decode_reserve=decode_reserve,
                                 preemption=preemption,
                                 mode=preemption_mode,
                                 swap_in_budget=swap_in_budget,
                                 swap_cost_fn=swap_cost_fn,
                                 class_headroom=class_headroom)
        self.swap_overlap = swap_overlap
        if spec_mode != "off":
            self.scheduler.configure_speculation(spec_mode, spec_k,
                                                 adaptive=spec_adaptive)
        self.spec_acceptance = spec_acceptance
        self._spec_rng = np.random.default_rng(spec_seed)

    def draw_accepted(self, k: int) -> int:
        """Consecutive-success draw: each of the k drafts is accepted with
        probability ``spec_acceptance`` GIVEN every earlier one was."""
        a = 0
        while a < k and self._spec_rng.random() < self.spec_acceptance:
            a += 1
        return a

    def run(self, trace: List[TraceRequest],
            max_iterations: int = 2_000_000, *,
            on_token=None, clock: str = "executor",
            faults=None, retry_budget: int = 3) -> SimResult:
        """Replay ``trace`` through the shared ServingRuntime loop with the
        analytic backend.  ``on_token``/``clock`` pass straight through to
        the runtime (tokens stream as ``None`` — the simulator carries no
        model; ``clock="iteration"`` interprets arrival times as iteration
        indices for deterministic cross-backend replay).  ``faults`` takes
        a ``serving.faults.FaultInjector`` to chaos-test the analytic
        stack under the same supervision the engine runs with."""
        ex = SimExecutor(self)
        runtime = ServingRuntime(ex, on_token=on_token, clock=clock,
                                 faults=faults, retry_budget=retry_budget)
        rr = runtime.run(trace, max_iterations=max_iterations)
        return self._result(ex, rr.requests, rr.n_iterations, rr.clock,
                            rr.decode_batch_sizes, rr.n_preemptions,
                            rr.recompute_tokens, rr.n_swap_outs,
                            rr.n_swap_ins)

    def _result(self, ex: SimExecutor, requests, n_iterations, sim_time,
                decode_batch_sizes, n_preemptions, recompute_tokens,
                n_swap_outs, n_swap_ins) -> SimResult:
        """Fold one executor's accounting plus this pool's allocator
        counters into a ``SimResult`` (shared by the monolithic ``run``
        and the per-pool reports of ``DisaggSimulator``)."""
        return SimResult(
            requests=requests,
            total_energy=ex.total_energy,
            total_expert_bytes=ex.total_expert_bytes,
            total_hbm_bytes=ex.total_hbm_bytes,
            total_flops=ex.total_flops,
            n_iterations=n_iterations,
            sim_time=sim_time,
            decode_batch_sizes=decode_batch_sizes,
            n_preemptions=n_preemptions,
            recompute_tokens=recompute_tokens,
            pages_high_water=self.kv.pages_high_water,
            n_pool_pages=self.kv.n_pages,
            n_swap_outs=n_swap_outs,
            n_swap_ins=n_swap_ins,
            swap_bytes=ex.swap_bytes,
            swap_dma_time=ex.swap_dma_time,
            swap_stall_time=ex.swap_stall_time,
            host_pages_high_water=self.kv.host_pages_high_water,
            n_host_pages=self.kv.n_host_pages,
            total_drafted=ex.total_drafted,
            total_accepted=ex.total_accepted,
            n_prefix_hits=self.kv.n_prefix_hits,
            prefix_cached_tokens=self.kv.n_prefix_tokens,
        )


class SimHandoff:
    """Analytic ``HandoffBridge``: the inter-pool link is a FIFO resource
    priced by ``CostModel.link_transfer``.  In ``stream`` mode every layer
    group whose KV completes enqueues its chunk at that iteration's end,
    so the transfer overlaps the REMAINING groups' prefill compute and the
    export-time stall is only the residual —
    ``stall = max(0, transfer_done - export_time)``, the paper's
    ``max(0, transfer - remaining_prefill_compute)`` realized on a link
    timeline that also captures cross-request queueing.  ``whole`` mode
    enqueues the full prompt's KV only at export, hiding nothing: with
    G >= 2 layer groups streaming strictly dominates because at most the
    LAST group's chunk (~1/G of the bytes) is left unhidden."""

    def __init__(self, src: Simulator, dst: Simulator,
                 mode: str = "stream"):
        if mode not in ("stream", "whole"):
            raise ValueError(f"unknown handoff mode {mode!r}")
        self.src = src
        self.dst = dst
        self.mode = mode
        self.cost = src.cost
        self._link_free = 0.0          # when the link finishes its queue
        self._done_t: Dict[int, float] = {}
        self._chunks: Dict[int, int] = {}
        self._bytes: Dict[int, float] = {}
        self.link_bytes = 0.0
        self.link_energy = 0.0
        self.n_chunks = 0

    def _enqueue(self, rid: int, n_tokens: float, now: float) -> None:
        x = self.cost.link_transfer(n_tokens)
        start = max(self._link_free, now)
        self._link_free = start + x["duration"]
        self._done_t[rid] = self._link_free
        self._chunks[rid] = self._chunks.get(rid, 0) + 1
        self._bytes[rid] = self._bytes.get(rid, 0.0) + x["bytes"]
        self.link_bytes += x["bytes"]
        self.link_energy += x["energy"]
        self.n_chunks += 1

    def decode_free_pages(self) -> int:
        return self.dst.kv.n_free_pages

    def stage(self, plan, requests, t_end: float, duration: float) -> None:
        if self.mode != "stream":
            return
        nb = self.src.scheduler.n_blocks
        for sl in plan.prefill:
            r = requests[sl.req_id]
            if sl.token_end == r.prompt_len:
                # this group's KV is complete: its share of the prompt's
                # pages enters the link queue at iteration end
                frac = (sl.block_end - sl.block_start) / nb
                self._enqueue(sl.req_id, sl.token_end * frac, t_end)

    def export(self, req: Request, now: float) -> Migration:
        rid = req.req_id
        exp = self.src.kv.export_pages(rid)
        if rid not in self._done_t:
            # whole-prompt handoff (or a chunked scheduler that never
            # completed a partial-stack group): everything crosses now
            self._enqueue(rid, exp.length, now)
        return Migration(req=req, payload=exp, export_time=now,
                         ready_time=max(now, self._done_t.pop(rid, now)),
                         n_chunks=self._chunks.pop(rid, 0),
                         bytes_total=self._bytes.pop(rid, 0.0))

    def can_import(self, m: Migration) -> bool:
        return self.dst.kv.can_import(m.payload)

    def do_import(self, m: Migration, now: float) -> Dict[str, int]:
        imp = self.dst.kv.import_pages(m.payload)
        return {"linked_tokens": imp.linked_tokens,
                "moved_tokens": imp.moved_tokens}

    def drop(self, req_id: int) -> None:
        self._done_t.pop(req_id, None)
        self._chunks.pop(req_id, None)
        self._bytes.pop(req_id, None)

    def abort_export(self, m: Migration) -> None:
        # analytic backends hold no buffers: the exported pages were
        # already freed (move semantics), so voiding the migration only
        # needs the link bookkeeping scrubbed
        self.drop(m.req.req_id)

    def return_to_prefill(self, req: Request) -> None:
        pass                           # analytic backends hold no buffers


@dataclass
class DisaggSimResult:
    """Two-pool analytic outcome: per-pool ``SimResult`` reports plus the
    migration/link accounting.  ``decode_prefill_slices`` MUST be 0 — the
    decode pool's clock never contains prefill work, so every decode-pool
    TBT sample is prefill-stall-free by construction."""
    requests: List[Request]
    prefill: SimResult
    decode: SimResult
    sim_time: float = 0.0
    n_migrations: int = 0
    n_returns: int = 0
    handoff_bytes: float = 0.0
    link_bytes: float = 0.0
    link_energy: float = 0.0
    link_stall_time: float = 0.0
    handoff_wait_time: float = 0.0
    migration_queue_peak: int = 0
    decode_prefill_slices: int = 0
    handoff_linked_tokens: int = 0
    handoff_moved_tokens: int = 0

    @property
    def total_energy(self) -> float:
        return self.prefill.total_energy + self.decode.total_energy \
            + self.link_energy

    def decode_pool_tbts(self) -> List[float]:
        """Inter-token gaps timestamped entirely INSIDE the decode pool
        (at or after the request's last migration) — the latency the
        paper's disaggregation argument protects."""
        out: List[float] = []
        for r in self.requests:
            if r.handoff_time is None:
                continue
            ts = [r.first_token_time] + r.token_times \
                if r.first_token_time is not None else list(r.token_times)
            ts = [x for x in ts if x >= r.handoff_time]
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out

    @property
    def decode_pool_tbt_mean(self) -> float:
        xs = self.decode_pool_tbts()
        return sum(xs) / len(xs) if xs else float("nan")


class DisaggSimulator:
    """Analytic two-pool serving: a prefill ``Simulator`` (any scheduler)
    and a decode ``Simulator`` (``DecodeOnlyScheduler``) coupled by a
    ``SimHandoff`` link under the shared ``DisaggRuntime`` loop.
    ``handoff`` picks group-granular streaming ("stream") or the
    whole-prompt baseline ("whole"); ``decode_pages`` sizes the decode
    pool's allocator (default: mirror the prefill pool);
    ``decode_watermark`` holds new admissions while the decode pool has
    fewer free pages (backpressure).  Remaining kwargs configure the
    prefill pool exactly like ``Simulator``; the decode pool inherits the
    memory/preemption/speculation settings but never admits or prefills."""

    # Simulator kwargs the decode pool inherits (scheduler-specific ones
    # like n_groups/chunk_size stay on the prefill side)
    _POOL_KEYS = ("moe_dispatch", "page_size", "preemption",
                  "preemption_mode", "host_pages", "swap_in_budget",
                  "decode_reserve", "swap_overlap", "class_headroom",
                  "prefix_cache", "prefix_lru_pages", "spec_mode", "spec_k",
                  "spec_adaptive", "spec_acceptance", "spec_seed",
                  "n_slots", "token_budget", "quantum")

    def __init__(self, cfg: ModelConfig, scheduler, hw: HardwareSpec, *,
                 handoff: str = "stream", decode_pages: Optional[int] = None,
                 decode_watermark: int = 0, **kw):
        if handoff not in ("stream", "whole"):
            raise ValueError(f"unknown handoff mode {handoff!r}")
        self.handoff = handoff
        self.decode_watermark = decode_watermark
        self.prefill = Simulator(cfg, scheduler, hw, **kw)
        dkw = {k: kw[k] for k in self._POOL_KEYS if k in kw}
        dkw["n_pages"] = self.prefill.kv.n_pages \
            if decode_pages is None else decode_pages
        self.decode = Simulator(cfg, "decode", hw, **dkw)

    def run(self, trace: List[TraceRequest],
            max_iterations: int = 2_000_000, *,
            on_token=None, clock: str = "executor",
            faults=None, retry_budget: int = 3) -> DisaggSimResult:
        xp = SimExecutor(self.prefill)
        xd = SimExecutor(self.decode)
        bridge = SimHandoff(self.prefill, self.decode, mode=self.handoff)
        runtime = DisaggRuntime(
            xp, xd, bridge, on_token=on_token, clock=clock,
            decode_watermark_pages=self.decode_watermark,
            faults=faults, retry_budget=retry_budget)
        rr = runtime.run(trace, max_iterations=max_iterations)
        pre = self.prefill._result(
            xp, rr.requests, rr.n_prefill_iterations, rr.clock, [],
            rr.n_preemptions - rr.n_returns, rr.recompute_tokens, 0, 0)
        dec = self.decode._result(
            xd, rr.requests, rr.n_decode_iterations, rr.clock,
            rr.decode_batch_sizes, rr.n_returns, 0,
            rr.n_swap_outs, rr.n_swap_ins)
        return DisaggSimResult(
            requests=rr.requests,
            prefill=pre,
            decode=dec,
            sim_time=rr.clock,
            n_migrations=rr.n_migrations,
            n_returns=rr.n_returns,
            handoff_bytes=rr.handoff_bytes,
            link_bytes=bridge.link_bytes,
            link_energy=bridge.link_energy,
            link_stall_time=rr.link_stall_time,
            handoff_wait_time=rr.handoff_wait_time,
            migration_queue_peak=rr.migration_queue_peak,
            decode_prefill_slices=rr.decode_prefill_slices,
            handoff_linked_tokens=sum(r.handoff_linked_tokens
                                      for r in rr.requests),
            handoff_moved_tokens=sum(r.handoff_moved_tokens
                                     for r in rr.requests),
        )
