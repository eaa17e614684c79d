"""The executor-agnostic serving loop (DESIGN.md §Serving runtime).

``ServingRuntime`` owns everything the real-execution engine and the
discrete-event simulator used to reimplement privately: timed arrival
injection (open-loop trace replay), idling to the next arrival instead of
raising when the pool drains, per-iteration stepping via the scheduler's
``next_plan``, token timestamping (TTFT pinning across recompute epochs),
preemption/swap accounting, per-token streaming callbacks, and the
no-progress / iteration-cap guards.  ``Engine.run`` and ``Simulator.run``
both delegate here, so the two loops cannot drift and the equivalence
tests compare one loop driving two backends, not two reimplementations.

This is the PyTorch package's copy of the loop: the monolithic
``ServingRuntime``, the two-pool ``DisaggRuntime`` (a prefill pool and a
decode pool under one clock, the KV handed off through a
``HandoffBridge``: ``repro_torch.serving.engine.EngineHandoff`` or the
simulator's ``SimHandoff``), the fault supervision both share, and the
two backends:

  * ``EngineExecutor`` — wraps ``repro_torch.serving.engine.Engine``:
    plans execute on a REAL torch model, token events carry actual token
    ids, and the clock is either the iteration index (deterministic
    replay — the default) or real wall time (``wall=True``: arrivals in
    seconds, the runtime sleeps through idle gaps — open-loop serving and
    the HTTP front-end).
  * ``SimExecutor`` — wraps ``repro_torch.serving.simulator.Simulator``:
    plans are priced by the analytic cost model, token events carry
    ``None`` (there is no model), and the clock advances by modelled
    iteration durations.

Arrival clock semantics: the runtime keeps ONE clock ``t``.  With
``clock="executor"`` (simulator default, engine wall mode) ``t`` advances
by each step's modeled/measured duration and arrival times are in the
executor's time unit (seconds).  With ``clock="iteration"`` (engine
default) ``t`` advances 1.0 per executed iteration and arrival times are
iteration indices — identical across backends by construction, which is
what makes cross-backend trace-replay equivalence exactly testable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Protocol,
                    Sequence, Union)

import numpy as np

from repro_torch.core.base import fold_for_recompute
from repro_torch.core.plan import IterationPlan, Request, RequestState, SubmitSpec
from repro_torch.serving.faults import (FAULT_KINDS, DegradationLadder,
                                  ExecutorCrash, FaultInjector)

if TYPE_CHECKING:  # typing only — runtime must not import its backends
    from repro_torch.core.base import Scheduler

# on_token(req_id, token_or_None, t) — called once per emitted token, in
# emission order, timestamped at the end of the iteration that produced it
TokenCallback = Callable[[int, Optional[int], float], None]


@dataclass(frozen=True)
class TokenEvent:
    """One token emitted by an executor step. ``token`` is the real id on
    the engine, None on the simulator. ``first`` marks tokens produced by
    an emitting prefill slice — the runtime decides whether that is the
    request's TRUE first token or a recompute-epoch continuation."""
    req_id: int
    token: Optional[int]
    first: bool = False


@dataclass
class StepOutcome:
    """What one executed iteration reports back to the loop."""
    duration: float
    events: List[TokenEvent] = field(default_factory=list)
    # engine-level device launches this iteration (embed + packed prefill
    # batches + decode); 0 for analytic backends.  Surfaced so serving
    # harnesses can track dispatch pressure without poking the engine.
    n_dispatches: int = 0


def timestamp_events(sched, events: List[TokenEvent], t_end: float,
                     on_token: Optional[TokenCallback] = None) -> None:
    """THE timestamping rule, shared by the runtime loop and the engine's
    legacy hand-stepping path: tokens become visible at iteration end;
    the first token of a recompute epoch is a CONTINUATION — TTFT stays
    pinned to the original first emission; finish times stamp when the
    scheduler bookkeeping (or an engine-side EOS) has moved the request
    to DONE."""
    for ev in events:
        r = sched.requests[ev.req_id]
        if ev.first and r.first_token_time is None:
            r.first_token_time = t_end
        else:
            r.token_times.append(t_end)
        if r.state == RequestState.DONE and r.finish_time is None:
            r.finish_time = t_end
        if on_token is not None:
            on_token(ev.req_id, ev.token, t_end)


def diagnose_stall(reason: str, pools, *, pending: int = 0, held: int = 0,
                   migrations: int = 0, max_rows: int = 12) -> str:
    """Build the no-progress / failed-drain diagnostic: per-pool queue
    depths, allocator free/in-use/high-water, a per-state census, and a
    bounded per-request table — raised instead of a bare "no progress"
    message so a hang is debuggable from the exception text alone.
    ``pools`` is a sequence of (tag, scheduler) pairs."""
    lines = [reason,
             f"pending_arrivals={pending} held={held} "
             f"migrations_in_flight={migrations}"]
    for tag, s in pools:
        states: Dict[str, int] = {}
        for r in s.requests.values():
            states[r.state.name] = states.get(r.state.name, 0) + 1
        kv = s.kv
        kv_line = "kv=unbounded"
        if kv is not None:
            kv_line = (f"kv free={kv.n_free_pages}/{kv.n_pages} "
                       f"in_use={kv.pages_in_use()} "
                       f"hwm={kv.pages_high_water} "
                       f"host={kv.host_pages_in_use()}/{kv.n_host_pages}")
        lines.append(f"[{tag}] sched={s.name!r} waiting={len(s.waiting)} "
                     f"active={s.n_active} states={states or '{}'} "
                     f"{kv_line}")
        live = [r for r in sorted(s.requests.values(),
                                  key=lambda r: r.req_id)
                if r.state != RequestState.DONE]
        for r in live[:max_rows]:
            lines.append(f"  r{r.req_id} {r.state.name} "
                         f"class={r.slo_class} prompt={r.prompt_len} "
                         f"tokens_done={r.tokens_done} "
                         f"gen={r.n_generated} "
                         f"preempts={r.n_preemptions} swaps={r.n_swaps}")
        if len(live) > max_rows:
            lines.append(f"  ... and {len(live) - max_rows} more")
    return "\n".join(lines)


class Executor(Protocol):
    """Backend protocol: the runtime never touches jax or the cost model
    directly — it schedules, clocks and timestamps; the executor runs."""
    scheduler: "Scheduler"

    def submit(self, spec: SubmitSpec, now: float) -> Request:
        """Create + submit the request for an arriving SubmitSpec (the
        unified ingestion record — trace items convert via
        ``TraceRequest.to_spec``).  A spec without an arrival time is
        stamped at ``now`` in the executor's clock unit."""
        ...

    def execute(self, plan: IterationPlan, now: float) -> StepOutcome:
        """Run one iteration plan; return its duration and token events."""
        ...

    def idle(self, t: float, until: float) -> float:
        """Advance the executor clock from ``t`` to ``until`` with no work
        resident (wall executors sleep); returns the new clock value."""
        ...

    def poll_clock(self, t: float) -> float:
        """The executor's CURRENT clock reading given the loop's last value
        ``t`` — wall executors re-read the monotonic clock (live-feed
        idling advances time without an ``idle`` target), virtual clocks
        return ``t`` unchanged."""
        ...

    def initial_clock(self) -> float:
        """Where this run's clock starts.  The engine's iteration clock
        resumes from its persistent iteration counter so a second run()
        cannot stamp tokens EARLIER than requests submitted after the
        first (TTFT stays positive across incremental submit/run
        cycles); fresh backends start at 0."""
        ...

    def evict(self, req_id: int) -> None:
        """Release the backend's physical state for a resident the
        SCHEDULER just preempted outside a plan (fault recovery): the
        executor-side half of ``Scheduler.preempt``, normally run by
        ``execute`` for ``plan.preempted_ids``.  No-op for analytic
        backends."""
        ...

    def release(self, req_id: int) -> None:
        """Release the backend's physical state for a SHED request (any
        pre-DONE state) — the executor-side mirror of
        ``Scheduler.shed``.  No-op for analytic backends."""
        ...


class SubmitTicket:
    """One live submission in flight through a ``SubmitQueue``: the serving
    loop resolves it (engine thread) when the spec is actually submitted,
    after which ``request`` is the backend's live Request.  ``on_submit``
    fires synchronously IN the serving-loop thread right after submission
    and strictly before any of the request's tokens are emitted — the HTTP
    front-end registers its per-request token stream there, so no token
    can race past an unregistered stream."""

    __slots__ = ("spec", "on_submit", "on_fail", "request", "error", "_done")

    def __init__(self, spec: SubmitSpec,
                 on_submit: Optional[Callable[[Request], None]] = None,
                 on_fail: Optional[Callable[[BaseException], None]] = None):
        self.spec = spec
        self.on_submit = on_submit
        self.on_fail = on_fail
        self.request: Optional[Request] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def _resolve(self, request: Request) -> None:
        self.request = request
        if self.on_submit is not None:
            self.on_submit(request)
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self.error = exc
        if self.on_fail is not None:
            self.on_fail(exc)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Request:
        """Block until the serving loop picked this spec up; re-raise its
        submission error (bad request) in the waiting thread."""
        if not self._done.wait(timeout):
            raise TimeoutError("submission not picked up by serving loop")
        if self.error is not None:
            raise self.error
        return self.request


class SubmitQueue:
    """Thread-safe live-ingestion channel bridging concurrent producers
    (HTTP handler threads / asyncio callbacks) into the single-threaded
    serving loop: producers ``put`` SubmitSpecs, the loop drains them at
    every iteration boundary and blocks on ``wait`` while idle instead of
    spinning.  ``close`` ends the stream — the loop finishes whatever is
    already queued or resident, then returns."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: deque = deque()
        self._wake = threading.Event()
        self._closed = False

    def put(self, spec: SubmitSpec,
            on_submit: Optional[Callable[[Request], None]] = None,
            on_fail: Optional[Callable[[BaseException], None]] = None) \
            -> SubmitTicket:
        ticket = SubmitTicket(spec, on_submit, on_fail)
        with self._lock:
            if self._closed:
                raise RuntimeError("submit queue is closed")
            self._items.append(ticket)
            self._wake.set()
        return ticket

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._wake.set()

    @property
    def backlog(self) -> int:
        return len(self._items)

    @property
    def exhausted(self) -> bool:
        """True once closed AND fully drained — the loop's stop signal."""
        with self._lock:
            return self._closed and not self._items

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until an item arrives or the queue closes (the serving
        loop's idle wakeup).  Returns True if something may be pending."""
        return self._wake.wait(timeout)

    def drain(self) -> List[SubmitTicket]:
        with self._lock:
            items = list(self._items)
            self._items.clear()
            if not self._closed:
                self._wake.clear()
            return items


@dataclass
class RunResult:
    """Backend-agnostic outcome of one ``ServingRuntime.run``. Executors
    layer their own accounting on top (see ``simulator.SimResult``)."""
    requests: List[Request] = field(default_factory=list)
    n_iterations: int = 0
    clock: float = 0.0             # final clock value (sim_time / iterations)
    decode_batch_sizes: List[int] = field(default_factory=list)
    n_preemptions: int = 0
    recompute_tokens: int = 0      # prefill tokens re-run due to preemption
    n_swap_outs: int = 0
    n_swap_ins: int = 0
    n_dispatches: int = 0          # total device launches (engine backends)


class _Supervised:
    """Fault supervision shared by ``ServingRuntime`` and
    ``DisaggRuntime`` (DESIGN.md §Fault tolerance): per-request deadline
    shedding, bounded retry through the existing PREEMPTED/recompute
    machinery (a failed step is just an eviction with a retry budget),
    thread-safe client cancellation, and the graceful-degradation
    ladder.  Every recovery path reuses machinery the equivalence tests
    already pin down, which is why surviving requests' token streams
    stay bit-identical to a fault-free run."""

    # shed reason -> counter attribute (unknown reasons count as
    # disconnects — the catch-all for operator-initiated cancels)
    _SHED_COUNTERS = {"deadline": "n_deadline_sheds",
                      "retries": "n_retry_sheds",
                      "disconnect": "n_disconnect_sheds",
                      "degrade": "n_degrade_sheds"}

    def _init_supervision(self, schedulers, *,
                          faults: Optional[FaultInjector],
                          retry_budget: int,
                          ladder: Optional[DegradationLadder],
                          on_shed) -> None:
        self.faults = faults
        self.retry_budget = retry_budget
        self.ladder = ladder if ladder is not None \
            else DegradationLadder(schedulers)
        self.on_shed = on_shed
        self._cancel_lock = threading.Lock()
        self._cancels: deque = deque()
        self.n_deadline_sheds = 0
        self.n_retry_sheds = 0
        self.n_disconnect_sheds = 0
        self.n_degrade_sheds = 0
        self.n_fault_retries = 0

    # -- client cancellation (any thread) -----------------------------------

    def cancel(self, req_id: int, reason: str = "disconnect") -> None:
        """Request cancellation from ANY thread (the HTTP front-end's
        disconnect handler): queued here, applied at the next iteration
        boundary IN the serving-loop thread — the only place scheduler
        and executor state may be touched.  Unknown or already-finished
        ids are ignored."""
        with self._cancel_lock:
            self._cancels.append((req_id, reason))

    def _drain_cancel_queue(self) -> List:
        if not self._cancels:
            return []
        with self._cancel_lock:
            items = list(self._cancels)
            self._cancels.clear()
        return items

    # -- shedding -----------------------------------------------------------

    def _count_shed(self, reason: str) -> None:
        attr = self._SHED_COUNTERS.get(reason, "n_disconnect_sheds")
        setattr(self, attr, getattr(self, attr) + 1)

    def _shed_request(self, sched, x, rid: int, reason: str,
                      iteration: int) -> None:
        """Shed one request end to end: scheduler side (pages freed, queue
        scrubbed, DONE + shed_reason) plus the executor's physical state
        (slot/stash/host snapshot), then notify ``on_shed`` so front-end
        streams can terminate."""
        r = sched.requests[rid]
        sched.shed(rid, reason)
        release = getattr(x, "release", None)
        if release is not None:
            release(rid)
        self._count_shed(reason)
        if reason in ("deadline", "retries"):
            self.ladder.record_pressure(iteration)
        if self.on_shed is not None:
            self.on_shed(r, reason)

    def _shed_batch_class(self, pools, iteration: int) -> None:
        if not self.ladder.shed_batch:
            return
        for sched, x in pools:
            for rid in [rid for rid, r in sorted(sched.requests.items())
                        if r.state != RequestState.DONE
                        and self.ladder.shed_class(r.slo_class)]:
                self._shed_request(sched, x, rid, "degrade", iteration)

    # -- deadlines ----------------------------------------------------------

    def _deadline_scale(self, x) -> float:
        # wall executors clock in seconds, so deadline_ms really is
        # milliseconds; virtual clocks read it in their own units
        # (iterations on the deterministic clock, modeled seconds on the
        # simulator) — deterministic replay stays deterministic
        return 1e-3 if getattr(x, "wall", False) else 1.0

    @staticmethod
    def _expired(r: Request, now: float, scale: float) -> bool:
        return (r.deadline_ms is not None
                and r.state != RequestState.DONE
                and now >= r.arrival_time + r.deadline_ms * scale)

    def _check_deadlines(self, sched, x, now: float,
                         iteration: int) -> bool:
        scale = self._deadline_scale(x)
        expired = [rid for rid, r in sorted(sched.requests.items())
                   if self._expired(r, now, scale)]
        for rid in expired:
            self._shed_request(sched, x, rid, "deadline", iteration)
        return bool(expired)

    # -- injected faults ----------------------------------------------------

    def _recover_crash(self, sched, x, res, iteration: int) -> None:
        """Executor-step failure: every PREFILL/DECODE resident is evicted
        (latest-arrival-first, so head-requeueing leaves the earliest in
        front) and recovered through the recompute path; a victim over
        its retry budget is shed instead.  SWAPPED residents keep their
        intact host copy — a crash does not touch host memory."""
        victims = sorted((r for r in sched.requests.values()
                          if r.state in (RequestState.PREFILL,
                                         RequestState.DECODE)),
                         key=lambda r: (r.arrival_time, r.req_id),
                         reverse=True)
        evict = getattr(x, "evict", None)
        for r in victims:
            rid = r.req_id
            if r.n_fault_retries >= self.retry_budget:
                self._shed_request(sched, x, rid, "retries", iteration)
                continue
            r.n_fault_retries += 1
            self.n_fault_retries += 1
            sched.preempt(rid)
            if evict is not None:
                evict(rid)
            res.n_preemptions += 1
            res.recompute_tokens += r.prompt_len
        self.ladder.record_pressure(iteration)

    def _fail_swap_dma(self, sched, plan: IterationPlan,
                       iteration: int) -> None:
        """swap_dma_fail: this iteration's swap-out DMA batch failed —
        demote the victims to recompute evictions BEFORE the executor
        runs, so the engine releases their slots via the preempt path
        instead of snapshotting dead data to host.  Armed until an
        iteration with swap activity."""
        if self.faults is None or not plan.swapped_out_ids:
            return
        if not self.faults.due("swap_dma_fail", iteration):
            return
        for rid in list(plan.swapped_out_ids):
            sched.fail_swap_out(rid)
            plan.preempted_ids.append(rid)
        plan.swapped_out_ids.clear()
        self.ladder.record_pressure(iteration)

    def _inject_disconnects(self, pools, iteration: int) -> bool:
        """client_disconnect: shed the ``target``-th live request (rid
        order) as if its SSE peer vanished mid-stream."""
        if self.faults is None:
            return False
        live = [(sched, x, rid)
                for sched, x in pools
                for rid, r in sorted(sched.requests.items())
                if r.state != RequestState.DONE]
        if not live:
            return False
        acted = False
        for ev in self.faults.due("client_disconnect", iteration):
            if not live:
                break
            sched, x, rid = live.pop(ev.target % len(live))
            self._shed_request(sched, x, rid, "disconnect", iteration)
            acted = True
        return acted

    # -- metrics ------------------------------------------------------------

    def fault_stats(self) -> Dict[str, float]:
        """Counter snapshot shaped as ``metrics.fault_counters`` kwargs —
        the one schema the /metrics endpoint, offline reports, and the CI
        chaos gate all read."""
        c = dict(self.faults.counters) if self.faults is not None \
            else {f"n_{k}": 0 for k in FAULT_KINDS}
        return {
            "n_injected_faults": float(sum(c.values())),
            "n_executor_crashes": c["n_executor_crash"],
            "n_link_drops": c["n_link_drop"],
            "n_link_delays": c["n_link_delay"],
            "n_swap_dma_fails": c["n_swap_dma_fail"],
            "n_pressure_spikes": c["n_pressure_spike"],
            "n_injected_disconnects": c["n_client_disconnect"],
            "n_deadline_sheds": self.n_deadline_sheds,
            "n_retry_sheds": self.n_retry_sheds,
            "n_disconnect_sheds": self.n_disconnect_sheds,
            "n_degrade_sheds": self.n_degrade_sheds,
            "n_fault_retries": self.n_fault_retries,
            "degradation_level": self.ladder.level_index,
            "n_degradation_escalations": self.ladder.n_escalations,
            "n_degradation_deescalations": self.ladder.n_deescalations,
        }


class ServingRuntime(_Supervised):
    def __init__(self, executor: Executor, *,
                 on_token: Optional[TokenCallback] = None,
                 clock: str = "executor",
                 record_plans: bool = False,
                 faults: Optional[FaultInjector] = None,
                 retry_budget: int = 3,
                 ladder: Optional[DegradationLadder] = None,
                 on_shed: Optional[Callable[[Request, str], None]] = None):
        """``faults`` attaches a deterministic fault injector (see
        serving/faults.py); ``retry_budget`` bounds per-request crash
        recoveries before the victim is shed; ``on_shed(req, reason)``
        fires in the serving-loop thread whenever a request is removed
        without completing (deadline, retries, disconnect, degrade)."""
        if clock not in ("executor", "iteration"):
            raise ValueError(f"unknown clock {clock!r}")
        self.executor = executor
        self.on_token = on_token
        self.clock = clock
        self.record_plans = record_plans
        self.plans: List[IterationPlan] = []
        self._init_supervision([executor.scheduler], faults=faults,
                               retry_budget=retry_budget, ladder=ladder,
                               on_shed=on_shed)

    def _supervise(self, sched, x, res, t: float, it: int) -> bool:
        """One pre-plan supervision pass: queued cancels, deadline sheds,
        injected faults (allocator pressure, executor crash, client
        disconnects), then the degradation ladder.  Runs BEFORE
        ``next_plan`` so every recovery is a plain eviction — no plan
        bookkeeping has advanced against state that never executed.
        Returns True when the pass consumed all resident work."""
        for rid, reason in self._drain_cancel_queue():
            r = sched.requests.get(rid)
            if r is not None and r.state != RequestState.DONE:
                self._shed_request(sched, x, rid, reason, it)
        self._check_deadlines(sched, x, t, it)
        f = self.faults
        if f is not None:
            f.release_pressure(it)
            f.apply_pressure([sched.kv], it)
            try:
                f.maybe_crash(it, active=sched.n_active > 0)
            except ExecutorCrash:
                self._recover_crash(sched, x, res, it)
            self._inject_disconnects([(sched, x)], it)
        self.ladder.step(it)
        self._shed_batch_class([(sched, x)], it)
        return not sched.has_work()

    def run(self, trace: Sequence[Union["TraceRequest", SubmitSpec]] = (),
            max_iterations: int = 10_000, *,
            feed: Optional[SubmitQueue] = None,
            idle_poll: float = 0.05) -> RunResult:
        """Replay ``trace`` open-loop (requests injected at their arrival
        times; the loop idles to the next arrival when the pool drains)
        and drain everything already submitted to the scheduler.  An empty
        trace is the closed-loop drain the engine's legacy ``run`` was.

        ``feed`` attaches a live ``SubmitQueue``: specs arriving from
        other threads are injected at every iteration boundary (arrival
        stamped at the current clock when the spec carries none), and when
        the pool drains the loop BLOCKS on the queue (granularity
        ``idle_poll`` seconds) instead of exiting — the serving loop of
        the HTTP front-end.  The run returns once the feed is closed and
        drained and no work remains."""
        x = self.executor
        sched = x.scheduler
        res = RunResult(
            # closed-loop requests submitted before run() — id order
            requests=[sched.requests[k] for k in sorted(sched.requests)])
        pending = sorted(trace, key=lambda tr: tr.arrival_time)
        i_arr = 0
        t = float(x.initial_clock())

        def inject(now: float) -> None:
            nonlocal i_arr
            while i_arr < len(pending) \
                    and pending[i_arr].arrival_time <= now:
                tr = pending[i_arr]
                spec = tr.to_spec() if hasattr(tr, "to_spec") else tr
                res.requests.append(x.submit(spec, now))
                i_arr += 1
            if feed is not None:
                for ticket in feed.drain():
                    try:
                        req = x.submit(ticket.spec, now)
                    except Exception as e:     # bad spec: report, keep going
                        ticket._fail(e)
                        continue
                    res.requests.append(req)
                    ticket._resolve(req)

        def live() -> bool:
            return feed is not None and not feed.exhausted

        while i_arr < len(pending) or sched.has_work() or live():
            inject(t)
            if not sched.has_work():
                if live():
                    # live idle: block on the feed (bounded so wall clocks
                    # stay responsive to close/shutdown), then re-read the
                    # executor clock — arrivals are stamped at real idle
                    # time, not at the last iteration's end
                    feed.wait(idle_poll)
                    t = max(t, x.poll_clock(t))
                    continue
                if i_arr >= len(pending):
                    break          # feed closed + drained, nothing pending
                # open-loop idle: fast-forward (or, on a wall clock, sleep)
                # to the next arrival instead of raising "did not drain"
                nxt = pending[i_arr].arrival_time
                t = nxt if self.clock == "iteration" else x.idle(t, nxt)
                inject(t)
            if res.n_iterations >= max_iterations:
                raise RuntimeError(diagnose_stall(
                    f"did not drain within {max_iterations} iterations; "
                    "scheduler stuck?", [("pool", sched)],
                    pending=len(pending) - i_arr))
            if self._supervise(sched, x, res, t, res.n_iterations):
                continue       # supervision consumed all resident work
            plan = sched.next_plan(now=t)
            self._fail_swap_dma(sched, plan, res.n_iterations)
            if self.record_plans:
                self.plans.append(plan)
            res.n_preemptions += len(plan.preempted_ids)
            res.recompute_tokens += sum(
                sched.requests[rid].prompt_len
                for rid in plan.preempted_ids)
            res.n_swap_outs += len(plan.swapped_out_ids)
            res.n_swap_ins += len(plan.swapped_in_ids)
            if plan.empty:
                if i_arr < len(pending):
                    # nothing runnable yet — fast-forward to the arrival
                    # that will create work (t never moves backwards)
                    t = max(t, pending[i_arr].arrival_time)
                    continue
                # no runnable work, no future arrivals: advancing neither
                # t nor the iteration count would spin forever
                raise RuntimeError(diagnose_stall(
                    f"scheduler {sched.name!r} made no progress at t={t}: "
                    "no pending arrivals and the next plan is empty",
                    [("pool", sched)]))
            outcome = x.execute(plan, t)
            res.n_iterations += 1
            res.n_dispatches += outcome.n_dispatches
            res.decode_batch_sizes.append(len(plan.decode_ids))
            t_end = t + (1.0 if self.clock == "iteration"
                         else outcome.duration)
            timestamp_events(sched, outcome.events, t_end, self.on_token)
            t = t_end

        if self.faults is not None:
            self.faults.release_pressure(None)   # zero-leak: no phantom
        res.clock = t                            # reservation survives a run
        return res


@dataclass
class Migration:
    """One prefill→decode handoff in flight: the migrating Request, a
    backend-opaque payload (KV export + physical state), and the link
    timeline — ``ready_time`` is when the last KV byte lands on the decode
    side (== ``export_time`` plus the residual transfer the remaining
    prefill compute could not hide; equal to ``export_time`` on the engine,
    whose chunks were host-staged through the per-iteration fetch)."""
    req: Request
    payload: object
    export_time: float
    ready_time: float
    n_chunks: int = 0
    bytes_total: float = 0.0


class HandoffBridge(Protocol):
    """Backend-specific mechanics of the prefill→decode KV handoff; the
    ``DisaggRuntime`` decides WHEN to stage/export/import, the bridge knows
    HOW (engine: host-staged cache rows; simulator: priced link FIFO)."""

    def decode_free_pages(self) -> int:
        """Free pages on the decode pool's allocator (watermark signal)."""
        ...

    def stage(self, plan: IterationPlan, requests: Dict[int, Request],
              t_end: float, duration: float) -> None:
        """Observe one executed prefill-pool plan: layer groups whose KV
        completed this iteration enter the per-request handoff stream
        (simulator link model; the engine stages inside execute_plan)."""
        ...

    def export(self, req: Request, now: float) -> Migration:
        """Pull the migrating request's KV/state off the prefill backend
        (the scheduler has already ``pop_request``-ed it)."""
        ...

    def can_import(self, m: Migration) -> bool:
        """True iff the decode backend can take the payload right now."""
        ...

    def do_import(self, m: Migration, now: float) -> Dict[str, int]:
        """Install the payload on the decode backend; returns the
        ``{"linked_tokens", "moved_tokens"}`` split (pages already warm on
        the decode pool link for free — KV-locality routing's win)."""
        ...

    def drop(self, req_id: int) -> None:
        """A prefill-pool preemption voided any staged chunks."""
        ...

    def abort_export(self, m: Migration) -> None:
        """A link failure lost migration ``m`` in flight: reinstall the
        victim's backend state on the prefill side so a whole-prompt
        recompute retry can run (the KV payload itself died with the
        link — export's move semantics already freed it, nothing
        leaks)."""
        ...

    def return_to_prefill(self, req: Request) -> None:
        """Move a decode-pool recompute victim's backend state (prompt /
        output buffers) back to the prefill backend before readmission."""
        ...


@dataclass
class DisaggRunResult(RunResult):
    """``RunResult`` plus the two-pool accounting: per-pool iteration
    counts, migration/handoff traffic, and the link-stall totals.
    ``decode_prefill_slices`` MUST stay 0 — the decode pool's iteration
    clock never contains prefill work (its TBT is prefill-free by
    construction; the CI gate asserts the counter)."""
    n_prefill_iterations: int = 0
    n_decode_iterations: int = 0
    n_migrations: int = 0
    n_returns: int = 0             # recompute victims routed back to prefill
    handoff_bytes: float = 0.0     # payload bytes that crossed the link
    link_stall_time: float = 0.0   # export→ready residual (unhidden) time
    handoff_wait_time: float = 0.0  # export→import total (stall + capacity)
    migration_queue_peak: int = 0
    held_peak: int = 0             # watermark-backpressured arrivals
    decode_prefill_slices: int = 0


class DisaggRuntime(_Supervised):
    """Two-pool disaggregated serving loop (DESIGN.md §Disaggregated
    serving): a prefill executor and a decode executor advance under ONE
    runtime clock.  Requests are admitted and prefilled on the prefill
    pool; as each layer group's KV completes it streams toward the decode
    pool (bridge-managed), and when the final group emits the first token
    the request is exported, crosses the link, and is ``adopt``-ed by the
    decode pool, which runs decode-only iterations forever after.  Decode-
    pool recompute victims fold and route BACK to the prefill pool (the
    decode pool cannot prefill); swap victims restore locally.

    Clock semantics mirror ``ServingRuntime``: ``clock="iteration"``
    advances both pools in lockstep 1.0 per iteration (deterministic
    engine replay — token streams bit-identical to monolithic serving);
    ``clock="executor"`` gives each pool its own event-driven ready time,
    so decode-pool timestamps contain ONLY decode durations — the
    prefill-free-TBT property the paper's disaggregation argument needs.

    ``decode_watermark_pages`` backpressures admission: new arrivals are
    HELD (not submitted to the prefill pool) while the decode pool's free
    pages sit below the watermark, so prefill work whose handoff would
    have nowhere to land is never started."""

    def __init__(self, prefill: Executor, decode: Executor,
                 bridge: HandoffBridge, *,
                 on_token: Optional[TokenCallback] = None,
                 clock: str = "executor",
                 decode_watermark_pages: int = 0,
                 record_plans: bool = False,
                 faults: Optional[FaultInjector] = None,
                 retry_budget: int = 3,
                 ladder: Optional[DegradationLadder] = None,
                 on_shed: Optional[Callable[[Request, str], None]] = None):
        if clock not in ("executor", "iteration"):
            raise ValueError(f"unknown clock {clock!r}")
        self.prefill = prefill
        self.decode = decode
        self.bridge = bridge
        self.on_token = on_token
        self.clock = clock
        self.decode_watermark_pages = decode_watermark_pages
        self.record_plans = record_plans
        self.plans: List = []          # (pool_tag, IterationPlan)
        self._init_supervision([prefill.scheduler, decode.scheduler],
                               faults=faults, retry_budget=retry_budget,
                               ladder=ladder, on_shed=on_shed)

    # -- disagg-specific supervision ----------------------------------------

    def _shed_request(self, sched, x, rid: int, reason: str,
                      iteration: int) -> None:
        _Supervised._shed_request(self, sched, x, rid, reason, iteration)
        self.bridge.drop(rid)      # staged handoff chunks die with it

    def _shed_migration(self, m: Migration, reason: str,
                        iteration: int) -> None:
        """Shed a request caught mid-migration: its KV pages were already
        freed from the prefill pool by the export's move semantics and
        never landed on the decode pool, so discarding the payload leaks
        nothing — only the control record needs retiring."""
        r = m.req
        r.state = RequestState.DONE
        r.shed_reason = reason
        self._count_shed(reason)
        if reason in ("deadline", "retries"):
            self.ladder.record_pressure(iteration)
        if self.on_shed is not None:
            self.on_shed(r, reason)

    def _drop_migration(self, m: Migration, res, iteration: int) -> None:
        """link_drop recovery: the payload is lost in flight, but the
        request is NEVER lost — it folds for recompute and re-enters the
        prefill pool's queue at the head (whole-prompt retry).  Victims
        over their retry budget are shed instead."""
        req = m.req
        if req.n_fault_retries >= self.retry_budget:
            self._shed_migration(m, "retries", iteration)
            return
        req.n_fault_retries += 1
        self.n_fault_retries += 1
        fold_for_recompute(req)
        abort = getattr(self.bridge, "abort_export", None)
        if abort is not None:
            abort(m)
        sp = self.prefill.scheduler
        sp.readmit(req)
        sp.n_preemptions += 1
        res.n_preemptions += 1
        res.recompute_tokens += req.prompt_len
        self.ladder.record_pressure(iteration)

    def _recover_decode_crash(self, res, iteration: int) -> None:
        """Decode-pool executor crash: recompute victims cannot re-prefill
        locally (the decode pool never plans prefill), so each one folds
        and routes BACK to the prefill pool — exactly the plan-level
        recompute-victim return path.  SWAPPED residents keep their host
        copy and restore locally."""
        sp, sd = self.prefill.scheduler, self.decode.scheduler
        xd, bridge = self.decode, self.bridge
        victims = sorted((r for r in sd.requests.values()
                          if r.state == RequestState.DECODE),
                         key=lambda r: (r.arrival_time, r.req_id),
                         reverse=True)
        evict = getattr(xd, "evict", None)
        for r in victims:
            rid = r.req_id
            if r.n_fault_retries >= self.retry_budget:
                self._shed_request(sd, xd, rid, "retries", iteration)
                continue
            r.n_fault_retries += 1
            self.n_fault_retries += 1
            sd.preempt(rid)
            if evict is not None:
                evict(rid)
            req = sd.pop_request(rid)
            bridge.return_to_prefill(req)
            sp.readmit(req)
            res.n_returns += 1
            res.n_preemptions += 1
            res.recompute_tokens += req.prompt_len
        self.ladder.record_pressure(iteration)

    def _supervise(self, migr: deque, held: deque, res, t: float,
                   it: int) -> bool:
        """Pre-step supervision over BOTH pools, the link queue, and the
        backpressure-held arrivals.  Returns True when it changed pool
        state (the caller resets the stall latches)."""
        sp, sd = self.prefill.scheduler, self.decode.scheduler
        xp, xd = self.prefill, self.decode
        acted = False
        # queued client cancels: the victim may live on either pool or be
        # mid-migration on the link
        for rid, reason in self._drain_cancel_queue():
            shed = False
            for sched, x in ((sp, xp), (sd, xd)):
                r = sched.requests.get(rid)
                if r is not None and r.state != RequestState.DONE:
                    self._shed_request(sched, x, rid, reason, it)
                    shed = acted = True
                    break
            if not shed:
                for m in list(migr):
                    if m.req.req_id == rid:
                        migr.remove(m)
                        self._shed_migration(m, reason, it)
                        acted = True
                        break
        # deadlines: both pools, in-flight migrations, held arrivals
        for sched, x in ((sp, xp), (sd, xd)):
            acted |= self._check_deadlines(sched, x, t, it)
        scale = self._deadline_scale(xp)
        for m in [m for m in migr if self._expired(m.req, t, scale)]:
            migr.remove(m)
            self._shed_migration(m, "deadline", it)
            acted = True
        for item in [h for h in held
                     if getattr(h[0], "deadline_ms", None) is not None
                     and getattr(h[0], "arrival_time", None) is not None
                     and t >= h[0].arrival_time
                     + h[0].deadline_ms * scale]:
            held.remove(item)
            _, ticket = item
            self.n_deadline_sheds += 1
            self.ladder.record_pressure(it)
            if ticket is not None:
                ticket._fail(TimeoutError(
                    "deadline expired before admission"))
            acted = True
        f = self.faults
        if f is not None:
            f.release_pressure(it)
            f.apply_pressure([sp.kv, sd.kv], it)
            if migr:
                # latency spike: queued payloads land late — the import
                # gate re-reads ready_time, token values never change
                for ev in f.due("link_delay", it):
                    for m in migr:
                        m.ready_time += ev.magnitude
                for ev in f.due("link_drop", it):
                    if not migr:
                        break
                    m = migr[ev.target % len(migr)]
                    migr.remove(m)
                    self._drop_migration(m, res, it)
                    acted = True
            try:
                f.maybe_crash(it, pool=0, active=sp.n_active > 0)
            except ExecutorCrash:
                self._recover_crash(sp, xp, res, it)
                for rid, r in sp.requests.items():
                    if r.state == RequestState.PREEMPTED:
                        self.bridge.drop(rid)   # staged KV is void
                acted = True
            try:
                f.maybe_crash(it, pool=1, active=sd.n_active > 0)
            except ExecutorCrash:
                self._recover_decode_crash(res, it)
                acted = True
            acted |= self._inject_disconnects([(sp, xp), (sd, xd)], it)
        self.ladder.step(it)
        before = self.n_degrade_sheds
        self._shed_batch_class([(sp, xp), (sd, xd)], it)
        acted |= self.n_degrade_sheds != before
        return acted

    def run(self, trace: Sequence[Union["TraceRequest", SubmitSpec]] = (),
            max_iterations: int = 10_000, *,
            feed: Optional[SubmitQueue] = None,
            idle_poll: float = 0.05) -> DisaggRunResult:
        xp, xd, bridge = self.prefill, self.decode, self.bridge
        sp, sd = xp.scheduler, xd.scheduler
        step = self.clock == "iteration"
        res = DisaggRunResult(
            requests=[sp.requests[k] for k in sorted(sp.requests)])
        pending = sorted(trace, key=lambda tr: tr.arrival_time)
        i_arr = 0
        t = max(float(xp.initial_clock()), float(xd.initial_clock()))
        rp = rd = t                    # per-pool next-ready clocks
        held: deque = deque()          # (spec, ticket|None) backpressured
        migr: deque = deque()          # Migration FIFO (link order)
        # a pool whose last attempt produced an empty plan is stalled until
        # some OTHER event (arrival, import, return, other-pool iteration)
        # can change its state — re-planning the same state would spin
        stall_p = stall_d = False

        def live() -> bool:
            return feed is not None and not feed.exhausted

        def inject(now: float) -> bool:
            nonlocal i_arr
            n0 = len(held)
            while i_arr < len(pending) \
                    and pending[i_arr].arrival_time <= now:
                held.append((pending[i_arr], None))
                i_arr += 1
            if feed is not None:
                for ticket in feed.drain():
                    held.append((ticket.spec, ticket))
            res.held_peak = max(res.held_peak, len(held))
            return len(held) > n0

        def admit_held(now: float) -> bool:
            n = 0
            while held:
                if self.decode_watermark_pages > 0 \
                        and bridge.decode_free_pages() \
                        < self.decode_watermark_pages:
                    break              # decode pool must drain first
                item, ticket = held.popleft()
                spec = item.to_spec() if hasattr(item, "to_spec") else item
                try:
                    req = xp.submit(spec, now)
                except Exception as e:
                    if ticket is None:
                        raise
                    ticket._fail(e)
                    continue
                res.requests.append(req)
                if ticket is not None:
                    ticket._resolve(req)
                n += 1
            return n > 0

        def attempt_imports(now: float) -> bool:
            n = 0
            while migr and migr[0].ready_time <= now:
                m = migr[0]
                if not (sd.can_adopt(m.req) and bridge.can_import(m)):
                    if not sd.has_work():
                        raise RuntimeError(diagnose_stall(
                            f"decode pool can never import request "
                            f"{m.req.req_id} — enlarge the decode pool",
                            [("prefill", sp), ("decode", sd)],
                            pending=len(pending) - i_arr,
                            held=len(held), migrations=len(migr)))
                    break              # FIFO: wait for the decode pool
                migr.popleft()
                info = bridge.do_import(m, now)
                sd.adopt(m.req)
                m.req.n_handoffs += 1
                m.req.handoff_linked_tokens += info.get("linked_tokens", 0)
                m.req.handoff_moved_tokens += info.get("moved_tokens", 0)
                m.req.handoff_time = now
                res.handoff_wait_time += now - m.export_time
                res.n_migrations += 1
                n += 1
            return n > 0

        while i_arr < len(pending) or held or migr \
                or sp.has_work() or sd.has_work() or live():
            acted = inject(t)
            acted |= admit_held(t)
            acted |= attempt_imports(t)
            acted |= self._supervise(migr, held, res, t, res.n_iterations)
            if acted:
                stall_p = stall_d = False

            executed = False
            if sp.has_work() and rp <= t and not stall_p:
                plan = sp.next_plan(now=t)
                self._fail_swap_dma(sp, plan, res.n_iterations)
                if plan.empty:
                    stall_p = True
                else:
                    if self.record_plans:
                        self.plans.append(("prefill", plan))
                    for rid in plan.preempted_ids:
                        bridge.drop(rid)
                    res.n_preemptions += len(plan.preempted_ids)
                    res.recompute_tokens += sum(
                        sp.requests[rid].prompt_len
                        for rid in plan.preempted_ids)
                    res.n_swap_outs += len(plan.swapped_out_ids)
                    res.n_swap_ins += len(plan.swapped_in_ids)
                    outcome = xp.execute(plan, t)
                    dur = 1.0 if step else outcome.duration
                    t_end = t + dur
                    bridge.stage(plan, sp.requests, t_end, dur)
                    timestamp_events(sp, outcome.events, t_end,
                                     self.on_token)
                    res.n_iterations += 1
                    res.n_prefill_iterations += 1
                    res.n_dispatches += outcome.n_dispatches
                    rp = t_end
                    # completed prefills migrate NOW: the pool is pure
                    # prefill — first-token emitters leave for the decode
                    # pool the moment their last layer group finishes
                    for rid in sorted(
                            r.req_id for r in sp.requests.values()
                            if r.state == RequestState.DECODE):
                        req = sp.pop_request(rid)
                        m = bridge.export(req, t_end)
                        req.n_handoff_chunks += m.n_chunks
                        res.handoff_bytes += m.bytes_total
                        res.link_stall_time += max(
                            0.0, m.ready_time - m.export_time)
                        migr.append(m)
                    res.migration_queue_peak = max(
                        res.migration_queue_peak, len(migr))
                    executed = True
                    stall_d = False

            if sd.has_work() and rd <= t and not stall_d:
                plan = sd.next_plan(now=t)
                self._fail_swap_dma(sd, plan, res.n_iterations)
                if plan.empty:
                    stall_d = True
                else:
                    if self.record_plans:
                        self.plans.append(("decode", plan))
                    res.decode_prefill_slices += len(plan.prefill)
                    res.n_swap_outs += len(plan.swapped_out_ids)
                    res.n_swap_ins += len(plan.swapped_in_ids)
                    outcome = xd.execute(plan, t)
                    dur = 1.0 if step else outcome.duration
                    t_end = t + dur
                    timestamp_events(sd, outcome.events, t_end,
                                     self.on_token)
                    res.n_iterations += 1
                    res.n_decode_iterations += 1
                    res.n_dispatches += outcome.n_dispatches
                    res.decode_batch_sizes.append(len(plan.decode_ids))
                    rd = t_end
                    # fold-to-recompute victims route back to the prefill
                    # pool (this pool cannot prefill); swap victims stay —
                    # they restore locally via _readmit_swapped
                    for rid in plan.preempted_ids:
                        req = sd.pop_request(rid)
                        bridge.return_to_prefill(req)
                        sp.readmit(req)
                        res.n_returns += 1
                        res.n_preemptions += 1
                        res.recompute_tokens += req.prompt_len
                    executed = True
                    stall_p = False

            if res.n_iterations > max_iterations:
                raise RuntimeError(diagnose_stall(
                    f"did not drain within {max_iterations} iterations; "
                    "scheduler stuck?", [("prefill", sp), ("decode", sd)],
                    pending=len(pending) - i_arr, held=len(held),
                    migrations=len(migr)))
            if executed or acted:
                continue
            # nothing ran at t: advance to the next event
            if live():
                feed.wait(idle_poll)
                t = max(t, xp.poll_clock(t))
                continue
            nxt = []
            if sp.has_work() and not stall_p:
                nxt.append(rp)
            if sd.has_work() and not stall_d:
                nxt.append(rd)
            if i_arr < len(pending):
                nxt.append(pending[i_arr].arrival_time)
            if migr:
                nxt.append(migr[0].ready_time)
            nxt = [x for x in nxt if x > t]
            if not nxt:
                raise RuntimeError(diagnose_stall(
                    f"disaggregated loop made no progress at t={t}: "
                    "no pool can step and no future event exists",
                    [("prefill", sp), ("decode", sd)],
                    pending=len(pending) - i_arr, held=len(held),
                    migrations=len(migr)))
            t = min(nxt)

        if self.faults is not None:
            self.faults.release_pressure(None)   # zero-leak at drain
        res.clock = max(t, rp, rd)
        return res


class EngineExecutor:
    """Real-execution backend: wraps ``serving.engine.Engine``.

    ``wall=False`` (default): each iteration advances the clock by 1.0 —
    pair with ``ServingRuntime(clock="iteration")`` for deterministic
    replay where trace arrival times are iteration indices.  ``wall=True``:
    durations are measured wall seconds and idle really sleeps — pair with
    ``clock="executor"`` for open-loop serving against wall-clock arrival
    times."""

    def __init__(self, engine, *, wall: bool = False):
        self.engine = engine
        self.scheduler = engine.scheduler
        self.wall = wall
        self._t0 = time.monotonic()      # re-anchored by initial_clock()

    def submit(self, spec: SubmitSpec, now: float) -> Request:
        if spec.arrival_time is None:
            spec = dataclasses.replace(spec, arrival_time=now)
        return self.engine.submit_spec(spec)

    def execute(self, plan: IterationPlan, now: float) -> StepOutcome:
        before = self.engine.n_dispatches
        events = self.engine.execute_plan(plan)
        # wall durations are ABSOLUTE elapsed minus the loop clock, so
        # scheduling/streaming overhead between steps is charged too and
        # the pacing cannot drift behind the trace's real-second schedule
        dur = max(0.0, time.monotonic() - self._t0 - now) if self.wall \
            else 1.0
        return StepOutcome(duration=dur, events=events,
                           n_dispatches=self.engine.n_dispatches - before)

    def idle(self, t: float, until: float) -> float:
        if not self.wall:
            return until
        # wall clock: wait until the ABSOLUTE arrival deadline (chunked
        # so huge gaps in a mis-scaled trace stay interruptible); if the
        # loop is already past it, no sleep happens at all
        deadline = self._t0 + until
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(remaining, 0.05))
        return time.monotonic() - self._t0

    def evict(self, req_id: int) -> None:
        # fault recovery: the scheduler already ran its preempt fold; this
        # is the engine-side half a plan's preempted_ids would have run
        self.engine._preempt(req_id)

    def release(self, req_id: int) -> None:
        self.engine.release_request(req_id)

    def poll_clock(self, t: float) -> float:
        return time.monotonic() - self._t0 if self.wall else t

    def initial_clock(self) -> float:
        # the iteration clock resumes from the engine's persistent
        # counter, matching requests' iteration-stamped arrival times
        # across incremental submit/run cycles; wall runs re-anchor to
        # now (arrival times are seconds since run start)
        if self.wall:
            self._t0 = time.monotonic()
            return 0.0
        return float(self.engine.iteration)


class SimExecutor:
    """Analytic backend: wraps ``serving.simulator.Simulator``. Iteration
    durations come from the cost model; swap DMA is charged as overlappable
    with the iteration's compute (``stall = max(0, dma - compute)``) unless
    the simulator was built with ``swap_overlap=False`` (the PR-3 serial
    model, kept for comparison).  Accumulates the energy/traffic totals
    that ``Simulator.run`` folds into its ``SimResult``."""

    def __init__(self, sim):
        self.sim = sim
        self.scheduler = sim.scheduler
        self._next_id = 0
        self.total_energy = 0.0
        self.total_expert_bytes = 0.0
        self.total_hbm_bytes = 0.0
        self.total_flops = 0.0
        self.swap_bytes = 0.0
        self.swap_dma_time = 0.0       # host-link busy time, both directions
        self.swap_stall_time = 0.0     # the part compute could not hide
        self.total_drafted = 0         # speculative decode accounting
        self.total_accepted = 0

    def submit(self, spec: SubmitSpec, now: float) -> Request:
        # prompt_tokens (when the spec carries them) make the analytic
        # backend prefix-cache-aware: the shared scheduler code hashes and
        # matches exactly as it does under the engine, so cross-backend
        # plan streams stay identical with caching enabled
        req = Request.from_spec(
            spec, self._next_id,
            arrival_time=now if spec.arrival_time is None
            else spec.arrival_time,
            prompt_tokens=None if spec.prompt_tokens is None
            else np.asarray(spec.prompt_tokens, np.int32))
        self._next_id += 1
        self.scheduler.submit(req)
        return req

    def execute(self, plan: IterationPlan, now: float) -> StepOutcome:
        sim = self.sim
        dma = 0.0
        if plan.swapped_out_ids or plan.swapped_in_ids:
            # swap DMA: tokens that actually crossed the host link (shared
            # prefix pages stay pinned in HBM and move in neither direction)
            moved = sum(sim.kv.last_swap_tokens(rid) for rid in
                        plan.swapped_out_ids + plan.swapped_in_ids)
            xfer = sim.cost.swap_transfer(moved)
            dma = xfer["duration"]
            self.swap_dma_time += dma
            self.swap_bytes += xfer["bytes"]
            self.total_energy += xfer["energy"]
        cost = sim.cost.iteration_cost(plan, self.scheduler.requests)
        self.total_energy += cost["energy"]
        self.total_expert_bytes += cost["expert_bytes"]
        self.total_hbm_bytes += cost["hbm_bytes"]
        self.total_flops += cost["flops"]
        # the DMA engines run asynchronously to compute: only the excess
        # past the iteration's compute stalls the clock (serial flag
        # charges the whole transfer, the PR-3 model)
        stall = dma if not sim.swap_overlap \
            else max(0.0, dma - cost["duration"])
        self.swap_stall_time += stall
        events = [TokenEvent(sl.req_id, None, first=True)
                  for sl in plan.prefill if sl.emits_first_token]
        events += [TokenEvent(rid, None) for rid in plan.decode_ids]
        # speculative verify-k: analytic acceptance — a run of consecutive
        # Bernoulli(spec_acceptance) successes capped at the budget (the
        # simulator has no tokens to verify); deterministic given the
        # simulator's seed and the sorted commit order.  Priced above via
        # plan.verify_len; committed here AFTER pricing so the cost sees
        # pre-commit context lengths, like the engine.
        for rid in sorted(plan.verify_len):
            k = plan.verify_len[rid]
            a = sim.draw_accepted(k)
            self.total_drafted += k
            self.total_accepted += a
            self.scheduler.commit_speculation(rid, proposed=k, accepted=a,
                                              extra=a)
            events += [TokenEvent(rid, None)] * a
        return StepOutcome(duration=cost["duration"] + stall, events=events)

    def idle(self, t: float, until: float) -> float:
        return until

    def evict(self, req_id: int) -> None:
        pass    # analytic backend: no per-request physical state to drop

    def release(self, req_id: int) -> None:
        pass

    def poll_clock(self, t: float) -> float:
        return t

    def initial_clock(self) -> float:
        return 0.0
