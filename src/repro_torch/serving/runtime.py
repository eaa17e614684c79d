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

This is the PyTorch package's copy of the loop.  It keeps the monolithic
``ServingRuntime`` and its one backend, ``EngineExecutor``, which wraps
``repro_torch.serving.engine.Engine``: plans execute on a REAL torch
model, token events carry actual token ids, and the clock is either the
iteration index (deterministic replay — the default) or real wall time
(``wall=True``: arrivals in seconds, the runtime sleeps through idle
gaps — open-loop serving).  The two-pool runtime and the simulator
backend are not part of this package yet.

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

