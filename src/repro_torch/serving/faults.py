"""Deterministic fault injection + graceful degradation for the serving
stack (DESIGN.md §Fault tolerance).

A ``FaultPlan`` is a seeded, replayable schedule of failure events — the
chaos-side mirror of the seeded traffic generators in
``serving/traffic.py``: same plan, same trace, same tokens.  The
``FaultInjector`` consumes the plan one iteration at a time; the serving
runtimes poll it at well-defined points in the loop and translate each
event into the recovery machinery that already exists (eviction +
recompute, swap demotion, migration re-routing), so every injected fault
exercises a path a real fault would take.

Fault taxonomy (``FaultEvent.kind``):

  executor_crash    — the executor step raises: every PREFILL/DECODE
                      resident is evicted and recovered by recompute
                      (SWAPPED victims keep their host copy).  In the
                      disaggregated runtime ``target`` picks the pool
                      (0 = prefill, 1 = decode).
  link_drop         — a queued inter-pool migration's payload is lost;
                      the victim is folded and re-queued on the prefill
                      pool (whole-prompt retry) — never lost.
  link_delay        — a latency spike: ``magnitude`` is added to every
                      queued migration's ready_time.
  swap_dma_fail     — this iteration's swap-out DMA fails; the victims
                      demote to recompute evictions
                      (``Scheduler.fail_swap_out``).
  pressure_spike    — ``magnitude`` pages are phantom-reserved for
                      ``duration`` iterations, forcing the allocator
                      pressure/eviction path under an otherwise-fitting
                      load.
  client_disconnect — the ``target``-th lowest live request id is
                      cancelled mid-stream (the runtime sheds it and
                      frees all its KV).

Events whose preconditions are absent (no swap activity, empty link
queue, no residents) stay ARMED: they fire at the first iteration >= the
scheduled one where the precondition holds, so a seeded plan composes
deterministically with any trace.

The ``DegradationLadder`` turns sustained fault/overload pressure into
staged capability shedding — shrink spec-k, disable speculation, shed
batch-class work, refuse interactive admissions — and restores rungs in
reverse once pressure clears.  Every rung only toggles knobs that are
token-identical by construction (speculation is bit-identical to greedy;
shedding removes streams but never alters surviving ones).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

FAULT_KINDS = ("executor_crash", "link_drop", "link_delay",
               "swap_dma_fail", "pressure_spike", "client_disconnect")


class InjectedFault(RuntimeError):
    """Base of every injector-raised failure (lets supervision code tell
    a scheduled chaos event from an organic bug)."""


class ExecutorCrash(InjectedFault):
    """Injected executor-step exception; the runtime recovers by evicting
    residents into the recompute path."""


@dataclass(frozen=True)
class FaultEvent:
    iteration: int          # earliest iteration this event may fire
    kind: str
    magnitude: float = 1.0  # link_delay: clock units; pressure_spike: pages
    duration: int = 0       # pressure_spike: iterations the phantom holds
    target: int = 0         # pool index (executor_crash) / k-th live rid

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {list(FAULT_KINDS)}")
        if self.iteration < 0:
            raise ValueError(f"iteration must be >= 0, got {self.iteration}")


@dataclass
class FaultPlan:
    """A replayable fault schedule.  ``events`` is kept sorted by
    (iteration, kind, target) so plans built from sets/dicts/JSON all
    inject identically."""

    events: List[FaultEvent] = field(default_factory=list)
    seed: Optional[int] = None

    def __post_init__(self):
        self.events = sorted(self.events,
                             key=lambda e: (e.iteration, e.kind, e.target))

    # -- construction -------------------------------------------------------

    @classmethod
    def from_seed(cls, seed: int, *, horizon: int = 200,
                  n_events: int = 8,
                  kinds: Optional[List[str]] = None) -> "FaultPlan":
        """Draw ``n_events`` events uniformly over ``[1, horizon)`` from a
        seeded rng — the chaos analogue of the seeded traffic traces."""
        rng = np.random.default_rng(seed)
        kinds = list(kinds or FAULT_KINDS)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            events.append(FaultEvent(
                iteration=int(rng.integers(1, max(horizon, 2))),
                kind=kind,
                magnitude=float(rng.integers(1, 4)),
                duration=int(rng.integers(1, 6)),
                target=int(rng.integers(0, 3))))
        return cls(events=events, seed=seed)

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [asdict(e) for e in self.events]},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        known = {"seed", "events"}
        extra = set(data) - known
        if extra:
            raise ValueError(f"unknown FaultPlan fields: {sorted(extra)}")
        return cls(events=[FaultEvent(**e) for e in data.get("events", [])],
                   seed=data.get("seed"))

    @classmethod
    def load(cls, spec: str) -> "FaultPlan":
        """Resolve a CLI-style plan spec: ``@path`` reads a JSON file,
        ``seed:<n>`` draws a seeded plan, anything else parses as inline
        JSON."""
        spec = spec.strip()
        if spec.startswith("@"):
            with open(spec[1:], "r", encoding="utf-8") as f:
                return cls.from_json(f.read())
        if spec.startswith("seed:"):
            return cls.from_seed(int(spec[len("seed:"):]))
        return cls.from_json(spec)


class FaultInjector:
    """Consumes a ``FaultPlan`` against a runtime's iteration counter.

    The runtimes poll ``due(kind, iteration)`` at the loop point where
    that kind can be acted on; undrawn events stay armed, so an event
    scheduled for a quiet iteration fires at the next opportunity.
    ``counters`` accumulates per-kind injection counts for metrics."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending: List[FaultEvent] = list(plan.events)
        self.counters: Dict[str, int] = {f"n_{k}": 0 for k in FAULT_KINDS}
        # live phantom pressure reservations: (release_iteration, rid)
        self._pressure: List[tuple] = []
        self._next_phantom = -1

    def exhausted(self) -> bool:
        return not self._pending and not self._pressure

    def armed(self, kind: str) -> int:
        return sum(1 for e in self._pending if e.kind == kind)

    def due(self, kind: str, iteration: int) -> List[FaultEvent]:
        """Pop (and count) every armed ``kind`` event scheduled at or
        before ``iteration``."""
        fired = [e for e in self._pending
                 if e.kind == kind and e.iteration <= iteration]
        if fired:
            self._pending = [e for e in self._pending if e not in fired]
            self.counters[f"n_{kind}"] += len(fired)
        return fired

    def maybe_crash(self, iteration: int, *, pool: Optional[int] = None,
                    active: bool = True) -> None:
        """Raise ``ExecutorCrash`` when an executor_crash event is due for
        this pool (``target`` 0 = prefill, >0 = decode; ``pool=None``
        matches any) AND the pool has residents to fail — otherwise the
        event stays armed for the next opportunity.  Raised BEFORE the
        scheduler plans, so recovery is exactly an eviction: no plan's
        bookkeeping has run against state that never executed."""
        if not active:
            return
        for e in self._pending:
            if e.kind != "executor_crash" or e.iteration > iteration:
                continue
            if pool is not None and min(e.target, 1) != pool:
                continue
            self._pending.remove(e)
            self.counters["n_executor_crash"] += 1
            raise ExecutorCrash(
                f"injected executor crash (scheduled it={e.iteration}, "
                f"fired it={iteration})")

    # -- allocator pressure spikes -----------------------------------------

    def apply_pressure(self, kvs, iteration: int) -> None:
        """Fire due pressure_spike events: phantom-reserve up to
        ``magnitude`` free pages (on the ``target``-th allocator of
        ``kvs``) under a synthetic negative request id, released after
        ``duration`` iterations — and unconditionally by
        ``release_pressure(None)`` at run end, so the zero-leak invariant
        is preserved by construction."""
        kvs = [kv for kv in kvs if kv is not None]
        if not kvs:
            return
        for ev in self.due("pressure_spike", iteration):
            kv = kvs[ev.target % len(kvs)]
            pages = min(int(ev.magnitude), kv.n_free_pages)
            if pages <= 0:
                continue
            rid = self._next_phantom
            self._next_phantom -= 1
            kv.reserve(rid, pages * kv.page_size)
            self._pressure.append((iteration + max(ev.duration, 1), rid, kv))

    def release_pressure(self, iteration: Optional[int]) -> None:
        """Release phantom reservations due by ``iteration`` (None = all,
        the end-of-run sweep)."""
        keep = []
        for rel_it, rid, kv in self._pressure:
            if iteration is None or rel_it <= iteration:
                if kv.owns(rid):
                    kv.free(rid)
            else:
                keep.append((rel_it, rid, kv))
        self._pressure = keep


# -- graceful degradation ----------------------------------------------------

DEGRADATION_LEVELS = ("normal", "spec_shrunk", "spec_off",
                      "shed_batch", "interactive_503")


class DegradationLadder:
    """Staged capability shedding under sustained fault/overload pressure.

    Callers ``record_pressure()`` on every recovery action (fault
    eviction, link drop, swap-DMA failure, deadline shed) and ``step()``
    once per iteration.  When >= ``trip`` pressure events land within
    ``window`` iterations the ladder climbs one rung; after ``cool``
    quiet iterations it descends one.  Rungs:

      normal          — full service.
      spec_shrunk     — speculative k halved on every attached scheduler
                        (fewer wasted verify tokens under churn).
      spec_off        — speculation disabled outright.
      shed_batch      — batch-class requests are shed on sight (the
                        runtime consults ``shed_class``).
      interactive_503 — the front-end refuses new work
                        (``refuse_new`` -> HTTP 503 / not ready).

    Speculation toggles are bit-identity-safe: spec decode emits the same
    greedy stream regardless of k (DESIGN.md §Speculative decode)."""

    def __init__(self, schedulers=(), *, trip: int = 3, window: int = 8,
                 cool: int = 16):
        self.schedulers = list(schedulers)
        self.trip = trip
        self.window = window
        self.cool = cool
        self.level_index = 0
        self.n_escalations = 0
        self.n_deescalations = 0
        self._events: List[int] = []     # pressure iterations (recent)
        self._last_pressure = -1
        self._last_change = -1
        self._saved = [(s.spec_mode, s.spec_k, s.spec_adaptive)
                       for s in self.schedulers]

    @property
    def level(self) -> str:
        return DEGRADATION_LEVELS[self.level_index]

    @property
    def shed_batch(self) -> bool:
        return self.level_index >= DEGRADATION_LEVELS.index("shed_batch")

    @property
    def refuse_new(self) -> bool:
        return self.level_index >= DEGRADATION_LEVELS.index("interactive_503")

    def shed_class(self, slo_class: str) -> bool:
        return self.shed_batch and slo_class == "batch"

    def record_pressure(self, iteration: int) -> None:
        self._events.append(iteration)
        self._last_pressure = max(self._last_pressure, iteration)

    def step(self, iteration: int) -> None:
        """Advance the ladder: escalate when the recent-pressure window
        trips, de-escalate after a quiet cool-down.  At most one rung per
        call, and never twice for the same window (``_last_change``)."""
        self._events = [t for t in self._events
                        if t > iteration - self.window]
        if (len(self._events) >= self.trip
                and self.level_index < len(DEGRADATION_LEVELS) - 1
                and iteration > self._last_change):
            self.level_index += 1
            self.n_escalations += 1
            self._last_change = iteration
            self._events.clear()
            self._apply()
        elif (self.level_index > 0
                and iteration - max(self._last_pressure,
                                    self._last_change) >= self.cool):
            self.level_index -= 1
            self.n_deescalations += 1
            self._last_change = iteration
            self._apply()

    def _apply(self) -> None:
        """Impose the current rung's speculation posture on every attached
        scheduler; descending below spec_shrunk restores the saved
        configuration verbatim."""
        for s, (mode, k, adaptive) in zip(self.schedulers, self._saved):
            if mode == "off":
                continue
            if self.level == "normal":
                s.configure_speculation(mode, k, adaptive)
            elif self.level == "spec_shrunk":
                s.configure_speculation(mode, max(1, k // 2), adaptive)
            else:                         # spec_off and every rung above
                s.configure_speculation("off")
