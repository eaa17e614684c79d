"""One harness for the port-vs-JAX engine parity tests: the same trace
through ``repro.serving.engine.Engine`` and ``repro_torch.serving.engine.
Engine`` on the same weights (fp32, CPU), driven by each package's own
``ServingRuntime`` (or, for two pools, ``DisaggRuntime``) on the iteration
clock, recorded as plain values that compare with ``==``."""

from __future__ import annotations

import numpy as np

from repro.core.base import make_scheduler as jax_make_scheduler
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineHandoff as JaxHandoff
from repro.serving.faults import FaultInjector as JaxFaultInjector
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.runtime import DisaggRuntime as JaxDisaggRuntime
from repro.serving.runtime import EngineExecutor as JaxExecutor
from repro.serving.runtime import ServingRuntime as JaxRuntime
from repro.serving.traffic import TraceRequest as JaxTraceRequest
from repro_torch.core.base import make_scheduler
from repro_torch.launch.load_gen import plan_key
from repro_torch.serving.engine import Engine, EngineHandoff
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.runtime import (DisaggRuntime, EngineExecutor,
                                         ServingRuntime)
from repro_torch.serving.traffic import TraceRequest
from test_torch_model import models

SCHED_KW = dict(n_slots=4, quantum=8, token_budget=16)


def mixed_trace(n=32, seed=0, spread=40):
    """``tests/test_runtime.py``'s multi-class oversubscribed trace as the
    port's TraceRequests: iteration-indexed arrivals, real token ids,
    interactive and batch interleaved."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.integers(0, spread, n)).astype(float)
    trace = []
    for i, t in enumerate(arrivals):
        n_tok = int(rng.integers(4, 10))
        trace.append(TraceRequest(
            arrival_time=float(t), prompt_len=n_tok,
            output_len=int(rng.integers(8, 13)),
            slo_class="batch" if i % 3 == 0 else "interactive",
            prompt_tokens=tuple(int(x)
                                for x in rng.integers(1, 200, n_tok))))
    return trace


def as_jax_trace(trace):
    """The port's TraceRequests as the JAX package's (same fields)."""
    return [JaxTraceRequest(r.arrival_time, r.prompt_len, r.output_len,
                            slo_class=r.slo_class,
                            prompt_tokens=r.prompt_tokens) for r in trace]


def build(framework: str, cfg, sched: str, sched_kw=None, draft=None,
          **engine_kw):
    """An engine of ``framework`` ("jax" or "torch") over the shared
    weights of ``cfg`` (seed 0); ``draft`` = (config, seed) gives it a
    draft model on that config's shared weights of that seed."""
    jm, jp, tm, tp = models(cfg)
    skw = dict(SCHED_KW, **(sched_kw or {}))
    engine_kw.setdefault("n_slots", skw["n_slots"])
    engine_kw.setdefault("max_len", 64)
    if draft is not None:
        djm, djp, dtm, dtp = models(*draft)
        engine_kw.update(draft_model=djm if framework == "jax" else dtm,
                         draft_params=djp if framework == "jax" else dtp)
    if framework == "jax":
        return JaxEngine(jm, jp, jax_make_scheduler(sched, jm.n_blocks, **skw),
                         **engine_kw)
    return Engine(tm, tp, make_scheduler(sched, tm.n_blocks, **skw),
                  **engine_kw)


def record(eng, runtime, res, verified=()) -> dict:
    reqs = sorted(res.requests, key=lambda r: r.req_id)
    spec = ("n_verify_tokens", "n_spec_accepted", "n_spec_rows")
    return {
        "plans": [plan_key(p) for p in runtime.plans],
        "outputs": {rid: [int(x) for x in t] for rid, t in eng.outputs.items()},
        "ttft": {r.req_id: r.first_token_time for r in reqs},
        "token_times": {r.req_id: list(r.token_times) for r in reqs},
        "expert_load_bytes": eng.expert_load_bytes,
        "n_preempted": eng.n_preempted,
        "n_swapped_out": eng.n_swapped_out,
        "n_swapped_in": eng.n_swapped_in,
        "n_prefix_hits": eng.alloc.n_prefix_hits,
        "n_prefix_tokens": eng.alloc.n_prefix_tokens,
        "n_prefix_restores": eng.n_prefix_restores,
        "n_dispatches": eng.n_dispatches,
        "pages_left": eng.alloc.pages_in_use(),
        "host_pages_left": eng.alloc.host_pages_in_use(),
        "iterations": eng.iteration,
        "n_spec_proposed": eng.n_spec_proposed,
        "n_spec_accepted": eng.n_spec_accepted,
        "n_verify_dispatches": eng.n_verify_dispatches,
        "n_draft_dispatches": eng.n_draft_dispatches,
        "spec_log": [tuple(e[k] for k in spec) for e in eng.iter_log],
        "last_verify_executed": list(verified),
    }


def run(framework: str, cfg, sched: str, *, jobs=(), trace=(),
        sched_kw=None, **engine_kw) -> dict:
    """Closed-loop ``jobs`` ((prompt, max_new) pairs, or (prompt, max_new,
    encoder frames) triples, submitted up front) and/or an open-loop
    ``trace`` of the port's TraceRequests replayed on the iteration
    clock."""
    eng = build(framework, cfg, sched, sched_kw, **engine_kw)
    submit(eng, jobs)
    # what each iteration verified (the engine keeps the last one only)
    verified, execute = [], eng.execute_plan

    def execute_plan(plan):
        events = execute(plan)
        verified.append(dict(eng.last_verify_executed))
        return events
    eng.execute_plan = execute_plan
    if framework == "jax":
        runtime = JaxRuntime(JaxExecutor(eng), clock="iteration",
                             record_plans=True)
        trace = as_jax_trace(trace)
    else:
        runtime = ServingRuntime(EngineExecutor(eng), clock="iteration",
                                 record_plans=True)
    res = runtime.run(list(trace), max_iterations=100_000)
    return record(eng, runtime, res, verified)


def submit(eng, jobs) -> None:
    for prompt, max_new, *frames in jobs:
        eng.submit(list(prompt), max_new, *frames)


def assert_same(got: dict, want: dict, keys=None) -> None:
    for key in keys or want:
        assert got[key] == want[key], key


def build_pair(framework: str, cfg, sched: str = "layered", sched_kw=None,
               **engine_kw):
    """(prefill, decode) engines of ``framework`` over ONE model and its
    shared weights: the prefill pool runs ``sched``, the decode pool the
    decode-only scheduler."""
    ep = build(framework, cfg, sched, sched_kw, **engine_kw)
    skw = dict(SCHED_KW, **(sched_kw or {}))
    make = jax_make_scheduler if framework == "jax" else make_scheduler
    kw = dict(engine_kw, n_slots=engine_kw.get("n_slots", skw["n_slots"]),
              max_len=engine_kw.get("max_len", 64))
    return ep, type(ep)(ep.model, ep.params,
                        make("decode", ep.model.n_blocks, **skw), **kw)


def run_disagg(framework: str, cfg, trace, *, streaming: bool = True,
               fault_plan=None, retry_budget: int = 3, sched="layered",
               sched_kw=None, jobs=(), **engine_kw) -> dict:
    """The port's TraceRequests replayed through ``framework``'s
    ``DisaggRuntime`` (iteration clock, plans recorded), after ``jobs``
    (as for ``run``) submitted to the prefill pool, with an optional
    ``FaultPlan`` (a JSON string) injected; returns the per-pool plans,
    the merged token streams, per-request and per-pool counters, and each
    migration's (request, prompt length, bytes)."""
    ep, ed = build_pair(framework, cfg, sched, sched_kw, **engine_kw)
    submit(ep, jobs)
    jax_side = framework == "jax"
    bridge = (JaxHandoff if jax_side else EngineHandoff)(
        ep, ed, streaming=streaming)
    migrations, export = [], bridge.export

    def recorded_export(req, now):
        m = export(req, now)
        migrations.append((req.req_id, m.payload["offset"], m.n_chunks,
                           m.bytes_total))
        return m
    bridge.export = recorded_export
    fi = None
    if fault_plan is not None:
        fi = (JaxFaultInjector(JaxFaultPlan.from_json(fault_plan))
              if jax_side else FaultInjector(FaultPlan.from_json(fault_plan)))
    ex = JaxExecutor if jax_side else EngineExecutor
    rt = (JaxDisaggRuntime if jax_side else DisaggRuntime)(
        ex(ep), ex(ed), bridge, clock="iteration", record_plans=True,
        faults=fi, retry_budget=retry_budget)
    res = rt.run(as_jax_trace(trace) if jax_side else list(trace),
                 max_iterations=100_000)
    reqs = sorted(res.requests, key=lambda r: r.req_id)
    return {
        "plans": [(tag, plan_key(p)) for tag, p in rt.plans],
        "outputs": {rid: [int(x) for x in t]
                    for rid, t in {**ep.outputs, **ed.outputs}.items()},
        "per_request": {r.req_id: (r.n_handoffs, r.n_handoff_chunks,
                                   r.n_preemptions, r.n_swaps,
                                   r.first_token_time, list(r.token_times),
                                   r.shed_reason) for r in reqs},
        "run": {k: getattr(res, k) for k in (
            "n_iterations", "n_prefill_iterations", "n_decode_iterations",
            "n_migrations", "n_returns", "n_preemptions", "n_swap_outs",
            "n_swap_ins", "n_dispatches", "recompute_tokens",
            "migration_queue_peak", "held_peak", "decode_prefill_slices")},
        "expert_load_bytes": (ep.expert_load_bytes, ed.expert_load_bytes),
        "handoffs": (ep.n_handoffs_out, ed.n_handoffs_in),
        "pages_left": (ep.alloc.pages_in_use(), ed.alloc.pages_in_use(),
                       ep.alloc.host_pages_in_use(),
                       ed.alloc.host_pages_in_use()),
        "fault_stats": rt.fault_stats(),
        "migrations": migrations,
        "max_len": ep.max_len,
    }
