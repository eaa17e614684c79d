"""One harness for the port-vs-JAX engine parity tests: the same trace
through ``repro.serving.engine.Engine`` and ``repro_torch.serving.engine.
Engine`` on the same weights (fp32, CPU), driven by each package's own
``ServingRuntime`` on the iteration clock, recorded as plain values that
compare with ``==``."""

from __future__ import annotations

from repro.core.base import make_scheduler as jax_make_scheduler
from repro.serving.engine import Engine as JaxEngine
from repro.serving.runtime import EngineExecutor as JaxExecutor
from repro.serving.runtime import ServingRuntime as JaxRuntime
from repro.serving.traffic import TraceRequest as JaxTraceRequest
from repro_torch.core.base import make_scheduler
from repro_torch.serving.engine import Engine
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from repro_torch.serving.traffic import TraceRequest
from test_torch_model import models

SCHED_KW = dict(n_slots=4, quantum=8, token_budget=16)


def plan_key(plan):
    return (tuple(plan.admitted_ids), tuple(plan.preempted_ids),
            tuple(plan.swapped_out_ids), tuple(plan.swapped_in_ids),
            tuple(plan.decode_ids),
            tuple((s.req_id, s.token_start, s.token_end, s.block_start,
                   s.block_end, s.emits_first_token) for s in plan.prefill))


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
    """Closed-loop ``jobs`` ((prompt, max_new) pairs submitted up front)
    and/or an open-loop ``trace`` of the port's TraceRequests replayed on
    the iteration clock."""
    eng = build(framework, cfg, sched, sched_kw, **engine_kw)
    for prompt, max_new in jobs:
        eng.submit(list(prompt), max_new)
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


def assert_same(got: dict, want: dict, keys=None) -> None:
    for key in keys or want:
        assert got[key] == want[key], key
