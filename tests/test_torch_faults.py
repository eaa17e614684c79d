"""Chaos mode in the port (``serving/faults.py`` and the runtimes'
supervision), on the CPU in fp32: the engine-level tests of
tests/test_faults.py against the port's engine, plus port-vs-JAX identity
of seeded chaos runs (fault counters, shed reasons, token streams).

The invariant: under any seeded fault schedule — executor crashes,
dropped or delayed migrations, failed swap DMAs, allocator pressure
spikes, client disconnects — every surviving request's stream equals the
fault-free run's, in both preemption modes, a shed request's stream is a
prefix of it, and no KV page leaks from any pool.

Not ported here: the HTTP server tests of tests/test_faults.py
(``test_readyz_reflects_degradation_ladder``,
``test_drain_gates_ingestion_and_finishes_inflight``,
``test_sse_client_disconnect_cancels_and_frees_kv``); they wait for the
port's HTTP front-end (ROADMAP §1 item 6).
"""

from __future__ import annotations

import numpy as np
import pytest

import _torch_parity as parity
from conftest import tiny_dense, tiny_moe
from repro_torch.core.base import make_scheduler
from repro_torch.core.plan import RequestState, SubmitSpec
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving.engine import EngineHandoff
from repro_torch.serving.faults import (DEGRADATION_LEVELS, DegradationLadder,
                                        FaultEvent, FaultInjector, FaultPlan)
from repro_torch.serving.metrics import fault_counters, prometheus_text
from repro_torch.serving.runtime import (DisaggRuntime, EngineExecutor,
                                         ServingRuntime)
from repro_torch.serving.traffic import TraceRequest
from test_faults import _mixed_trace as jax_mixed_trace

PRESSURE = dict(pages=16, page_size=4, decode_reserve=1)
# tests/test_faults.py's two-pool link-fault schedule
LINK_EVENTS = [
    FaultEvent(iteration=2, kind="link_drop"),
    FaultEvent(iteration=6, kind="link_delay", magnitude=3.0),
    FaultEvent(iteration=10, kind="link_drop", target=1),
    FaultEvent(iteration=12, kind="executor_crash", target=0),
    FaultEvent(iteration=20, kind="executor_crash", target=1),
]
SEEDED_KINDS = ["executor_crash", "pressure_spike", "client_disconnect",
                "swap_dma_fail"]


# ---------------------------------------------------------------- fixtures

def _mixed_trace(**kw):
    """tests/test_faults.py's multi-class oversubscribed trace, as the
    port's TraceRequests."""
    return [TraceRequest(r.arrival_time, r.prompt_len, r.output_len,
                         slo_class=r.slo_class, prompt_tokens=r.prompt_tokens)
            for r in jax_mixed_trace(**kw)]


def _engine(cfg, **eng_kw):
    return parity.build("torch", cfg, "layered", **eng_kw)


def _free_outputs(cfg, trace):
    """Fault-free unconstrained reference run over the same prompts."""
    free = _engine(cfg)
    for tr in trace:
        free.submit(list(tr.prompt_tokens), tr.output_len)
    free.run(max_iterations=100_000)
    return free.outputs


def _assert_survivors_identical(requests, outputs, free_outputs):
    """Survivors bit-identical; shed requests' partial streams must be a
    PREFIX of the fault-free stream (greedy determinism)."""
    n_survivors = 0
    for r in requests:
        got = list(outputs.get(r.req_id, []))
        ref = list(free_outputs[r.req_id])
        if r.shed_reason is None:
            assert got == ref, f"survivor r{r.req_id} tokens diverged"
            n_survivors += 1
        else:
            assert got == ref[:len(got)], \
                f"shed r{r.req_id} stream is not a prefix"
    assert n_survivors > 0, "chaos schedule killed every request"


def _assert_no_leaks(*engines):
    for e in engines:
        assert e.alloc.pages_in_use() == 0
        assert e.alloc.host_pages_in_use() == 0
        e.alloc.check_invariants()


# ------------------------------------------------------- plan determinism

def test_fault_plan_seed_deterministic_and_json_round_trip(tmp_path):
    a = FaultPlan.from_seed(7)
    b = FaultPlan.from_seed(7)
    assert a.events == b.events and a.events
    assert FaultPlan.from_seed(8).events != a.events
    rt = FaultPlan.from_json(a.to_json())
    assert rt.events == a.events and rt.seed == a.seed
    # the three CLI spellings
    assert FaultPlan.load("seed:7").events == a.events
    assert FaultPlan.load(a.to_json()).events == a.events
    p = tmp_path / "plan.json"
    p.write_text(a.to_json())
    assert FaultPlan.load(f"@{p}").events == a.events


def test_fault_plan_rejects_garbage():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(iteration=1, kind="meteor_strike")
    with pytest.raises(ValueError, match="iteration"):
        FaultEvent(iteration=-1, kind="link_drop")
    with pytest.raises(ValueError, match="unknown FaultPlan fields"):
        FaultPlan.from_json('{"events": [], "typo": 1}')


def test_injector_events_stay_armed_until_due():
    plan = FaultPlan(events=[FaultEvent(iteration=5, kind="link_drop")])
    fi = FaultInjector(plan)
    assert fi.due("link_drop", 4) == []
    assert fi.armed("link_drop") == 1
    assert len(fi.due("link_drop", 9)) == 1      # late poll still fires
    assert fi.counters["n_link_drop"] == 1
    assert fi.exhausted()


# --------------------------------------------- survivor identity: crashes

@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_executor_crash_survivors_bit_identical(mode):
    """Injected executor-step crashes under memory pressure: every
    resident is evicted and recovered by recompute; with budget to spare,
    ALL requests survive with fault-free token streams."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    eng = _engine(cfg, preemption_mode=mode, **PRESSURE)
    plan = FaultPlan(events=[FaultEvent(iteration=4, kind="executor_crash"),
                             FaultEvent(iteration=15,
                                        kind="executor_crash")])
    fi = FaultInjector(plan)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=fi, retry_budget=50)
    rr = rt.run(trace, max_iterations=100_000)

    assert fi.counters["n_executor_crash"] == 2
    assert rt.n_fault_retries > 0
    assert all(r.shed_reason is None for r in rr.requests)
    assert eng.outputs == _free_outputs(cfg, trace), \
        "crash recovery changed generated tokens"
    _assert_no_leaks(eng)
    stats = rt.fault_stats()
    assert stats["n_executor_crashes"] == 2
    assert stats["n_retry_sheds"] == 0


def test_swap_dma_failure_demotes_to_recompute_bit_identical():
    """A failed swap-out DMA batch demotes its victims to recompute
    evictions (no host copy is taken) — tokens unchanged, swap accounting
    consistent, zero leaks."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    eng = _engine(cfg, preemption_mode="swap", **PRESSURE)
    # scheduled early; stays armed until an iteration actually swaps
    plan = FaultPlan(events=[FaultEvent(iteration=1,
                                        kind="swap_dma_fail")])
    fi = FaultInjector(plan)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=fi, retry_budget=50)
    rr = rt.run(trace, max_iterations=100_000)

    assert fi.counters["n_swap_dma_fail"] == 1
    assert all(r.shed_reason is None for r in rr.requests)
    assert eng.outputs == _free_outputs(cfg, trace)
    # the demoted victims count as preemptions, not swaps
    assert sum(r.n_swaps for r in rr.requests) == rr.n_swap_outs
    _assert_no_leaks(eng)
    assert not eng.host_kv


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_disagg_link_faults_survivors_bit_identical(mode):
    """Dropped and delayed migrations plus a crash of each pool: victims
    fold and retry through the prefill pool (never lost), the decode
    pool's plans stay prefill-free, and the merged two-pool output equals
    the fault-free monolithic run."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    ep, ed = parity.build_pair("torch", cfg, preemption_mode=mode,
                               **PRESSURE)
    fi = FaultInjector(FaultPlan(events=list(LINK_EVENTS)))
    rt = DisaggRuntime(EngineExecutor(ep), EngineExecutor(ed),
                       EngineHandoff(ep, ed, streaming=True),
                       clock="iteration", faults=fi, retry_budget=50)
    rr = rt.run(trace, max_iterations=100_000)

    assert fi.counters["n_link_drop"] == 2
    assert fi.counters["n_link_delay"] == 1
    assert fi.counters["n_executor_crash"] == 2
    assert rr.decode_prefill_slices == 0
    assert all(r.shed_reason is None for r in rr.requests)
    outs = {**ep.outputs, **ed.outputs}
    assert outs == _free_outputs(cfg, trace), \
        "link chaos changed generated tokens"
    _assert_no_leaks(ep, ed)
    assert not ep._handoff_chunks


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_seeded_chaos_schedule_survivors_bit_identical(mode):
    """A seeded multi-kind schedule (crashes, pressure spikes,
    disconnects, swap-DMA failures) against the oversubscribed trace —
    survivors bit-identical, shed streams are prefixes, zero pages
    leak."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    free_outputs = _free_outputs(cfg, trace)
    plan = FaultPlan.from_seed(3, horizon=40, n_events=6,
                               kinds=SEEDED_KINDS)
    eng = _engine(cfg, preemption_mode=mode, **PRESSURE)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=FaultInjector(plan), retry_budget=50)
    rr = rt.run(trace, max_iterations=100_000)

    assert rt.fault_stats()["n_injected_faults"] > 0
    _assert_survivors_identical(rr.requests, eng.outputs, free_outputs)
    _assert_no_leaks(eng)


# --------------------------------------------- deadlines, cancels, budget

def test_deadline_expiry_sheds_and_frees_kv():
    cfg = tiny_dense()
    rng = np.random.default_rng(0)
    specs = []
    for i in range(6):
        toks = tuple(int(x) for x in rng.integers(1, 200, 6))
        specs.append(SubmitSpec(
            prompt_tokens=toks, max_new_tokens=40, arrival_time=0.0,
            # the first two can never finish 40 tokens in 5 iterations
            deadline_ms=5 if i < 2 else None))
    eng = _engine(cfg)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    rr = rt.run(specs, max_iterations=100_000)

    shed = [r for r in rr.requests if r.shed_reason == "deadline"]
    assert len(shed) == 2
    assert all(r.state is RequestState.DONE for r in shed)
    assert rt.n_deadline_sheds == 2
    done = [r for r in rr.requests if r.shed_reason is None]
    assert done and all(r.n_generated == 40 for r in done)
    _assert_no_leaks(eng)


def test_cancel_mid_run_sheds_and_notifies():
    """cancel() from another thread sheds at the next iteration boundary,
    fires on_shed in the loop thread, and frees the victim's pages."""
    cfg = tiny_dense()
    rng = np.random.default_rng(1)
    specs = [SubmitSpec(prompt_tokens=tuple(
        int(x) for x in rng.integers(1, 200, 6)),
        max_new_tokens=30, arrival_time=0.0) for _ in range(4)]
    eng = _engine(cfg)
    shed_log = []
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        on_shed=lambda r, why: shed_log.append(
                            (r.req_id, why)))
    rt.cancel(0)                    # queued before the loop even starts
    rt.cancel(999)                  # unknown id: ignored
    rr = rt.run(specs, max_iterations=100_000)

    assert shed_log == [(0, "disconnect")]
    assert rr.requests[0].shed_reason == "disconnect"
    assert rt.n_disconnect_sheds == 1
    assert all(r.shed_reason is None and r.n_generated == 30
               for r in rr.requests[1:])
    _assert_no_leaks(eng)


def test_retry_budget_exhaustion_sheds_with_reason():
    """retry_budget=0: the first injected crash sheds every resident with
    reason 'retries' instead of recovering it — bounded, never a loop."""
    cfg = tiny_dense()
    trace = _mixed_trace(n=8, spread=2)
    eng = _engine(cfg, **PRESSURE)
    plan = FaultPlan(events=[FaultEvent(iteration=3,
                                        kind="executor_crash")])
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=FaultInjector(plan), retry_budget=0)
    rr = rt.run(trace, max_iterations=100_000)

    shed = [r for r in rr.requests if r.shed_reason == "retries"]
    assert shed, "crash with zero budget must shed residents"
    assert rt.n_retry_sheds == len(shed)
    assert rt.n_fault_retries == 0
    survivors = [r for r in rr.requests if r.shed_reason is None]
    assert survivors and all(r.finish_time is not None for r in survivors)
    _assert_no_leaks(eng)
    assert not eng._slot_of and not eng.stash


def test_pressure_spike_forces_evictions_and_releases():
    """Phantom page reservations under an otherwise-fitting load force
    the eviction path; tokens unchanged and the phantom never leaks."""
    cfg = tiny_dense()
    trace = _mixed_trace(n=12, spread=10)
    eng = _engine(cfg, pages=24, page_size=4, decode_reserve=1)
    plan = FaultPlan(events=[
        FaultEvent(iteration=3, kind="pressure_spike", magnitude=16,
                   duration=8),
        FaultEvent(iteration=20, kind="pressure_spike", magnitude=16,
                   duration=8)])
    fi = FaultInjector(plan)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=fi, retry_budget=50)
    rr = rt.run(trace, max_iterations=100_000)

    assert fi.counters["n_pressure_spike"] == 2
    assert all(r.shed_reason is None for r in rr.requests)
    assert eng.outputs == _free_outputs(cfg, trace)
    assert fi.exhausted()           # phantoms released at run end
    _assert_no_leaks(eng)


# ------------------------------------------------------ degradation ladder

def test_degradation_ladder_escalates_and_restores_spec():
    s = make_scheduler("layered", 4, n_slots=4, quantum=8,
                       token_budget=16)
    s.configure_speculation("ngram", 4, adaptive=True)
    lad = DegradationLadder([s], trip=2, window=4, cool=3)
    assert lad.level == "normal"

    def pressure_at(it):
        lad.record_pressure(it)
        lad.record_pressure(it)
        lad.step(it)

    pressure_at(1)
    assert lad.level == "spec_shrunk" and s.spec_k == 2
    pressure_at(2)
    assert lad.level == "spec_off" and s.spec_mode == "off"
    pressure_at(3)
    assert lad.level == "shed_batch"
    assert lad.shed_class("batch") and not lad.shed_class("interactive")
    pressure_at(4)
    assert lad.level == "interactive_503" and lad.refuse_new
    # one rung per step, even under continuing pressure at the top
    assert lad.n_escalations == 4
    # quiet cool-down walks back down and restores the saved spec config
    it = 4
    while lad.level != "normal":
        it += lad.cool
        lad.step(it)
    assert lad.n_deescalations == 4
    assert (s.spec_mode, s.spec_k, s.spec_adaptive) == ("ngram", 4, True)
    assert DEGRADATION_LEVELS[lad.level_index] == "normal"


def test_degradation_shed_batch_shows_in_run():
    """Sustained injected pressure climbs the ladder far enough to shed
    batch-class work; interactive requests still finish identically."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    free_outputs = _free_outputs(cfg, trace)
    eng = _engine(cfg, **PRESSURE)
    events = [FaultEvent(iteration=i, kind="executor_crash")
              for i in range(2, 26, 2)]
    ladder = DegradationLadder([eng.scheduler], trip=2, window=6, cool=50)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        faults=FaultInjector(FaultPlan(events=events)),
                        retry_budget=50, ladder=ladder)
    rr = rt.run(trace, max_iterations=100_000)

    stats = rt.fault_stats()
    assert stats["n_degradation_escalations"] >= \
        DEGRADATION_LEVELS.index("shed_batch")
    assert stats["n_degrade_sheds"] > 0
    assert any(r.shed_reason == "degrade" and r.slo_class == "batch"
               for r in rr.requests)
    _assert_survivors_identical(rr.requests, eng.outputs, free_outputs)
    _assert_no_leaks(eng)


# ------------------------------------------------- diagnostics + counters

def test_no_progress_dump_names_queues_pools_and_requests():
    cfg = tiny_dense()
    trace = _mixed_trace(n=8, spread=2)
    eng = _engine(cfg)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    with pytest.raises(RuntimeError) as ei:
        rt.run(trace, max_iterations=3)
    msg = str(ei.value)
    assert "did not drain" in msg
    assert "pending_arrivals=" in msg
    assert "kv free=" in msg and "hwm=" in msg
    assert "[pool] sched=" in msg
    assert "\n  r" in msg, "per-request rows missing from the dump"


def test_fault_stats_schema_matches_prometheus_counters():
    cfg = tiny_dense()
    eng = _engine(cfg)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    stats = rt.fault_stats()            # faults=None still yields schema
    counters = fault_counters(**stats)
    assert counters["faults_injected_total"] == 0.0
    assert counters["degradation_level"] == 0.0
    text = prometheus_text([], counters=counters)
    for name in ("repro_faults_injected_total",
                 "repro_fault_executor_crashes_total",
                 "repro_fault_link_drops_total",
                 "repro_fault_swap_dma_fails_total",
                 "repro_sheds_deadline_total",
                 "repro_sheds_retries_total",
                 "repro_sheds_disconnect_total",
                 "repro_fault_retries_total",
                 "repro_degradation_level"):
        assert f"{name} 0" in text, f"{name} missing from /metrics"


# ------------------------------------------------- the port against JAX

def _chaos_record(framework, cfg, trace, plan_json, mode):
    """One seeded chaos run of ``framework``'s monolithic runtime: fault
    stats, shed reasons, streams and the per-request retry counts."""
    eng = parity.build(framework, cfg, "layered", preemption_mode=mode,
                       **PRESSURE)
    if framework == "jax":
        from repro.serving.faults import FaultInjector as JFI
        from repro.serving.faults import FaultPlan as JFP
        from repro.serving.runtime import EngineExecutor as JEX
        from repro.serving.runtime import ServingRuntime as JRT
        rt = JRT(JEX(eng), clock="iteration", record_plans=True,
                 faults=JFI(JFP.from_json(plan_json)), retry_budget=50)
        trace = parity.as_jax_trace(trace)
    else:
        rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                            record_plans=True,
                            faults=FaultInjector(FaultPlan.from_json(
                                plan_json)), retry_budget=50)
    rr = rt.run(list(trace), max_iterations=100_000)
    return {"fault_stats": rt.fault_stats(),
            "shed": {r.req_id: r.shed_reason for r in rr.requests},
            "retries": {r.req_id: r.n_fault_retries for r in rr.requests},
            "outputs": {k: [int(x) for x in v]
                        for k, v in eng.outputs.items()},
            "plans": [parity.plan_key(p) for p in rt.plans],
            "expert_load_bytes": eng.expert_load_bytes,
            "pages_left": (eng.alloc.pages_in_use(),
                           eng.alloc.host_pages_in_use())}


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_seeded_chaos_matches_jax_runtime(mode):
    """The same seeded plan through JAX's and the port's runtime on
    tiny_moe: equal ``fault_stats()``, shed reasons, retries, plans,
    streams and expert bytes."""
    cfg = tiny_moe()
    plan = FaultPlan.from_seed(3, horizon=40, n_events=6,
                               kinds=SEEDED_KINDS).to_json()
    trace = _mixed_trace()
    want = _chaos_record("jax", cfg, trace, plan, mode)
    got = _chaos_record("torch", cfg, trace, plan, mode)
    parity.assert_same(got, want)
    assert got["fault_stats"]["n_injected_faults"] > 0
    assert got["pages_left"] == (0, 0)


def test_disagg_link_faults_match_jax_runtime():
    """tests/test_faults.py's link-fault schedule through both packages'
    ``DisaggRuntime`` on tiny_moe: the same plans, streams, migrations,
    returns, fault stats and per-pool expert bytes."""
    cfg = tiny_moe()
    plan = FaultPlan(events=list(LINK_EVENTS)).to_json()
    trace = _mixed_trace()
    kw = dict(PRESSURE, fault_plan=plan, retry_budget=50)
    want = parity.run_disagg("jax", cfg, trace, **kw)
    got = parity.run_disagg("torch", cfg, trace, **kw)
    parity.assert_same(got, want, [k for k in want if k != "migrations"])
    assert got["fault_stats"]["n_link_drops"] == 2
    assert got["pages_left"] == (0, 0, 0, 0)


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("disagg", [False, True])
def test_launcher_chaos_line_on_the_cpu(disagg, capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "4",
            "--max-len", "96", "--fault-plan", "seed:7"]
    serve_main(argv + (["--disagg"] if disagg else []))
    tag = "serve-disagg" if disagg else "serve"
    chaos = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(f"[{tag}] chaos: ")]
    assert len(chaos) == 1, chaos
    assert "faults injected" in chaos[0]


def test_launcher_injects_an_inline_plan(capsys):
    plan = FaultPlan(events=[FaultEvent(iteration=2,
                                        kind="executor_crash")]).to_json()
    serve_main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                "4", "--max-len", "96", "--fault-plan", plan,
                "--retry-budget", "0"])
    out = capsys.readouterr().out
    assert "[serve] chaos: 1 faults injected (executor_crash=1); shed " \
        "retries=" in out
