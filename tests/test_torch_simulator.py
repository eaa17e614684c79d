"""The port's analytic simulator, cost model and ``SimExecutor``
(``repro_torch/serving/{simulator,cost_model,runtime}.py``) against the
JAX package: the tests of ``tests/test_simulator.py`` and
``tests/test_cost_model.py`` run on the port's modules, the SimExecutor
half of ``tests/test_runtime.py`` run against the port's engine, and the
port's ``Simulator``/``DisaggSimulator``/``CostModel`` results held equal
to the JAX package's, EXACTLY: both are the same numpy arithmetic over the
same configs and traces."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

from _torch_parity import build, mixed_trace, plan_key
from conftest import tiny_dense
from repro.configs import get_config as jax_get_config
from repro.core.plan import IterationPlan as JaxPlan
from repro.core.plan import PrefillSlice as JaxSlice
from repro.core.plan import Request as JaxRequest
from repro.serving import cost_model as jcm
from repro.serving import simulator as jsim
from repro.serving.traffic import TraceRequest as JaxTraceRequest
from repro_torch.configs import get_config
from repro_torch.core import make_scheduler
from repro_torch.core.plan import IterationPlan, PrefillSlice, Request
from repro_torch.serving.cost_model import (H100X2, TPU_V5E, CostModel,
                                            expected_coverage, kv_pool_pages)
from repro_torch.serving.metrics import SLOConfig, request_metrics
from repro_torch.serving.runtime import (EngineExecutor, ServingRuntime,
                                         SimExecutor)
from repro_torch.serving.simulator import DisaggSimulator, Simulator
from repro_torch.serving.traffic import ARXIV, TraceRequest, poisson_trace
from test_torch_model import port_cfg

SCHEDULERS = ("chunked", "layered", "hybrid", "continuous", "static")


@pytest.fixture(scope="module")
def qwen():
    return get_config("qwen3-30b-a3b")


def _trace(n=30, rate=1.0, seed=0, prompt=8192, out=64, cls=TraceRequest):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    t = np.cumsum(gaps)
    return [cls(float(a), prompt, out) for a in t]


def run(cfg, sched, trace, **kw):
    sim = Simulator(cfg, sched, H100X2, n_slots=64, **kw)
    return sim.run(trace)


# ------------------------------------------------------- the JAX package


def _request_record(r) -> tuple:
    return (r.req_id, r.slo_class, r.arrival_time, r.admit_time,
            r.first_token_time, tuple(r.token_times), r.finish_time,
            r.n_generated, r.n_preemptions, r.n_swaps, r.n_folded,
            r.handoff_time, r.n_handoffs, r.n_handoff_chunks)


def _sim_record(res) -> dict:
    """Every field of a SimResult (or DisaggSimResult, with its two pools)
    as plain values that compare with ``==``."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if f.name == "requests":
            out[f.name] = [_request_record(r) for r in v]
        elif f.name in ("prefill", "decode"):
            out[f.name] = _sim_record(v)
        else:
            out[f.name] = v
    return out


def _jax_trace(trace):
    return [JaxTraceRequest(t.arrival_time, t.prompt_len, t.output_len,
                            slo_class=t.slo_class,
                            prompt_tokens=t.prompt_tokens) for t in trace]


def _pressured_trace():
    """arXiv-shaped arrivals near saturation, with shared-prefix tokens
    (prefix-cache hits) and a batch class, in an oversubscribed pool."""
    trace = poisson_trace(ARXIV, rate=2.0, n_requests=24, seed=3)
    rng = np.random.default_rng(0)
    sys_prompt = tuple(int(x) for x in rng.integers(1, 1000, 512))
    return [dataclasses.replace(
        t, prompt_len=min(t.prompt_len, 4096),
        slo_class="batch" if i % 3 == 0 else "interactive",
        prompt_tokens=sys_prompt + tuple(
            int(x) for x in rng.integers(1, 1000,
                                         min(t.prompt_len, 4096) - 512)))
        for i, t in enumerate(trace)]


@pytest.mark.parametrize("mode", ["recompute", "swap"])
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_simulator_matches_jax(sched, mode):
    """All five schedulers, both preemption flavours, a pressured pool:
    the port's SimResult equals the JAX package's field by field, every
    request's timeline included."""
    trace = _pressured_trace()
    kw = dict(n_slots=16, n_pages=900, page_size=16, decode_reserve=0,
              preemption_mode=mode, quantum=512, token_budget=512)
    got = Simulator(get_config("qwen3-30b-a3b"), sched, H100X2,
                    **kw).run(trace)
    want = jsim.Simulator(jax_get_config("qwen3-30b-a3b"), sched,
                          jcm.H100X2, **kw).run(_jax_trace(trace))
    assert got.n_preemptions + got.n_swap_outs > 0 or sched == "static"
    assert _sim_record(got) == _sim_record(want)


@pytest.mark.parametrize("handoff", ["stream", "whole"])
def test_disagg_simulator_matches_jax(handoff):
    """Two pools (layered prefill pool, decode pool) over the modelled
    link: the port's DisaggSimResult equals the JAX package's, per pool
    and per request."""
    trace = _pressured_trace()
    kw = dict(handoff=handoff, n_slots=16, quantum=512, decode_pages=1200,
              decode_watermark=8)
    got = DisaggSimulator(get_config("qwen3-30b-a3b"), "layered", H100X2,
                          **kw).run(trace)
    want = jsim.DisaggSimulator(jax_get_config("qwen3-30b-a3b"), "layered",
                                jcm.H100X2, **kw).run(_jax_trace(trace))
    assert got.n_migrations >= len(trace) and got.decode_prefill_slices == 0
    assert _sim_record(got) == _sim_record(want)
    assert got.total_energy == want.total_energy


def test_cost_model_matches_jax():
    """CostModel.iteration_cost, moe_gmm_cost, swap/link transfers and
    the KV pool sizing equal the JAX package's on both presets and both
    MoE dispatches."""
    for arch in ("qwen3-30b-a3b", "gpt-oss-20b", "yi-34b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for hw, jhw in ((H100X2, jcm.H100X2), (TPU_V5E, jcm.TPU_V5E)):
            assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
            assert kv_pool_pages(cfg, hw) == jcm.kv_pool_pages(jcfg, jhw)
            for disp in ("ragged", "dense"):
                cm = CostModel(cfg, hw, moe_dispatch=disp)
                jm = jcm.CostModel(jcfg, jhw, moe_dispatch=disp)
                reqs = {i: Request(req_id=i, prompt_len=512 * (i + 1),
                                   max_new_tokens=64, n_generated=i)
                        for i in range(4)}
                jreqs = {i: JaxRequest(req_id=i, prompt_len=512 * (i + 1),
                                       max_new_tokens=64, n_generated=i)
                         for i in range(4)}
                L = cfg.n_layers
                slices = [(9, 0, 2048, 0, L // 2, False),
                          (10, 512, 1024, 0, L, True),
                          (11, 0, 100, L // 2, L, True)]
                plan = IterationPlan(decode_ids=[0, 1, 2, 3],
                                     prefill=[PrefillSlice(*s)
                                              for s in slices],
                                     verify_len={1: 3})
                jplan = JaxPlan(decode_ids=[0, 1, 2, 3],
                                prefill=[JaxSlice(*s) for s in slices],
                                verify_len={1: 3})
                assert cm.iteration_cost(plan, reqs) \
                    == jm.iteration_cost(jplan, jreqs)
                for n in (1, 8, 300, 8192):
                    assert cm.moe_gmm_cost(n) == jm.moe_gmm_cost(n)
                    assert cm.swap_transfer(n) == jm.swap_transfer(n)
                    assert cm.link_transfer(n) == jm.link_transfer(n)
                    assert cm.recompute_cost(n) == jm.recompute_cost(n)
                assert cm.block_prefill_costs() == jm.block_prefill_costs()


# ----------------------------------------------- tests/test_simulator.py


def test_all_requests_complete(qwen):
    trace = _trace(20)
    for name in SCHEDULERS:
        res = run(qwen, name, trace)
        assert len(res.requests) == 20
        for r in res.requests:
            assert r.first_token_time is not None, name
            assert r.n_generated == 64 or r.state.value == "done", name


def test_layered_beats_chunked_on_long_prompts(qwen):
    """The paper's headline: lower TTFT, lower expert traffic, lower energy
    per token on arXiv-like (long-prompt) workloads."""
    trace = _trace(40, rate=1.3)
    chunked = run(qwen, "chunked", trace, token_budget=512)
    layered = run(qwen, "layered", trace, quantum=512)
    mc = request_metrics(chunked.requests)
    ml = request_metrics(layered.requests)
    assert ml["ttft_mean"] < mc["ttft_mean"]
    assert layered.total_expert_bytes < chunked.total_expert_bytes
    assert layered.energy_per_token < chunked.energy_per_token
    assert ml["e2e_mean"] < mc["e2e_mean"]


def test_continuous_batching_stalls_decode(qwen):
    trace = _trace(30, rate=1.5)
    cont = request_metrics(run(qwen, "continuous", trace).requests)
    layer = request_metrics(run(qwen, "layered", trace).requests)
    assert layer["tbt_p99"] < cont["tbt_p99"] / 3


def test_static_batching_inflates_ttft(qwen):
    trace = _trace(30, rate=1.5)
    static = request_metrics(run(qwen, "static", trace).requests)
    layer = request_metrics(run(qwen, "layered", trace).requests)
    assert layer["ttft_p99"] < static["ttft_p99"]


def test_slo_attainment_definition(qwen):
    trace = _trace(10, rate=0.5)
    res = run(qwen, "layered", trace)
    slo = SLOConfig(ttft_slo=10.0, tbt_slo=0.125)
    m = request_metrics(res.requests, slo)
    assert 0.0 <= m["slo_attainment"] <= 1.0
    assert m["slo_attainment"] <= min(m["ttft_attainment"],
                                      m["tbt_attainment"]) + 1e-9


def test_poisson_trace_statistics():
    trace = poisson_trace(ARXIV, rate=2.0, n_requests=4000, seed=1)
    arr = np.array([t.arrival_time for t in trace])
    gaps = np.diff(arr)
    assert gaps.mean() == pytest.approx(0.5, rel=0.1)
    ins = np.array([t.prompt_len for t in trace])
    outs = np.array([t.output_len for t in trace])
    assert ins.mean() == pytest.approx(9194, rel=0.15)
    assert outs.mean() == pytest.approx(231, rel=0.15)
    assert np.percentile(ins, 90) == pytest.approx(17152, rel=0.35)


def test_oversubscribed_pool_completes_with_preemption(qwen):
    """A trace far beyond the page pool's capacity drains through
    queueing + preemption: page high-water within the pool, every request
    fully generated."""
    trace = _trace(32, rate=50.0, prompt=4096, out=1024)
    pool = 6 * 4096 // 16
    for name in ("chunked", "layered", "continuous"):
        sim = Simulator(qwen, name, H100X2, n_slots=64, n_pages=pool,
                        page_size=16, decode_reserve=0)
        res = sim.run(trace)
        assert res.n_preemptions > 0, name
        assert res.pages_high_water <= res.n_pool_pages, name
        assert sim.kv.pages_in_use() == 0, name
        for r in res.requests:
            assert r.n_generated == 1024, (name, r.req_id)
        assert res.total_tokens == 32 * (4096 + 1024), name
        assert res.recompute_tokens >= 4096
        m = request_metrics(res.requests)
        assert m["preemption_rate"] > 0
        assert m["queue_delay_mean"] > 0


def test_simulator_queueing_instead_of_crash_when_pool_small(qwen):
    trace = _trace(12, rate=50.0, prompt=2048, out=32)
    pool = 2 * (2048 + 64) // 16
    sim = Simulator(qwen, "layered", H100X2, n_slots=64, n_pages=pool,
                    page_size=16, decode_reserve=32, preemption=False)
    res = sim.run(trace)
    assert res.n_preemptions == 0
    for r in res.requests:
        assert r.n_generated == 32


def test_simulator_raises_on_no_progress(qwen):
    from repro_torch.core.base import Scheduler

    class StuckScheduler(Scheduler):
        name = "stuck"

        def has_work(self):
            return True                       # lies forever

        def _plan(self, now):
            return IterationPlan()

    sim = Simulator(qwen, StuckScheduler(qwen.n_layers), H100X2)
    with pytest.raises(RuntimeError, match="no progress"):
        sim.run([])


def test_default_pool_sized_from_hbm(qwen):
    pages = kv_pool_pages(qwen, H100X2, page_size=16)
    kv_bytes = qwen.kv_bytes_per_token(2) * 16 * pages
    assert 20e9 < kv_bytes < 160e9
    sim = Simulator(qwen, "layered", H100X2, n_slots=4)
    assert sim.kv.n_pages == pages


def test_simulator_time_monotone(qwen):
    trace = _trace(8, rate=1.0)
    res = run(qwen, "layered", trace)
    for r in res.requests:
        ts = ([r.first_token_time] if r.first_token_time else []) \
            + r.token_times
        assert all(b >= a for a, b in zip(ts, ts[1:]))
        assert r.first_token_time >= r.arrival_time


# ----------------------------------------------- tests/test_cost_model.py


def _prefill_only_plan(cfg, n_chunks: int, prompt_len: int):
    cm = CostModel(cfg, H100X2)
    total = 0.0
    chunk = prompt_len // n_chunks
    for i in range(n_chunks):
        plan = IterationPlan(prefill=[PrefillSlice(
            req_id=0, token_start=i * chunk, token_end=(i + 1) * chunk,
            block_start=0, block_end=cfg.n_layers)])
        total += cm.iteration_cost(plan, {})["expert_bytes"]
    return total


def test_chunking_amplifies_expert_bytes(qwen):
    one = _prefill_only_plan(qwen, 1, 8192)
    four = _prefill_only_plan(qwen, 4, 8192)
    sixteen = _prefill_only_plan(qwen, 16, 8192)
    assert one < four < sixteen
    assert sixteen / one > 8


def test_layered_prefill_has_no_amplification(qwen):
    cm = CostModel(qwen, H100X2)
    L = qwen.n_layers
    groups = [(i * L // 16, (i + 1) * L // 16) for i in range(16)]
    layered = 0.0
    for b0, b1 in groups:
        plan = IterationPlan(prefill=[PrefillSlice(
            req_id=0, token_start=0, token_end=8192,
            block_start=b0, block_end=b1)])
        layered += cm.iteration_cost(plan, {})["expert_bytes"]
    one_shot = _prefill_only_plan(qwen, 1, 8192)
    assert abs(layered - one_shot) / one_shot < 1e-9


def test_fig2_shape_load_inverse_in_chunk_size(qwen):
    loads = {c: _prefill_only_plan(qwen, 8192 // c, 8192)
             for c in (512, 1024, 2048, 4096)}
    assert loads[512] / loads[1024] == pytest.approx(2.0, rel=0.2)
    assert loads[1024] / loads[2048] == pytest.approx(2.0, rel=0.3)


def test_ridge_point_batch_threshold(qwen):
    cm = CostModel(qwen, H100X2)
    for prompt, bound in ((2048, "memory"), (16384, "compute")):
        plan = IterationPlan(prefill=[PrefillSlice(
            req_id=0, token_start=0, token_end=prompt,
            block_start=0, block_end=qwen.n_layers)])
        cost = cm.iteration_cost(plan, {})
        assert cost["bound"] == bound, (prompt, cost["bound"])


def test_decode_iteration_memory_bound(qwen):
    cm = CostModel(qwen, H100X2)
    reqs = {i: Request(req_id=i, prompt_len=2048, max_new_tokens=64,
                       n_generated=8) for i in range(16)}
    plan = IterationPlan(decode_ids=list(reqs))
    cost = cm.iteration_cost(plan, reqs)
    assert cost["bound"] == "memory"
    assert cost["duration"] > 0 and cost["energy"] > 0


def test_energy_scales_with_traffic(qwen):
    cm = CostModel(qwen, H100X2)
    p1 = IterationPlan(prefill=[PrefillSlice(0, 0, 512, 0, qwen.n_layers)])
    p2 = IterationPlan(prefill=[PrefillSlice(0, 0, 4096, 0, qwen.n_layers)])
    c1, c2 = cm.iteration_cost(p1, {}), cm.iteration_cost(p2, {})
    assert c2["energy"] > c1["energy"]
    assert c2["flops"] > 7 * c1["flops"]


def test_union_rule_no_double_count(qwen):
    cm = CostModel(qwen, H100X2)
    reqs = {0: Request(req_id=0, prompt_len=128, max_new_tokens=8,
                       n_generated=2)}
    big = PrefillSlice(1, 0, 8192, 0, qwen.n_layers)
    both = cm.iteration_cost(IterationPlan(decode_ids=[0], prefill=[big]),
                             reqs)
    alone = cm.iteration_cost(IterationPlan(prefill=[big]), reqs)
    assert both["expert_bytes"] < alone["expert_bytes"] * 1.02


def test_ridge_point_constants():
    assert TPU_V5E.ridge_op_per_byte == pytest.approx(197e12 / 819e9)
    assert H100X2.ridge_op_per_byte == pytest.approx(989e12 / 3.35e12)


def test_coverage_monotone_saturating():
    prev = 0.0
    for n in (1, 2, 4, 8, 16, 64, 256, 1024):
        c = expected_coverage(128, 8, n)
        assert c > prev
        prev = c
    assert prev <= 128.0


# ------------------------------ tests/test_runtime.py, the SimExecutor half


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_trace_replay_equivalence_engine_vs_sim(mode):
    """The same oversubscribed multi-class trace on the iteration clock
    through the PORT's engine and the port's SimExecutor: identical plan
    streams and per-request timelines, and the engine's replayed tokens
    equal an unconstrained closed-loop run."""
    cfg = tiny_dense()
    trace = mixed_trace()
    kw = dict(page_size=4, decode_reserve=1, preemption_mode=mode)

    eng = build("torch", cfg, "layered", pages=16, **kw)
    eng_rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                            record_plans=True)
    eng_res = eng_rt.run(trace, max_iterations=100_000)

    sim_sched = make_scheduler("layered", eng.model.n_blocks, n_slots=4,
                               quantum=8, token_budget=16)
    sim = Simulator(port_cfg(cfg), sim_sched, H100X2, n_pages=16, **kw)
    sim_rt = ServingRuntime(SimExecutor(sim), clock="iteration",
                            record_plans=True)
    sim_res = sim_rt.run(trace, max_iterations=100_000)

    assert [plan_key(p) for p in eng_rt.plans] \
        == [plan_key(p) for p in sim_rt.plans]
    assert eng_res.n_iterations == sim_res.n_iterations
    assert eng_res.n_preemptions == sim_res.n_preemptions
    assert eng_res.n_swap_outs == sim_res.n_swap_outs
    if mode == "swap":
        assert eng_res.n_swap_outs > 0, "scenario must actually swap"
    else:
        assert eng_res.n_preemptions > 0, "scenario must actually preempt"
    for er, sr in zip(eng_res.requests, sim_res.requests):
        assert _request_record(er) == _request_record(sr)

    free = build("torch", cfg, "layered")
    for tr in trace:
        free.submit(list(tr.prompt_tokens), tr.output_len,
                    slo_class=tr.slo_class)
    free.run(max_iterations=100_000)
    assert eng.outputs == free.outputs
    assert eng.alloc.pages_in_use() == 0


def test_sim_streaming_tokens_are_placeholders():
    cfg = port_cfg(tiny_dense())
    events = []
    sim = Simulator(cfg, "layered", H100X2, n_slots=8, quantum=16,
                    token_budget=64)
    trace = [TraceRequest(i * 0.5, 8, 4) for i in range(6)]
    res = sim.run(trace, on_token=lambda rid, tok, t:
                  events.append((rid, tok, t)))
    assert len(events) == sum(r.n_generated for r in res.requests)
    assert all(tok is None for _, tok, _ in events)


@pytest.mark.parametrize("extra", [[], ["--disagg"],
                                   ["--scheduler", "chunked", "--dataset",
                                    "sharegpt", "--preemption", "swap",
                                    "--pages", "2000", "--spec", "ngram"]])
def test_launcher_simulate_prints_jax_lines(extra, capsys):
    """``python -m repro_torch.launch.serve --simulate`` prints the JAX
    launcher's ``[serve-sim]`` report line for line, two pools
    included."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--simulate", "--requests", "12", "--rate", "1.3"] + extra
    serve.main(argv)
    ours = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        jax_serve.main()
    finally:
        sys.argv = saved
    theirs = capsys.readouterr().out
    assert ours.startswith("[serve-sim]") and ours == theirs
