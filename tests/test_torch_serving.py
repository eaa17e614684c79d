"""Swap preemption, prefix caching and open-loop replay in the port's
engine, on the CPU in fp32: the port's counterparts of the engine tests
of tests/test_swap.py, tests/test_prefix_cache.py and tests/test_runtime.py,
plus port-vs-JAX identity (plans, token streams, swap counts, prefix hits
and restores, TTFT/TBT in iterations) on the same weights and traces."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_parity as parity
from conftest import tiny_dense, tiny_moe
from repro_torch.core.base import make_scheduler
from repro_torch.core.plan import RequestState
from repro_torch.launch.config import ServeConfig
from repro_torch.launch.serve import serve_real
from repro_torch.serving.engine import Engine
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from repro_torch.serving.traffic import TraceRequest, shared_prefix_trace
from test_torch_model import models


def _engine(cfg, sched_name, **eng_kw):
    _, _, tm, tp = models(cfg)
    sched = make_scheduler(sched_name, tm.n_blocks, n_slots=4, quantum=8,
                           token_budget=eng_kw.pop("token_budget", 16))
    return Engine(tm, tp, sched, n_slots=4, max_len=64, **eng_kw)


def _run_engine(cfg, sched_name, jobs, **eng_kw):
    eng = _engine(cfg, sched_name, **eng_kw)
    for prompt, max_new in jobs:
        eng.submit(prompt, max_new)
    eng.run(max_iterations=100_000)
    return eng


def _oversub_jobs():
    rng = np.random.default_rng(0)
    return [(list(rng.integers(1, 200, int(rng.integers(4, 10)))), 12)
            for _ in range(32)]


SWAP_KW = dict(pages=16, page_size=4, decode_reserve=1)


# ------------------------------------------------------------------ swap


@pytest.mark.parametrize("sched", ["layered", "chunked"])
def test_engine_oversubscribed_swap_matches_unconstrained(sched):
    """32 requests into a ~3-resident pool under swap mode complete via
    host-backed eviction with tokens identical to an unconstrained run."""
    cfg = tiny_dense()
    jobs = _oversub_jobs()
    tight = _run_engine(cfg, sched, jobs, preemption_mode="swap", **SWAP_KW)
    assert tight.n_swapped_out > 0, "scenario must actually swap"
    assert tight.n_swapped_out == tight.n_swapped_in
    assert tight.alloc.pages_in_use() == 0
    assert tight.alloc.host_pages_in_use() == 0
    assert not tight.host_kv                # every host copy consumed

    free = _run_engine(cfg, sched, jobs)    # unconstrained pool
    assert free.n_swapped_out == 0
    assert tight.outputs == free.outputs, "swap changed generated tokens"
    swapped = [rid for rid, r in tight.requests.items() if r.n_swaps > 0]
    assert swapped
    for rid in swapped:
        assert len(tight.outputs[rid]) == 12


@pytest.mark.parametrize("mode", ["swap", "auto"])
@pytest.mark.parametrize("sched", ["layered", "chunked"])
def test_swap_matches_jax_engine(sched, mode):
    """Identical plans (swap-outs and swap-ins included), tokens, swap and
    preemption counts, TTFTs and expert bytes."""
    kw = dict(SWAP_KW, preemption_mode=mode)
    want = parity.run("jax", tiny_moe(), sched, jobs=_oversub_jobs(), **kw)
    got = parity.run("torch", tiny_moe(), sched, jobs=_oversub_jobs(), **kw)
    parity.assert_same(got, want)
    assert got["n_swapped_out"] == got["n_swapped_in"] > 0
    assert got["pages_left"] == got["host_pages_left"] == 0


def test_engine_doubly_swapped_victim_tokens_identical():
    """The SAME request through two swap-out/swap-in cycles: the restored
    KV must continue the greedy decode exactly, and nothing is folded into
    the prompt.  The freed slot row is overwritten before each swap-in, as
    a later occupant's prefill would: a host copy that aliased the slot
    would restore those values."""
    cfg = tiny_dense()
    eng = _engine(cfg, "layered", preemption_mode="swap")
    sched = eng.scheduler
    rid = eng.submit(list(range(1, 9)), 12)
    forced = []
    while sched.has_work():
        r = eng.requests[rid]
        if r.state == RequestState.DECODE and r.n_generated in (3, 7) \
                and r.n_generated not in forced:
            slot = eng._slot_of[rid]
            sched.swap_out(rid)           # what the pressure pass would do
            eng._swap_out(rid)            # what step() would execute
            for seg in eng.cache:
                for leaf in seg:
                    for buf in leaf.values():
                        buf[:, slot].fill_(0.5)
            forced.append(r.n_generated)
        eng.step()
    assert forced == [3, 7]
    assert eng.requests[rid].n_swaps == 2
    assert eng.requests[rid].n_preemptions == 0
    assert eng.requests[rid].prompt_len == 8     # no recompute fold
    clean = _run_engine(cfg, "layered", [(list(range(1, 9)), 12)])
    assert eng.outputs[rid] == clean.outputs[0]
    assert len(eng.outputs[rid]) == 12


def test_swap_copies_only_the_filled_positions():
    """A swap victim's host copy holds every layer's K/V for positions
    [0, offset) of its slot row, equal to the row at swap-out time."""
    cfg = tiny_dense()
    eng = _engine(cfg, "layered", preemption_mode="swap")
    rid = eng.submit(list(range(1, 12)), 6)
    while eng.requests[rid].n_generated < 3:
        eng.step()
    slot = eng._slot_of[rid]
    offset = int(eng.offsets[slot])
    want = [c["k"][:, slot, :offset].clone() for seg in eng.cache
            for c in seg]
    eng.scheduler.swap_out(rid)
    eng._swap_out(rid)
    row, off, _ = eng.host_kv[rid]
    assert off == offset
    got = [c["k"] for seg in row for c in seg]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.data_ptr() != c["k"].data_ptr() for g, seg in
               zip(got, eng.cache) for c in seg)
    assert all(bool((g == w).all()) for g, w in zip(got, want))


# ----------------------------------------------------------- prefix cache


def _shared_jobs(seed, n=6, prefix_len=24, suffix=4, out=4):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(1, 97, prefix_len)) for _ in range(2)]
    return [(list(map(int, prefixes[int(rng.integers(2))]))
             + [int(x) for x in rng.integers(1, 97, suffix)], out)
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_tokens_identical_cache_on_vs_off(mode):
    """Identical greedy streams with caching on, in both preemption
    modes, with the cache actually hitting and the allocator fully
    drained at the end."""
    cfg = tiny_dense()
    jobs = _shared_jobs(0)
    kw = dict(pages=40, page_size=4, preemption=True, preemption_mode=mode,
              host_pages=160 if mode == "swap" else None, decode_reserve=0,
              token_budget=64)
    off = _run_engine(cfg, "layered", jobs, prefix_cache=False, **kw)
    on = _run_engine(cfg, "layered", jobs, prefix_cache=True, **kw)
    assert on.outputs == off.outputs
    assert on.alloc.n_prefix_hits > 0 and on.alloc.n_prefix_tokens > 0
    assert on.n_prefix_restores > 0
    on.alloc.check_invariants()
    assert on.alloc.pages_in_use() == 0
    assert all(r == 0 for r in on.alloc._refs.values())


def test_mixed_cohort_packed_regression():
    """A warm restored request admitted into the SAME layered cohort as a
    cold full prompt: the warm row is bucket-padded to the cold row's
    window, so its padded tokens' KV writes land past its offset and must
    be dropped, not written over the restored prefix (the per-token
    scatter of models/attention._write_cache)."""
    cfg = tiny_dense()
    rng = np.random.default_rng(7)
    pfx = [int(x) for x in rng.integers(1, 97, 24)]
    cold = [int(x) for x in rng.integers(1, 97, 28)]
    warm_sfx = [int(x) for x in rng.integers(1, 97, 4)]

    def run(cache_on):
        eng = _engine(cfg, "layered", page_size=4, prefix_cache=cache_on,
                      token_budget=64)
        eng.submit(pfx + [int(x) for x in rng.integers(1, 97, 4)], 2)
        eng.run(max_iterations=10_000)       # registers the prefix
        eng.submit(cold, 2)                  # cold: other prompt
        eng.submit(pfx + warm_sfx, 2)        # warm: same cohort as cold
        eng.run(max_iterations=10_000)
        if cache_on:
            assert eng.n_prefix_restores == 1
        return eng.outputs

    rng_state = rng.bit_generator.state
    base = run(False)
    rng.bit_generator.state = rng_state      # same first-job suffix
    assert run(True) == base


PREFIX_TRACE = shared_prefix_trace(10, n_prefixes=2, prefix_len=24,
                                   suffix_len=4, output_len=4, rate=0.5,
                                   vocab_size=97, seed=3)


@pytest.mark.parametrize("sched", ["layered", "chunked"])
def test_prefix_cache_matches_jax_engine(sched):
    """An open-loop shared-prefix replay: identical plans, tokens, hits,
    cached tokens, restores and TTFT/TBT in iterations."""
    kw = dict(page_size=4, sched_kw=dict(token_budget=64))
    want = parity.run("jax", tiny_moe(n_layers=4), sched,
                      trace=PREFIX_TRACE, **kw)
    got = parity.run("torch", tiny_moe(n_layers=4), sched,
                     trace=PREFIX_TRACE, **kw)
    parity.assert_same(got, want)
    assert got["n_prefix_hits"] > 0 and got["n_prefix_restores"] > 0


def test_prefix_rows_are_copies_cut_at_the_deepest_chain():
    """Each cached row is a copy of positions [0, deepest chain x
    page_size) — not a view of the slot — and the allocator's reclaim
    hook drops it with its index entry."""
    cfg = tiny_dense()
    eng = _engine(cfg, "layered", page_size=4, prefix_lru_pages=4,
                  token_budget=64)
    eng.submit(list(range(1, 15)), 2)        # 3 full pages of 4 + 2
    eng.run()
    assert eng._prefix_rows
    first = dict(eng._prefix_rows)
    row, usable = max(first.values(), key=lambda v: v[1])
    assert usable == 12
    k = row[0][0]["k"]
    assert k.shape[1] == 12
    assert k.data_ptr() != eng.cache[0][0]["k"].data_ptr()
    for i in range(3):                       # other prompts evict it
        eng.submit(list(range(20 + 20 * i, 36 + 20 * i)), 2)
        eng.run()
    assert eng.alloc.n_prefix_evictions > 0
    assert set(eng._prefix_rows) <= set(eng.alloc._index)
    assert not set(first) & set(eng._prefix_rows)


# -------------------------------------------------------------- open loop


def test_engine_open_loop_idles_to_next_arrival():
    """A huge arrival gap must fast-forward the clock, not spin
    iterations."""
    eng = _engine(tiny_dense(), "layered")
    trace = [TraceRequest(0.0, 5, 4, prompt_tokens=(1, 2, 3, 4, 5)),
             TraceRequest(1000.0, 5, 4, prompt_tokens=(9, 8, 7, 6, 5))]
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    res = rt.run(trace, max_iterations=500)   # << 1000: no spin allowed
    assert res.clock >= 1000.0
    assert res.n_iterations < 500
    late = res.requests[1]
    assert late.arrival_time == 1000.0
    assert late.admit_time >= 1000.0
    assert late.first_token_time > 1000.0
    assert all(len(eng.outputs[r.req_id]) == 4 for r in res.requests)


def test_engine_wall_clock_replay_sleeps_to_arrivals():
    """wall=True: arrival times are real seconds — the runtime sleeps
    through the gap and timestamps in wall time."""
    eng = _engine(tiny_dense(), "layered")
    trace = [TraceRequest(0.0, 4, 3, prompt_tokens=(1, 2, 3, 4)),
             TraceRequest(0.3, 4, 3, prompt_tokens=(4, 3, 2, 1))]
    rt = ServingRuntime(EngineExecutor(eng, wall=True), clock="executor")
    res = rt.run(trace, max_iterations=10_000)
    assert res.clock >= 0.3                     # really waited
    assert all(len(eng.outputs[r.req_id]) == 3 for r in res.requests)
    r1 = res.requests[1]
    assert r1.first_token_time > r1.arrival_time


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_open_loop_replay_matches_jax_engine(arrival):
    """``ServeConfig.engine_trace`` replayed on the iteration clock
    through both engines: identical plans, tokens, and TTFT/TBT in
    iterations; a batch-class share makes the mix two-class."""
    sc = ServeConfig(requests=10, max_len=64, rate=0.6, arrival=arrival,
                     batch_fraction=0.3, seed=2).validate()
    trace = sc.engine_trace(256)
    kw = dict(pages=24, page_size=4, decode_reserve=1,
              class_headroom={"interactive": 2})
    want = parity.run("jax", tiny_moe(), "layered", trace=trace, **kw)
    got = parity.run("torch", tiny_moe(), "layered", trace=trace, **kw)
    parity.assert_same(got, want)
    assert max(t for t in got["ttft"].values()) > 1


def test_launcher_open_loop_serve_on_the_cpu(capsys):
    """The launcher's open-loop branch with the default prefix cache and
    swap preemption: the report carries the prefix-cache and swap lines
    and every request of the trace completes."""
    sc = ServeConfig(smoke=True, device="cpu", open_loop=True, requests=6,
                     rate=2.0, slots=4, max_len=96, preemption="swap",
                     batch_fraction=0.5).validate()
    r = serve_real(sc)
    out = capsys.readouterr().out
    assert "(open-loop" in out and "[serve] prefix cache:" in out
    assert "[serve] swap:" in out and "class batch" in out
    assert r["completed"] == r["requests"] == 6
    assert r["clock_unit"] == "iters"
