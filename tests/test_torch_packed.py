"""The port's per-slice prefill path (``Engine(packed=False)``) against its
packed path and the JAX package's per-slice path, on the same weights in
fp32 on the CPU: ``tests/test_engine_packed.py``'s equivalence and
dispatch-count tests run on the port, with the JAX engine as the
reference.  Tokens, plans, expert-load bytes, the per-iteration page
counters and the dispatch counts are held EXACTLY.  The JAX test's
``n_prefill_compiles`` has no counterpart: the port runs eagerly and keeps
no executable cache."""

from __future__ import annotations

import pytest
import torch

from _torch_parity import build, mixed_trace, run
from conftest import tiny_dense, tiny_moe
from repro.core.base import make_scheduler as jax_make_scheduler
from repro.serving.engine import Engine as JaxEngine
from repro_torch.serving.engine import Engine
from test_torch_model import models

ITER_KEYS = ("iteration", "n_decode", "prefill_tokens", "expert_load_bytes",
             "pages_in_use", "host_pages_in_use", "n_preempted",
             "n_swapped_out", "n_swapped_in")


def _replay(framework, packed, mode):
    """The multi-class oversubscribed trace on a ~3-resident pool (the
    regime where cohorts, evictions and swap-ins coexist in one plan),
    with the engine's per-iteration log."""
    logs = []
    orig = Engine.execute_plan if framework == "torch" \
        else JaxEngine.execute_plan

    def execute_plan(self, plan):
        events = orig(self, plan)
        logs.append({k: self.iter_log[-1][k] for k in ITER_KEYS})
        return events
    cls = Engine if framework == "torch" else JaxEngine
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "execute_plan", execute_plan)
        rec = run(framework, tiny_moe(), "layered", trace=mixed_trace(),
                  packed=packed, pages=16, page_size=4, decode_reserve=1,
                  preemption_mode=mode)
    rec["iter_log"] = logs
    return rec


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_per_slice_matches_packed_and_jax(mode):
    """Port per-slice == port packed == JAX per-slice: plans, tokens,
    expert-load bytes and page counters; the per-slice dispatch counts
    equal JAX's and exceed the packed path's."""
    ps = _replay("torch", False, mode)
    pk = _replay("torch", True, mode)
    jps = _replay("jax", False, mode)
    if mode == "swap":
        assert pk["n_swapped_out"] > 0, "scenario must actually swap"
    else:
        assert pk["n_preempted"] > 0, "scenario must actually preempt"
    for key in ("plans", "outputs", "expert_load_bytes", "iter_log",
                "ttft", "token_times", "n_preempted", "n_swapped_out"):
        assert ps[key] == pk[key] == jps[key], key
    assert ps["expert_load_bytes"] > 0
    assert ps["n_dispatches"] == jps["n_dispatches"]
    assert pk["n_dispatches"] < ps["n_dispatches"]
    assert ps["pages_left"] == 0


def _jax_engine(cfg, packed, n_slots):
    jm, jp, _, _ = models(cfg)
    sched = jax_make_scheduler("layered", jm.n_blocks, n_slots=n_slots,
                               quantum=8, token_budget=16)
    return JaxEngine(jm, jp, sched, n_slots=n_slots, max_len=64,
                     packed=packed)


def test_per_slice_dispatch_count_regression():
    """A mixed-shape cohort of 6 co-resident prefills: per-slice launches
    one prefill per (request x group), packed one per group, >= 2x fewer;
    both paths' counts equal the JAX engine's, and the tokens agree."""
    cfg = tiny_dense(n_layers=4)
    jobs = [list(range(1, n)) for n in (11, 21, 13, 25, 15, 29)]

    def go(eng):
        for p in jobs:
            eng.submit(p, 4)
        eng.run(max_iterations=10_000)
        return eng

    sched_kw = dict(n_slots=8)
    pk = go(build("torch", cfg, "layered", sched_kw, n_slots=8))
    ps = go(build("torch", cfg, "layered", sched_kw, n_slots=8,
                  packed=False))
    jpk, jps = go(_jax_engine(cfg, True, 8)), go(_jax_engine(cfg, False, 8))
    assert pk.outputs == ps.outputs
    assert {r: [int(t) for t in v] for r, v in jps.outputs.items()} \
        == ps.outputs
    assert pk.n_prefill_dispatches * 2 <= ps.n_prefill_dispatches
    assert pk.n_dispatches < ps.n_dispatches
    for ours, theirs in ((pk, jpk), (ps, jps)):
        assert (ours.n_dispatches, ours.n_prefill_dispatches) \
            == (theirs.n_dispatches, theirs.n_prefill_dispatches)
    assert pk.expert_load_bytes == ps.expert_load_bytes \
        == jps.expert_load_bytes


def test_per_slice_one_host_sync_per_iteration(monkeypatch):
    """Per-slice launches more batches but fetches once: no iteration
    calls ``.cpu()`` twice, nor ``.item()``/``.tolist()``."""
    eng = build("torch", tiny_dense(), "layered", packed=False, pages=16,
                page_size=4, decode_reserve=1, preemption_mode="swap")
    for i in range(8):
        eng.submit([1 + i, 2, 3, 4, 5, 6][:4 + i % 3], 10)
    calls = []
    for name in ("cpu", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    while eng.scheduler.has_work():
        n0 = len(calls)
        eng.step()
        assert calls[n0:] in ([], ["cpu"]), calls[n0:]
    assert all(len(t) == 10 for t in eng.outputs.values())
