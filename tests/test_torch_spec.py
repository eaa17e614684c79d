"""Speculative verify-k decoding in the port's engine, on the CPU in fp32:
the engine half of tests/test_spec_decode.py.  Port-vs-JAX identity on
the same weights and traces (plans, token streams, proposal and
acceptance counts, what each iteration verified, expert bytes), for the
n-gram drafter and the draft model, under recompute and swap pressure, is
in tests/test_torch_spec_jax.py.

The draft runs as the JAX engine's does (``forward`` with its defaults:
the capacity-limited dense MoE dispatch over the padded batch), so MoE
drafts are held against JAX as well as dense ones.

Not ported from tests/test_spec_decode.py:

  * ``test_verify_executables_join_bounded_lru`` — the port runs eagerly
    and has no executable cache, so there is no LRU for verify and draft
    executables to join (and no ``n_verify_compiles``);
  * ``test_sim_spec_token_counts_match_off`` and
    ``test_sim_spec_deterministic_per_seed`` — they drive the analytic
    simulator, which the port does not have yet (ROADMAP §1 item 9).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro_torch.core.base import make_scheduler
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import request_metrics
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from repro_torch.serving.spec import (NgramDrafter, accepted_prefix,
                                      build_draft_model)
from repro_torch.serving.traffic import TraceRequest
from test_runtime import _mixed_trace as jax_mixed_trace
from test_torch_model import models


def _mixed_trace(**kw):
    """tests/test_runtime.py's multi-class oversubscribed trace, as the
    port's TraceRequests."""
    return [TraceRequest(r.arrival_time, r.prompt_len, r.output_len,
                         slo_class=r.slo_class, prompt_tokens=r.prompt_tokens)
            for r in jax_mixed_trace(**kw)]


def _make_engine(cfg, sched_name, **eng_kw):
    """tests/test_runtime.py's engine: 4 slots, max_len 64, quantum 8,
    budget 16, on the JAX init of seed 0."""
    _, _, tm, tp = models(cfg)
    sched = make_scheduler(sched_name, tm.n_blocks, n_slots=4, quantum=8,
                           token_budget=16)
    return Engine(tm, tp, sched, n_slots=4, max_len=64, **eng_kw)


def _draft_kw(cfg, *, self_draft):
    """The target as its own draft (seed 0: acceptance -> 1, the
    all-accept path) or a differently seeded twin (mostly rejects)."""
    _, _, tm, tp = models(cfg, seed=0 if self_draft else 7)
    return dict(draft_model=tm, draft_params=tp)


def _run_trace(cfg, trace, mode, **eng_kw):
    eng = _make_engine(cfg, "layered", pages=16, page_size=4,
                       decode_reserve=1, preemption_mode=mode, **eng_kw)
    ServingRuntime(EngineExecutor(eng), clock="iteration").run(
        trace, max_iterations=100_000)
    return eng


# ------------------------------------------------------- bit-exact streams

@pytest.mark.parametrize("mode", ["recompute", "swap"])
@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_spec_streams_bit_identical_under_pressure(spec, mode):
    """Oversubscribed replay (evictions and restores happen) with
    speculation on: every request's token stream equals the spec-off run,
    and the allocator ends clean (no page leaked by any rollback)."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    base = _run_trace(cfg, trace, mode)
    kw = dict(spec_mode=spec, spec_k=3)
    if spec == "draft":
        kw.update(_draft_kw(cfg, self_draft=True))
    eng = _run_trace(cfg, trace, mode, **kw)

    assert eng.outputs == base.outputs, "speculation changed token values"
    assert eng.n_verify_dispatches > 0, "speculation never engaged"
    if spec == "draft":
        # self-draft: the proposals ARE the target argmax
        assert eng.n_spec_accepted == eng.n_spec_proposed > 0
    assert eng.alloc.pages_in_use() == 0
    assert not eng.alloc._spec_base, "stranded speculative reservation"
    assert base.n_preempted + base.n_swapped_out > 0


def test_rejecting_draft_model_still_bit_identical():
    """A mostly WRONG drafter (a differently seeded twin) exercises the
    rollback path hard; outputs still must not change."""
    cfg = tiny_dense()
    trace = _mixed_trace(n=12, seed=3, spread=10)
    base = _run_trace(cfg, trace, "recompute")
    eng = _run_trace(cfg, trace, "recompute", spec_mode="draft", spec_k=3,
                     spec_adaptive=False, **_draft_kw(cfg, self_draft=False))
    assert eng.outputs == base.outputs
    assert eng.n_verify_dispatches > 0
    assert eng.alloc.pages_in_use() == 0


REPETITIVE = [[7, 8, 9] * 4, [3, 4] * 5, [5, 6, 7, 5, 6, 7, 5, 6]]


def test_ngram_closed_loop_repetitive_prompts():
    """Closed-loop drain with repetitive-suffix prompts: the n-gram
    drafter engages (proposes > 0, accepts > 0) and still matches spec-off
    bit for bit in fewer iterations; per-iteration spec reservations never
    outlive their iteration."""
    cfg = tiny_dense()

    def drain(**kw):
        eng = _make_engine(cfg, "layered", **kw)
        for p in REPETITIVE:
            eng.submit(list(p), 24)
        while eng.scheduler.has_work():
            eng.step()
            assert not eng.alloc._spec_base, \
                "spec reservation leaked across iterations"
        return eng

    base = drain()
    eng = drain(spec_mode="ngram", spec_k=4)
    assert eng.outputs == base.outputs
    assert eng.n_spec_proposed > 0, "n-gram drafter never proposed"
    assert eng.n_spec_accepted > 0, "nothing accepted on repetitive prompts"
    assert eng.iteration < base.iteration
    for r in eng.requests.values():
        assert r.n_generated <= r.max_new_tokens
        assert len(eng.outputs[r.req_id]) == r.n_generated


def test_spec_respects_max_new_tokens_budget():
    """The budget cap k <= max_new - n_generated - 1: a request one token
    from done never speculates past its limit."""
    eng = _make_engine(tiny_dense(), "layered", spec_mode="ngram", spec_k=8)
    eng.submit([1, 2] * 6, 3)
    eng.run(max_iterations=1_000)
    (r,) = eng.requests.values()
    assert r.n_generated == 3
    assert len(eng.outputs[r.req_id]) == 3


# ---------------------------------------------------- hot-path contracts

@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_one_host_sync_per_iteration_with_spec(spec, monkeypatch):
    """Draft and verify join the iteration's single ``.cpu()``: no
    iteration fetches twice, and nothing calls ``.item()``/``.tolist()``
    on a tensor (each a sync on the card)."""
    cfg = tiny_dense()
    kw = dict(spec_mode=spec, spec_k=3)
    if spec == "draft":
        kw.update(_draft_kw(cfg, self_draft=True))
    eng = _make_engine(cfg, "layered", **kw)
    for p in ([7, 8, 9] * 3, [1, 2] * 4, [4, 5, 6, 4, 5, 6]):
        eng.submit(list(p), 8)
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
    assert eng.n_spec_proposed > 0 and eng.n_verify_dispatches > 0


# ------------------------------------------------------------- unit level

def test_ngram_drafter_proposals():
    d = NgramDrafter(max_n=3)
    h = np.array([5, 6, 7, 9, 5, 6, 7])
    np.testing.assert_array_equal(d.propose(h, 2), [9, 5])   # trigram match
    assert len(d.propose(np.array([1, 2, 3]), 4)) == 0       # no repeat
    # longest n wins over a more recent shorter match
    h2 = np.array([1, 2, 9, 3, 1, 2, 8, 1, 2, 9])
    np.testing.assert_array_equal(d.propose(h2, 1), [3])


def test_ngram_drafter_matches_jax():
    """The copied drafter proposes what the JAX package's does on random
    periodic and aperiodic histories."""
    from repro.serving.spec import NgramDrafter as JaxNgramDrafter
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 4):
        ours, theirs = NgramDrafter(n), JaxNgramDrafter(n)
        for _ in range(40):
            period = int(rng.integers(1, 6))
            h = np.tile(rng.integers(0, 6, period), 6)[:int(rng.integers(2, 30))]
            if rng.random() < 0.5:
                h = rng.integers(0, 5, len(h))
            for k in (1, 3, 5):
                np.testing.assert_array_equal(ours.propose(h, k),
                                              theirs.propose(h, k))


def test_accepted_prefix():
    assert accepted_prefix(np.array([1, 2, 3]), np.array([1, 2, 3])) == 3
    assert accepted_prefix(np.array([1, 9, 3]), np.array([1, 2, 3])) == 1
    assert accepted_prefix(np.array([9]), np.array([1])) == 0
    assert accepted_prefix(np.array([], np.int64), np.array([1])) == 0


def test_engine_rejects_bad_spec_config():
    cfg = tiny_dense()
    with pytest.raises(ValueError, match="spec_mode"):
        _make_engine(cfg, "layered", spec_mode="warp")
    with pytest.raises(ValueError, match="draft"):
        _make_engine(cfg, "layered", spec_mode="draft")
    other = models(tiny_dense(vocab_size=128))
    with pytest.raises(ValueError, match="vocab"):
        _make_engine(cfg, "layered", spec_mode="draft",
                     draft_model=other[2], draft_params=other[3])


def test_build_draft_model():
    """A registered config's smoke variant on the CPU from an explicit
    generator (same seed, same weights); a vocab mismatch raises."""
    m1, p1 = build_draft_model("qwen3-30b-a3b", 512, seed=3, device="cpu")
    _, p2 = build_draft_model("qwen3-30b-a3b", 512, seed=3, device="cpu")
    assert m1.cfg.name == "qwen3-30b-a3b-smoke" and m1.device.type == "cpu"
    assert torch.equal(p1["embed"]["tok"], p2["embed"]["tok"])
    with pytest.raises(ValueError, match="vocab"):
        build_draft_model("qwen3-30b-a3b", 1000, device="cpu")
    eng = _make_engine(tiny_dense(vocab_size=512), "layered",
                       spec_mode="draft", draft_config="phi4-mini-3.8b")
    assert eng.draft_model.cfg.name == "phi4-mini-3.8b-smoke"
    eng.submit([5, 6, 7] * 3, 6)
    eng.run(max_iterations=1_000)
    assert eng.n_draft_dispatches > 0 and len(eng.outputs[0]) == 6


def test_metrics_report_acceptance():
    eng = _make_engine(tiny_dense(), "layered", spec_mode="ngram", spec_k=4)
    for p in ([7, 8, 9] * 3, [1, 2] * 4):
        eng.submit(list(p), 10)
    eng.run(max_iterations=1_000)
    m = request_metrics(eng.requests.values())
    assert m["spec_drafted"] == eng.n_spec_proposed > 0
    assert 0.0 <= m["spec_acceptance_rate"] <= 1.0
    assert m["accepted_len_p50"] >= 0.0
    assert m["accepted_len_p90"] >= m["accepted_len_p50"]
    logged = sum(e["n_verify_tokens"] for e in eng.iter_log)
    assert logged == eng.n_spec_proposed
