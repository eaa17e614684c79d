"""Speculative verify-k decoding, the port against the JAX engine, on the
CPU in fp32: the spec engine replaying the same traces as JAX's (plans,
token streams, proposal and acceptance counts, what each iteration
verified, expert bytes) for the n-gram drafter and dense and MoE draft
models under recompute and swap pressure, the self-draft engines, and the
draft step itself.  Split from tests/test_torch_spec.py so that neither
file sets the wall of a ``--dist loadfile`` run alone: the JAX side of
these replays takes most of their time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity as parity
from conftest import tiny_dense, tiny_moe
from test_torch_spec import REPETITIVE, _draft_kw, _make_engine, _mixed_trace


# ------------------------------------------------- the port against JAX

SWAP_KW = dict(pages=16, page_size=4, decode_reserve=1)


@pytest.mark.parametrize("mode", ["recompute", "swap"])
@pytest.mark.parametrize("spec", ["ngram", "draft", "moe-draft"])
@pytest.mark.parametrize("make_cfg", [tiny_moe, tiny_dense])
def test_spec_engine_matches_jax_engine(make_cfg, spec, mode):
    """The oversubscribed trace through both engines with speculation on:
    identical plans, token streams, proposal and acceptance counts, what
    each iteration verified, expert bytes and swap/preemption counts.
    "draft" is tiny_dense at seed 7 (a twin of the dense target, a dense
    draft of the MoE one; it mostly rejects); "moe-draft" is tiny_moe at
    seed 7 (a twin of the MoE target, an MoE draft of the dense one),
    whose capacity-limited dispatch over the padded batch the two engines
    must run alike."""
    cfg = make_cfg()
    kw = dict(SWAP_KW, preemption_mode=mode, spec_mode="draft" if "draft"
              in spec else spec, spec_k=3)
    if spec == "draft":
        kw["draft"] = (tiny_dense(), 7)
    elif spec == "moe-draft":
        kw["draft"] = (tiny_moe(), 7)
    trace = _mixed_trace()
    want = parity.run("jax", cfg, "layered", trace=trace, **kw)
    got = parity.run("torch", cfg, "layered", trace=trace, **kw)
    parity.assert_same(got, want)
    assert got["n_verify_dispatches"] > 0
    assert got["n_preempted"] + got["n_swapped_out"] > 0


@pytest.mark.parametrize("sched", ["chunked", "hybrid"])
def test_self_draft_engine_matches_jax_engine(sched):
    """tiny_dense drafting for itself (seed 0) under the chunked and the
    hybrid scheduler, closed loop on repetitive prompts: identical to
    JAX, every proposal accepted."""
    cfg = tiny_dense()
    jobs = [(p, 12) for p in REPETITIVE]
    kw = dict(spec_mode="draft", spec_k=4, draft=(cfg, 0))
    want = parity.run("jax", cfg, sched, jobs=jobs, **kw)
    got = parity.run("torch", cfg, sched, jobs=jobs, **kw)
    parity.assert_same(got, want)
    assert got["n_spec_accepted"] == got["n_spec_proposed"] > 0


def test_moe_self_draft_engine_matches_jax_engine():
    """tiny_moe drafting for itself, closed loop on repetitive prompts with
    several rows drafting at once: the capacity-limited draft dispatch
    over the padded batch drops real tokens where padding fills an
    expert, in both engines alike — identical plans, streams, proposal
    and acceptance counts."""
    cfg = tiny_moe()
    jobs = [(p, 12) for p in REPETITIVE + [[9, 1, 9, 2, 9, 3]]]
    kw = dict(spec_mode="draft", spec_k=4, draft=(cfg, 0))
    want = parity.run("jax", cfg, "layered", jobs=jobs, **kw)
    got = parity.run("torch", cfg, "layered", jobs=jobs, **kw)
    parity.assert_same(got, want)
    assert got["n_spec_proposed"] > 0
    assert max(rows for _, _, rows in got["spec_log"]) > 1


def _roomy_moe():
    """tiny_moe with a capacity factor at which the draft's dense
    dispatch keeps every assignment (C = the token count): E / top_k."""
    cfg = tiny_moe()
    return tiny_moe(moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))


@pytest.mark.parametrize("moe_dispatch", ["ragged", "dense"])
def test_moe_self_draft_accepts_every_proposal(moe_dispatch):
    """An MoE model drafting for itself, four rows at once, at a capacity
    that never binds: the draft's forward over the padded batch is then
    the target's own function, so every proposal is the target's greedy
    token, under either dispatch of the target."""
    cfg = _roomy_moe()
    eng = _make_engine(cfg, "layered", spec_mode="draft", spec_k=4,
                       moe_dispatch=moe_dispatch,
                       **_draft_kw(cfg, self_draft=True))
    for p in REPETITIVE + [[9, 1, 9, 2, 9, 3]]:
        eng.submit(list(p), 12)
    eng.run(max_iterations=1_000)
    assert eng.n_spec_accepted == eng.n_spec_proposed > 0
    assert max(e["n_spec_rows"] for e in eng.iter_log) > 1


def _draft_batch():
    rng = np.random.default_rng(6)
    hist = rng.integers(1, 200, (4, 32))
    lens = np.array([7, 30, 16, 22], np.int32)
    return hist, lens


def test_draft_proposals_do_not_depend_on_the_batch():
    """Where the draft's capacity does not bind (a dense draft, or an MoE
    one with room for every assignment), a row's proposals are the same
    alone and beside other rows of other lengths and their padding."""
    for cfg in (tiny_dense(), _roomy_moe()):
        eng = _make_engine(cfg, "layered", spec_mode="draft",
                           **_draft_kw(cfg, self_draft=False))
        hist, lens = map(torch.from_numpy, _draft_batch())
        together = eng._draft_impl(3, hist, lens)
        for i in range(4):
            alone = eng._draft_impl(3, hist[i:i + 1, :int(lens[i]) + 3],
                                    lens[i:i + 1])
            assert torch.equal(alone[0], together[i]), cfg.name


@pytest.mark.parametrize("make_cfg", [tiny_moe, tiny_dense])
def test_draft_proposals_match_jax_draft(make_cfg):
    """The draft step itself against the JAX engine's on one padded batch
    and on each row alone: the same proposals, so an MoE draft's coupling
    of rows through its shared capacity is JAX's (at tiny_moe's default
    capacity a row's proposals change with its batch)."""
    import jax.numpy as jnp
    cfg = make_cfg()
    jeng = parity.build("jax", cfg, "layered", spec_mode="draft",
                        draft=(cfg, 7))
    teng = parity.build("torch", cfg, "layered", spec_mode="draft",
                        draft=(cfg, 7))
    hist, lens = _draft_batch()
    batches = [(hist, lens)] + [(hist[i:i + 1, :lens[i] + 3], lens[i:i + 1])
                                for i in range(4)]
    got = []
    for h, n in batches:
        want = np.asarray(jeng._draft_impl(3, jeng.draft_params,
                                           jnp.asarray(h, jnp.int32),
                                           jnp.asarray(n)))
        got.append(teng._draft_impl(3, torch.from_numpy(h),
                                    torch.from_numpy(n)).numpy())
        np.testing.assert_array_equal(got[-1], want)
    coupled = any((got[0][i] != got[1 + i][0]).any() for i in range(4))
    assert coupled == (make_cfg is tiny_moe)
