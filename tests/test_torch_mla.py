"""Multi-head latent attention (MLA) and the registry's two large MoE
models in the port, against the JAX package on the CPU, in fp32:

* the MLA mixer (``apply_mla``) on ``tiny_mla`` (no query compression)
  and the deepseek-v2-236b smoke config (q_lora_rank > 0): with the
  latent cache at per-row offsets (padded and fully masked rows), one
  decode step (an idle row whose stale offset is S_max), without a cache;
  a prefill in two chunks against one shot; masked rows that leave
  ``ckv``/``kr`` unchanged (the MLA cases of tests/test_attention_cache.py);
* the plain attention versions at a query/key width that differs from
  the value width, against JAX's ``masked_attention``;
* the shared experts at the deepseek smoke width under both dispatches;
* engine traces of deepseek-v2-236b and qwen3-moe-235b-a22b smoke,
  layered and chunked, ragged and dense; all five schedulers on
  ``tiny_mla``; swap and the prefix cache on deepseek smoke; two pools
  (streaming and whole handoff) of MLA caches, each migration moving
  prompt tokens x ``kv_bytes_per_token``; the launcher (``--smoke``,
  ``--simulate``).  Plans, token streams, TTFTs and expert bytes must be
  identical.

Tolerance as in tests/test_torch_model.py: rtol 1e-5 and atol 1e-5 of the
tensor's scale (the frameworks sum in other orders); expert counts,
plans and tokens exactly."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import _torch_parity as parity
from conftest import tiny_mla
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.serving.traffic import shared_prefix_trace
from test_torch_disagg import _mixed_trace
from test_torch_model import close, jit, models, port_cfg, port_tree, t

DEEPSEEK = jax_get_smoke_config("deepseek-v2-236b")
QWEN3_235B = jax_get_smoke_config("qwen3-moe-235b-a22b")
MLA_CFGS = [tiny_mla(), DEEPSEEK]
MLA_IDS = ["tiny_mla", "deepseek-smoke"]


# ----------------------------------------------------------- the mixer

def _mla_case(cfg, s, offsets, valid, s_max=40, seed=3, block=0):
    """``apply_mla`` of both packages on one block's weights, a random
    latent cache and the same inputs: outputs and both cache leaves."""
    jm, jp, tm, tp = models(cfg)
    bj = jm.block_params(jp, block)["attn"]
    bt = tm.block_params(tp, block)["attn"]
    m = cfg.mla
    rng = np.random.default_rng(seed)
    b = len(offsets)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(b, s_max, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(b, s_max, m.qk_rope_dim)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    pos = off[:, None] + np.arange(s, dtype=np.int32)[None]
    val = np.asarray(valid, bool)
    out_j, cj = jit(jattn.apply_mla, cfg, jm.specs[block])(
        bj, x, positions=pos, offset=off, cache={"ckv": ckv, "kr": kr},
        valid=val)
    ct = {"ckv": t(ckv), "kr": t(kr)}
    out_t, ct2 = tattn.apply_mla(tm.cfg, tm.specs[block], bt, t(x),
                                 positions=t(pos).long(), offset=t(off),
                                 cache=ct, valid=t(val))
    assert ct2 is ct                     # written in place
    close(out_t, out_j)
    close(ct["ckv"], cj["ckv"])
    close(ct["kr"], cj["kr"])
    return ckv, kr, ct


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_apply_mla_prefill_with_cache_matches_jax(cfg):
    """Per-row offsets, a bucket-padded row and a fully masked row, whose
    ``ckv``/``kr`` stay as they were."""
    valid = [[True] * 8, [True] * 5 + [False] * 3, [False] * 8]
    ckv, kr, ct = _mla_case(cfg, 8, [0, 9, 30], valid)
    assert torch.equal(ct["ckv"][2], t(ckv[2]))
    assert torch.equal(ct["kr"][2], t(kr[2]))
    assert torch.equal(ct["ckv"][1, 14:], t(ckv[1, 14:]))


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_apply_mla_decode_with_cache_matches_jax(cfg):
    """S == 1 (the decode kernel's path), with an idle row whose stale
    offset equals S_max: its write is dropped."""
    ckv, kr, ct = _mla_case(cfg, 1, [0, 17, 40, 39],
                            [[True], [True], [False], [True]])
    assert torch.equal(ct["ckv"][2], t(ckv[2]))
    assert torch.equal(ct["kr"][2], t(kr[2]))


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_apply_mla_without_cache_matches_jax(cfg):
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jit(jattn.apply_mla, cfg, jm.specs[1])(
        jm.block_params(jp, 1)["attn"], x, positions=pos)
    got, cache = tattn.apply_mla(tm.cfg, tm.specs[1],
                                 tm.block_params(tp, 1)["attn"], t(x),
                                 positions=t(pos).long())
    assert cache is None
    close(got, want)


S = 24


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_mla_prefill_in_two_chunks_matches_one_shot_and_jax(cfg):
    """Chunked prefill's cache continuation: the second chunk's logits
    equal the one-shot forward's (atol = rtol = 3e-4, as in
    tests/test_attention_cache.py) and JAX's on the same cache (TOL)."""
    jm, jp, tm, tp = models(cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, S))
    off = np.asarray([0, 3], np.int32)
    jc, tc = jm.init_cache(2, S + 8), tm.init_cache(2, S + 8)
    fwd = jit(jm.forward, dropless=True, moe_dispatch="ragged")
    for sl, o in ((slice(0, S // 2), off), (slice(S // 2, S), off + S // 2)):
        lj, jc, _ = fwd(jp, toks[:, sl].astype(np.int32), offset=o, cache=jc)
        lt, tc, _ = tm.forward(tp, t(toks[:, sl]), offset=t(o), cache=tc)
        close(lt, lj)
    for seg_t, seg_j in zip(tc, jc):
        for ct, cj in zip(seg_t, seg_j):
            assert sorted(ct) == ["ckv", "kr"]
            close(ct["ckv"], cj["ckv"])
            close(ct["kr"], cj["kr"])
    full, _, _ = tm.forward(tp, t(toks[:1]))
    np.testing.assert_allclose(lt[:1].numpy(), full[:, S // 2:].numpy(),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_mla_decode_step_matches_jax(cfg):
    """A prefill into the cache, then one decode step through the whole
    model: logits against JAX, and the step against the one-shot forward
    of the prompt plus that token."""
    jm, jp, tm, tp = models(cfg)
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size,
                                             (2, S + 1)).astype(np.int32)
    zero = np.zeros(2, np.int32)
    jc, tc = jm.init_cache(2, S + 8), tm.init_cache(2, S + 8)
    fwd = jit(jm.forward, dropless=True, moe_dispatch="ragged")
    _, jc, _ = fwd(jp, toks[:, :S], offset=zero, cache=jc)
    _, tc, _ = tm.forward(tp, t(toks[:, :S]), offset=t(zero), cache=tc)
    lj, _, _ = fwd(jp, toks[:, S:], offset=zero + S, cache=jc)
    lt, _, _ = tm.forward(tp, t(toks[:, S:]), offset=t(zero + S), cache=tc)
    close(lt, lj)
    full, _, _ = tm.forward(tp, t(toks))
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, S].numpy(),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("cfg", MLA_CFGS, ids=MLA_IDS)
def test_mla_valid_masked_rows_do_not_corrupt_state(cfg):
    """A masked decode step leaves that row's ``ckv``/``kr`` (and so its
    next real decode) unchanged — the engine's full-pool decode relies on
    it."""
    _, _, tm, tp = models(cfg)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(1, cfg.vocab_size, (2, S)))
    cache = tm.init_cache(2, S + 8)
    _, cache, _ = tm.forward(tp, toks, cache=cache,
                             offset=torch.zeros(2, dtype=torch.int32))
    snapshot = [[{k: v.clone() for k, v in c.items()} for c in seg]
                for seg in cache]
    _, cache, _ = tm.forward(tp, torch.tensor([[3], [7]]), cache=cache,
                             offset=torch.tensor([S, S], dtype=torch.int32),
                             valid=torch.tensor([[True], [False]]))
    for seg, snap in zip(cache, snapshot):
        for c, c0 in zip(seg, snap):
            for leaf in ("ckv", "kr"):
                assert torch.equal(c[leaf][:, 1], c0[leaf][:, 1])
                assert not torch.equal(c[leaf][:, 0], c0[leaf][:, 0])
    nxt = torch.tensor([[11], [11]])
    l_ref, _, _ = tm.forward(tp, nxt, cache=snapshot,
                             offset=torch.tensor([S, S], dtype=torch.int32))
    l_got, _, _ = tm.forward(tp, nxt, cache=cache,
                             offset=torch.tensor([S + 1, S],
                                                 dtype=torch.int32))
    np.testing.assert_allclose(l_got[1].numpy(), l_ref[1].numpy(),
                               atol=1e-5, rtol=1e-5)


# --------------------------------------- plain attention at dk != dv

def _qkv(rng, b, sq, skv, h, hkv, dk, dv):
    q = rng.normal(size=(b, sq, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dk)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,h,hkv,dk,dv", [(9, 4, 4, 24, 16),
                                            (7, 8, 2, 48, 32),
                                            (1024, 2, 2, 24, 8)],
                         ids=["mla", "gqa", "query-chunked"])
def test_masked_attention_at_unequal_widths_matches_jax(sq, h, hkv, dk, dv):
    """Output width dv, scale 1/sqrt(dk), with per-row valid lengths (the
    last case takes the query-chunked path of both packages)."""
    rng = np.random.default_rng(8)
    b, skv = 2, max(sq, 12)
    q, k, v = _qkv(rng, b, sq, skv, h, hkv, dk, dv)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + skv - sq,
                            (b, sq)).copy()
    kv_pos = np.arange(skv, dtype=np.int32)
    valid = kv_pos[None] < np.asarray([skv, skv - 3])[:, None]
    want = jit(jattn.masked_attention, causal=True)(q, k, v, q_pos, kv_pos,
                                                   valid)
    got = ref.masked_attention(t(q), t(k), t(v), t(q_pos).long(),
                               t(kv_pos).long(), t(valid))
    assert got.shape == (b, sq, h, dv)
    close(got, want)


def test_kernel_contracts_at_mla_widths_match_jax():
    """``prefill_attention_ref`` and ``decode_attention_ref`` at (dk, dv)
    = (24, 16), H = Hkv, against JAX's ``masked_attention`` with the masks
    ``apply_mla`` builds (a stale decode length past S_max included)."""
    rng = np.random.default_rng(9)
    b, p, s_max, h = 3, 6, 20, 4
    q, k, v = _qkv(rng, b, p, s_max, h, h, 24, 16)
    off = np.asarray([0, 5, 14], np.int32)
    q_pos = off[:, None] + np.arange(p, dtype=np.int32)[None]
    kv_pos = np.arange(s_max, dtype=np.int32)
    fn = jit(jattn.masked_attention, causal=True)
    want = fn(q, k, v, q_pos, kv_pos, kv_pos[None] < (off + p)[:, None])
    close(ref.prefill_attention_ref(t(q), t(k), t(v), t(off)), want)
    lengths = np.asarray([1, 13, s_max + 1], np.int32)
    ln = np.minimum(lengths, s_max)
    want = fn(q[:, :1], k, v, (lengths - 1)[:, None], kv_pos,
              kv_pos[None] < ln[:, None])[:, 0]
    got = ref.decode_attention_ref(t(q[:, 0]), t(k), t(v), t(lengths))
    assert got.shape == (b, h, 16)
    close(got, want)


# -------------------------------------------------------- shared experts

@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
def test_shared_experts_at_deepseek_smoke_width_match_jax(dispatch):
    """The MoE block of deepseek smoke (1 shared expert beside the routed
    ones) with valid masking."""
    import jax
    cfg = DEEPSEEK
    assert cfg.moe.n_shared_experts == 1
    jp = jmoe.init_moe(cfg, jax.random.PRNGKey(1))
    tp = port_tree(cfg, jp)
    assert set(tp["shared"]) == {"w_gate", "w_up", "w_down"}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    valid = np.ones((2, 10), bool)
    valid[1, 6:] = False
    out_j, aux_j = jit(jmoe.apply_moe, cfg, moe_dispatch=dispatch,
                       dropless=True)(jp, x, valid=valid)
    out_t, aux_t = tmoe.apply_moe(port_cfg(cfg), tp, t(x), valid=t(valid),
                                  dropless=True, moe_dispatch=dispatch)
    close(out_t, out_j)
    np.testing.assert_array_equal(aux_t["expert_counts"].numpy(),
                                  np.asarray(aux_j["expert_counts"]))


# ------------------------------------------------------------- engine

def _jobs(vocab=500):
    rng = np.random.default_rng(3)
    return [(rng.integers(1, vocab, int(rng.integers(4, 20))).tolist(), 6)
            for _ in range(5)]


@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
@pytest.mark.parametrize("sched", ["layered", "chunked"])
@pytest.mark.parametrize("cfg", [DEEPSEEK, QWEN3_235B],
                         ids=["deepseek-smoke", "qwen3-235b-smoke"])
def test_engine_trace_matches_jax(cfg, sched, dispatch):
    """Closed-loop jobs in a small page pool: identical plans, token
    streams, TTFTs, token times, expert bytes and preemptions."""
    kw = dict(max_len=64, pages=16, page_size=4, decode_reserve=1,
              moe_dispatch=dispatch)
    want = parity.run("jax", cfg, sched, jobs=_jobs(), **kw)
    got = parity.run("torch", cfg, sched, jobs=_jobs(), **kw)
    parity.assert_same(got, want)
    assert got["expert_load_bytes"] > 0 and got["pages_left"] == 0
    assert all(len(toks) == 6 for toks in got["outputs"].values())


PROMPTS = [list(range(1, 12)), [5, 3, 7] * 9, list(range(40, 10, -1))]


def test_all_schedulers_agree_on_tiny_mla():
    """The port's ``test_all_schedulers_agree[mla]``
    (tests/test_engine_equivalence.py)."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.serving.engine import Engine
    _, _, tm, tp = models(tiny_mla())
    outs = {}
    for name in ("continuous", "chunked", "layered", "hybrid", "static"):
        sched = make_scheduler(name, tm.n_blocks, n_slots=4, quantum=8,
                               token_budget=16)
        eng = Engine(tm, tp, sched, n_slots=4, max_len=128)
        for p in PROMPTS:
            eng.submit(p, 6)
        eng.run()
        outs[name] = {rid: list(x) for rid, x in eng.outputs.items()}
    for name, got in outs.items():
        assert got == outs["continuous"], name


@pytest.mark.parametrize("mode", ["swap", "auto"])
def test_swap_on_deepseek_smoke_matches_jax(mode):
    """Oversubscribed pool: swap-outs and swap-ins of MLA caches (both
    segments' ``ckv``/``kr``) in the same iterations as JAX's, the same
    tokens, every page returned."""
    rng = np.random.default_rng(0)
    jobs = [(list(rng.integers(1, 200, int(rng.integers(4, 10)))), 12)
            for _ in range(12)]
    kw = dict(pages=16, page_size=4, decode_reserve=1, preemption_mode=mode)
    want = parity.run("jax", DEEPSEEK, "layered", jobs=jobs, **kw)
    got = parity.run("torch", DEEPSEEK, "layered", jobs=jobs, **kw)
    parity.assert_same(got, want)
    assert got["n_swapped_out"] == got["n_swapped_in"] > 0
    assert got["pages_left"] == got["host_pages_left"] == 0


def test_prefix_cache_on_deepseek_smoke_matches_jax():
    """A shared-prefix replay: identical plans, tokens, hits and latent
    row restores."""
    trace = shared_prefix_trace(8, n_prefixes=2, prefix_len=24,
                                suffix_len=4, output_len=4, rate=0.5,
                                vocab_size=97, seed=3)
    kw = dict(page_size=4, sched_kw=dict(token_budget=64))
    want = parity.run("jax", DEEPSEEK, "layered", trace=trace, **kw)
    got = parity.run("torch", DEEPSEEK, "layered", trace=trace, **kw)
    parity.assert_same(got, want)
    assert got["n_prefix_hits"] > 0 and got["n_prefix_restores"] > 0


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "whole"])
def test_two_pools_hand_off_mla_caches_as_jax(streaming):
    """Two pools over deepseek smoke: identical per-pool plans, streams,
    migrations and counters to JAX's ``DisaggRuntime``; each migration
    moves the prompt's latent rows, prompt tokens x
    ``kv_bytes_per_token`` (fp32), where JAX moves the whole slot row."""
    trace = _mixed_trace(n=12, spread=20)
    kw = dict(pages=24, page_size=4, decode_reserve=1)
    want = parity.run_disagg("jax", DEEPSEEK, trace, streaming=streaming,
                             **kw)
    got = parity.run_disagg("torch", DEEPSEEK, trace, streaming=streaming,
                            **kw)
    parity.assert_same(got, want, [k for k in want if k != "migrations"])
    assert got["run"]["n_migrations"] > 0
    per_token = DEEPSEEK.kv_bytes_per_token(4)
    assert per_token == DEEPSEEK.n_layers * (64 + 16) * 4
    for (rid, n_tok, n_chunks, b_port), (_, _, _, b_jax) in zip(
            got["migrations"], want["migrations"]):
        assert b_port == n_tok * per_token
        assert b_jax == got["max_len"] * per_token
        assert (n_chunks > 0) == streaming


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-moe-235b-a22b"])
def test_launcher_serves_the_smoke_models(arch, capsys):
    """``--arch ... --smoke --device cpu --requests 2`` serves and prints
    the expert load; without ``--device cpu`` it needs CUDA."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "2"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke x layered" in out
    line = next(ln for ln in out.splitlines() if "expert-load" in ln)
    assert float(line.rsplit("expert-load", 1)[1].split()[0]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--smoke", "--requests", "2"])


def test_launcher_simulates_deepseek_as_jax(capsys):
    """``--simulate --arch deepseek-v2-236b`` prints the JAX launcher's
    ``[serve-sim]`` lines."""
    from repro.launch import serve as jax_serve
    argv = ["--simulate", "--arch", "deepseek-v2-236b", "--requests", "12",
            "--rate", "1.3"]
    serve.main(argv)
    ours = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        jax_serve.main()
    finally:
        sys.argv = saved
    assert ours.startswith("[serve-sim]") and ours == capsys.readouterr().out


def test_two_segment_stack_swaps_and_hands_off():
    """deepseek smoke at 17 layers: block 0 dense and 16 MoE blocks form
    two segments of the parameter and cache trees (as at full depth), so
    swap copies and handoff chunks span both.  The swap serve gives the
    streams of the unpressured one; two pools (streaming and whole) give
    the monolithic engine's, each migration moving prompt tokens x
    ``kv_bytes_per_token``.  (JAX's engine at this depth takes minutes on
    the CPU; the two-layer stack is held against it above.)"""
    import dataclasses
    from test_torch_disagg import _disagg, _free_outputs
    cfg = dataclasses.replace(DEEPSEEK, n_layers=17)
    assert [reps for _, reps in cfg.scan_segments()] == [1, 16]
    rng = np.random.default_rng(1)
    jobs = [(list(rng.integers(1, 200, int(rng.integers(4, 10)))), 8)
            for _ in range(10)]
    kw = dict(pages=12, page_size=4, decode_reserve=1)
    tight = parity.run("torch", cfg, "layered", jobs=jobs,
                       preemption_mode="swap", **kw)
    free = parity.run("torch", cfg, "layered", jobs=jobs)
    assert tight["n_swapped_out"] == tight["n_swapped_in"] > 0
    assert tight["outputs"] == free["outputs"]
    trace = _mixed_trace(n=8, spread=10)
    want = _free_outputs(cfg, trace)
    for streaming in (True, False):
        ep, ed, rr = _disagg(cfg, trace, streaming=streaming,
                             pages=24, page_size=4, decode_reserve=1)
        assert rr.n_migrations > 0
        assert {**ep.outputs, **ed.outputs} == want
