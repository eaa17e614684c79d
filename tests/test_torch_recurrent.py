"""The port's recurrent mixers (RecurrentGemma's RG-LRU, xLSTM's mLSTM and
sLSTM) and recurrentgemma-9b's local attention at head width 256 against
the JAX package on the CPU, in fp32:

* ``apply_rglru``, ``apply_mlstm`` (stepwise at S 64, chunkwise at S 256)
  and ``apply_slstm`` on the same weights (the JAX init converted through
  ``repro_torch.convert``) and inputs: outputs and every state leaf, with
  and without a cache, with ``valid`` masks; a fully masked row keeps its
  state bit for bit, and the state is written in place;
* the port's chunkwise mLSTM against its own stepwise form
  (tests/test_perf_paths.py's cases);
* the incremental-vs-full and masked-row cases of
  tests/test_attention_cache.py on ``tiny_hybrid`` and ``tiny_xlstm``;
* the plain versions of the prefill and decode attention kernels at
  (hd, hd_v) = (256, 256), 16 query heads over one kv head, with a
  window, against ``flash_attention_pallas`` and
  ``decode_attention_pallas`` in interpret mode and JAX's
  ``masked_attention``, at offsets and lengths that cross the window.

Tolerance as in tests/test_torch_model.py: rtol 1e-5 and atol 1e-5 of the
tensor's scale (the frameworks sum in other orders, and JAX's
``associative_scan`` combines in another order than the port's log-depth
scan); the chunkwise-vs-stepwise comparison keeps test_perf_paths.py's
2e-4 (the two forms are exact reformulations that round differently)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_hybrid, tiny_xlstm
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.kernels import ops
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm
from test_torch_model import (TOL, _full_vs_incremental, close, jit, models,
                              port_cfg, t)

S, K = 24, 4


def _block(cfg, kind: str, block: int):
    """The block's mixer weights in both packages."""
    jm, jp, tm, tp = models(cfg)
    return jm.block_params(jp, block)[kind], tm.block_params(tp, block)[kind]


def _valid(b: int, s: int, lens) -> np.ndarray:
    return np.arange(s)[None, :] < np.asarray(lens)[:, None]


def _check_mixer(cfg, jfn, tfn, kind, block, cache, s, lens, seed=0):
    """Run ``jfn``/``tfn`` on the same input and cache (numpy leaves);
    outputs and every state leaf must agree, the port's state written in
    place, and a row whose ``lens`` is 0 must keep its state bit for
    bit.  ``cache=None`` runs without state."""
    pj, pt = _block(cfg, kind, block)
    rng = np.random.default_rng(seed)
    b = len(lens)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    val = _valid(b, s, lens)
    if cache is None:
        oj, _ = jit(jfn, cfg)(pj, x)
        ot, ct = tfn(port_cfg(cfg), pt, t(x))
        assert ct is None
        close(ot, oj)
        return
    oj, cj = jit(jfn, cfg)(pj, x, cache=cache, valid=val)
    ct = {k: t(v) for k, v in cache.items()}
    before = {k: v.clone() for k, v in ct.items()}
    views = dict(ct)
    ot, ct2 = tfn(port_cfg(cfg), pt, t(x), cache=ct, valid=t(val))
    assert ct2 is ct and all(ct[k] is views[k] for k in ct)   # in place
    close(ot, oj)
    assert sorted(ct) == sorted(cj)
    for k in ct:
        close(ct[k], cj[k])
        for r, n in enumerate(lens):
            if n == 0:
                assert torch.equal(ct[k][r], before[k][r]), (k, r)


def _rglru_cache(cfg, b, rng):
    w = trglru.lru_width(cfg)
    return {"conv": rng.normal(size=(b, cfg.conv_width - 1, w))
            .astype(np.float32),
            "h": rng.normal(size=(b, w)).astype(np.float32)}


@pytest.mark.parametrize("s,lens", [(16, [16, 9, 0]), (1, [1, 0, 1]),
                                    (37, [37, 37, 20])])
def test_apply_rglru_matches_jax(s, lens):
    cfg = tiny_hybrid()
    cache = _rglru_cache(cfg, len(lens), np.random.default_rng(s))
    _check_mixer(cfg, jrglru.apply_rglru, trglru.apply_rglru, "rglru", 0,
                 cache, s, lens)


def test_apply_rglru_without_cache_matches_jax():
    _check_mixer(tiny_hybrid(), jrglru.apply_rglru, trglru.apply_rglru,
                 "rglru", 1, None, 21, [21, 21])


def _mlstm_cache(cfg, b, rng):
    di, h = 2 * cfg.d_model, cfg.n_heads
    dk = di // h
    return {"C": rng.normal(size=(b, h, dk, dk)).astype(np.float32) * 0.1,
            "n": rng.normal(size=(b, h, dk)).astype(np.float32) * 0.1,
            "m": rng.normal(size=(b, h)).astype(np.float32),
            "conv": rng.normal(size=(b, 3, di)).astype(np.float32)}


@pytest.mark.parametrize("s,lens", [(64, [64, 40, 0]), (1, [1, 0, 1]),
                                    (256, [256, 200, 0])],
                         ids=["stepwise", "decode", "chunkwise"])
def test_apply_mlstm_matches_jax(s, lens):
    cfg = tiny_xlstm()
    cache = _mlstm_cache(cfg, len(lens), np.random.default_rng(s))
    _check_mixer(cfg, jxlstm.apply_mlstm, txlstm.apply_mlstm, "lstm", 0,
                 cache, s, lens)


def test_apply_mlstm_init_state_and_no_cache_match_jax():
    """From the init state (m = -1e30), and without a cache, chunkwise."""
    cfg = tiny_xlstm()
    jm, _, tm, _ = models(cfg)
    init = {k: np.asarray(v[0, :2]) for k, v in jm.init_cache(2, 8)[0][0]
            .items()}
    assert (init["m"] == -1e30).all()
    _check_mixer(cfg, jxlstm.apply_mlstm, txlstm.apply_mlstm, "lstm", 0,
                 init, 32, [32, 7])
    _check_mixer(cfg, jxlstm.apply_mlstm, txlstm.apply_mlstm, "lstm", 0,
                 None, 256, [256, 256])


@pytest.mark.parametrize("s,lens", [(12, [12, 5, 0]), (1, [0, 1, 1])])
def test_apply_slstm_matches_jax(s, lens):
    cfg = tiny_xlstm()
    rng = np.random.default_rng(s)
    d = cfg.d_model
    cache = {k: rng.normal(size=(len(lens), d)).astype(np.float32)
             for k in ("c", "n", "h", "m")}
    cache["n"] = np.abs(cache["n"])
    _check_mixer(cfg, jxlstm.apply_slstm, txlstm.apply_slstm, "lstm", 1,
                 cache, s, lens)
    _check_mixer(cfg, jxlstm.apply_slstm, txlstm.apply_slstm, "lstm", 1,
                 None, s, lens)


def _mlstm_inputs(seed=0, b=2, s=384, h=2, dk=16):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, dk))
                                .astype(np.float32)) for _ in range(3))
    li = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32))
    lf = -torch.nn.functional.softplus(-torch.from_numpy(
        rng.normal(size=(b, s, h)).astype(np.float32) + 2.0))
    state = (torch.zeros(b, h, dk, dk), torch.zeros(b, h, dk),
             torch.full((b, h), -1e30))
    return q, k, v, li, lf, state


def test_mlstm_chunkwise_matches_stepwise():
    q, k, v, li, lf, state = _mlstm_inputs()
    s = q.shape[1]
    valid = torch.arange(s)[None, :] < torch.tensor([s, 300])[:, None]
    st_ref, h_ref = txlstm.mlstm_stepwise(q, k, v, li, lf, state, valid)
    st_chk, h_chk = txlstm.mlstm_chunkwise(q, k, v, li, lf, state, valid)
    np.testing.assert_allclose(h_chk[valid].numpy(), h_ref[valid].numpy(),
                               atol=2e-4, rtol=2e-4)
    for a, b_ in zip(st_chk, st_ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-4,
                                   rtol=2e-3)


def test_mlstm_chunkwise_carried_state():
    """A second segment continues from a non-trivial (C, n, m) carry."""
    q, k, v, li, lf, state = _mlstm_inputs(seed=3)
    st1, _ = txlstm.mlstm_stepwise(q, k, v, li, lf, state)
    st1c, _ = txlstm.mlstm_chunkwise(q, k, v, li, lf, state)
    _, h2_ref = txlstm.mlstm_stepwise(q, k, v, li, lf, st1)
    _, h2_chk = txlstm.mlstm_chunkwise(q, k, v, li, lf, st1c)
    np.testing.assert_allclose(h2_chk.numpy(), h2_ref.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_lru_scan_is_the_recurrence():
    """The log-depth scan equals the step-by-step recurrence, S not a
    power of two."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 37, 8)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    got = trglru.lru_scan(a, b, h)
    want = []
    for i in range(37):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               **TOL)


# ------------------------- incremental cache (tests/test_attention_cache.py)

CFGS = [tiny_hybrid, tiny_xlstm]
IDS = ["rglru+local", "xlstm"]


@pytest.mark.parametrize("make_cfg", CFGS, ids=IDS)
def test_incremental_matches_full(make_cfg):
    full, inc = _full_vs_incremental(make_cfg())
    np.testing.assert_allclose(inc, full, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("make_cfg", CFGS, ids=IDS)
def test_valid_masked_rows_do_not_corrupt_state(make_cfg):
    """A masked decode step leaves that row's state (and so its next real
    decode) unchanged — the engine's full-pool decode relies on it."""
    _, _, tm, tp = models(make_cfg())
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (2, S)))
    cache = tm.init_cache(2, S + 8)
    _, cache, _ = tm.forward(tp, toks, cache=cache,
                             offset=torch.zeros(2, dtype=torch.int32))
    snapshot = [[{k: v.clone() for k, v in c.items()} for c in seg]
                for seg in cache]
    _, cache, _ = tm.forward(tp, torch.tensor([[3], [7]]), cache=cache,
                             offset=torch.tensor([S, S], dtype=torch.int32),
                             valid=torch.tensor([[True], [False]]))
    for seg, seg0, recs in zip(cache, snapshot, tm.recurrent):
        for c, c0, rec in zip(seg, seg0, recs):
            if rec:
                for k in c:
                    assert torch.equal(c[k][:, 1], c0[k][:, 1]), k
    nxt = torch.tensor([[11], [11]])
    l_ref, _, _ = tm.forward(tp, nxt, cache=snapshot,
                             offset=torch.tensor([S, S], dtype=torch.int32))
    l_got, _, _ = tm.forward(tp, nxt, cache=cache,
                             offset=torch.tensor([S + 1, S], dtype=torch.int32))
    np.testing.assert_allclose(l_got[1].numpy(), l_ref[1].numpy(), **TOL)


def test_init_params_match_jax_shapes_and_distributions():
    """The port's own init draws the JAX package's shapes, fp32 ``a_param``
    with a^2 in [0.81, 0.999], and the forget biases of 3."""
    for make_cfg in CFGS:
        cfg = make_cfg(d_model=128, lru_width=128 if make_cfg is tiny_hybrid
                       else 0)
        jm, _, tm, _ = models(cfg)
        jshapes = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        tp = tm.init_params(torch.Generator().manual_seed(0))
        tshapes = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            tp)
        assert jshapes == tshapes
        blk = tp["segments"][0]["pattern"]
        if make_cfg is tiny_hybrid:
            a2 = torch.exp(-2 * 8.0 * torch.nn.functional.softplus(
                blk[0]["rglru"]["a_param"]))
            assert 0.81 - 1e-5 <= float(a2.min()) and \
                float(a2.max()) <= 0.999 + 1e-5
        else:
            h = cfg.n_heads
            assert torch.equal(blk[0]["lstm"]["b_if"][0, h:],
                               torch.full((h,), 3.0))
            d = cfg.d_model
            assert torch.equal(blk[1]["lstm"]["b_zifo"][0, 2 * d:3 * d],
                               torch.full((d,), 3.0))
        c = tm.init_cache(2, 8)
        assert all((v["m"] == -1e30).all() for seg in c for v in seg
                   if "m" in v)


# ------------------------------------ K2/K3 plain versions at hd 256, g 16

masked_attention = jax.jit(jattn.masked_attention,
                           static_argnames=("causal", "window"))


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("window", [None, 96])
def test_prefill_attention_hd256_matches_flash_pallas(window):
    """Offset 0, (256, 256), g 16, against ``flash_attention_pallas`` in
    interpret mode (the window shorter than the prompt)."""
    rng = np.random.default_rng(7)
    b, s, h, hkv, hd = 1, 256, 16, 1, 256
    q, k, v = (_np(rng, (b, s, h, hd)), _np(rng, (b, s, hkv, hd)),
               _np(rng, (b, s, hkv, hd)))
    got = ops.prefill_attention(t(q), t(k), t(v),
                                torch.zeros(b, dtype=torch.int32),
                                window=window)
    want = jops.flash_attention(q, k, v, causal=True, window=window,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_attention_hd256_with_offsets_matches_masked_attention():
    """Per-row offsets over the slot-row cache with a 48-token window that
    the offsets cross, as ``apply_gqa`` masks."""
    rng = np.random.default_rng(8)
    b, p, s_max, h, hkv, hd, window = 3, 32, 160, 16, 1, 256, 48
    q = _np(rng, (b, p, h, hd))
    k, v = _np(rng, (b, s_max, hkv, hd)), _np(rng, (b, s_max, hkv, hd))
    off = np.asarray([0, 40, s_max - p], np.int32)
    got = ops.prefill_attention(t(q), t(k), t(v), t(off), window=window)
    q_pos = off[:, None] + np.arange(p, dtype=np.int32)[None]
    kv_pos = np.arange(s_max, dtype=np.int32)
    kv_valid = kv_pos[None, :] < (off + p)[:, None]
    want = masked_attention(q, k, v, q_pos, kv_pos, kv_valid, causal=True,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_hd256_matches_pallas():
    """Lengths on both sides of a 64-token window (and one past S_max, an
    idle slot's), g 16, against ``decode_attention_pallas`` in interpret
    mode and JAX's ``masked_attention``."""
    rng = np.random.default_rng(9)
    b, s, h, hkv, hd, window = 4, 256, 16, 1, 256, 64
    q = _np(rng, (b, h, hd))
    k, v = _np(rng, (b, s, hkv, hd)), _np(rng, (b, s, hkv, hd))
    lengths = np.asarray([30, 64, 200, s], np.int32)
    got = ops.decode_attention(t(q), t(k), t(v), t(lengths), window=window)
    pallas = jops.decode_attention(q, k, v, jnp.asarray(lengths),
                                   window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    kv_pos = np.arange(s, dtype=np.int32)
    want = masked_attention(q[:, None], k, v, (lengths - 1)[:, None], kv_pos,
                            kv_pos[None, :] < lengths[:, None], causal=True,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)


def test_wrappers_admit_hd256_and_refuse_other_wide_pairs():
    assert (256, 256) in ops.PREFILL_HEAD_DIMS
    assert (256, 256) in ops.DECODE_WIDE_DIMS
    assert (256, 128) not in ops.PREFILL_HEAD_DIMS + ops.DECODE_WIDE_DIMS
