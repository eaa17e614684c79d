"""The PyTorch port's model against the JAX package on the CPU, in fp32:
layers, GQA attention with the slot-row cache, ragged MoE, blocks, the
full forward and partial ``run_blocks``.  Both packages get the same
weights (the JAX init converted through ``repro_torch.convert``) and the
same numpy inputs.  Tolerance: rtol = 1e-5 and atol = 1e-5 of the
tensor's scale (the two frameworks sum in different orders); expert counts
must match exactly."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.config import MoEConfig
from repro.models.model import DecoderModel as JaxModel
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.model import DecoderModel as TorchModel

TOL = dict(atol=1e-5, rtol=1e-5)

# These tests run tiny tensors, and the suite runs in several worker
# processes on one host, each of which imports every test module: torch's
# default of one intra-op thread per core oversubscribes the host and
# makes the port's tests several times slower, with nothing to gain from
# threads at these sizes.  One thread per process.
torch.set_num_threads(1)


# ------------------------------------------------------------- helpers

def port_cfg(cfg):
    """The JAX package's ModelConfig as the port's (same fields)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", tconfig.MoEConfig), ("mla", tconfig.MLAConfig),
                      ("encoder", tconfig.EncoderConfig),
                      ("vision", tconfig.VisionStubConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tconfig.ModelConfig(**kw)


def port_tree(cfg, tree):
    """A JAX parameter (sub)tree as the port's, on the CPU."""
    return from_jax_params(port_cfg(cfg),
                           jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _models(cfg, seed: int):
    jm = JaxModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = TorchModel(port_cfg(cfg), device="cpu")
    return jm, jp, tm, port_tree(cfg, jp)


def models(cfg, seed: int = 0):
    """(jax model, jax params, torch model, torch params) on one init;
    the torch params are a fresh copy (the port updates caches in place,
    never params, but a test must not see another test's tensors)."""
    jm, jp, tm, tp = _models(cfg, seed)
    return jm, jp, tm, jax.tree_util.tree_map(torch.clone, tp)


def jit(fn, *static, **kw):
    """A JAX reference function jitted with its leading config arguments
    bound: one compile instead of one per eager op keeps these tests fast."""
    return jax.jit(functools.partial(fn, *static, **kw))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    """allclose at ``TOL`` by default, with atol taken relative to the
    tensor's scale: hidden states of these tiny random models reach ~100
    (the JAX init draws expert weights with fan-in E = 4), where one fp32
    ulp is already 7.6e-6."""
    want = np.asarray(want)
    if not tol:
        scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(
        got, torch.Tensor) else np.asarray(got), want, **tol)


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm):
    cfg = tiny_dense(norm=norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(size=cfg.d_model).astype(np.float32)
    want = jit(jlayers.apply_norm, cfg)(p, x)
    got = tlayers.apply_norm(port_cfg(cfg), {k: t(v) for k, v in p.items()},
                             t(x))
    close(got, want)


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_apply_rope_matches_jax(pct):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    # eager on purpose: jitted XLA fuses sin/cos of these large angles
    # with a faster approximation (up to 5e-5 off here)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, pct)
    got = tlayers.apply_rope(t(x), t(pos), 1e6, pct)
    close(got, want, atol=2e-5, rtol=1e-5)


def test_mlp_embed_unembed_match_jax():
    cfg = tiny_dense()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    h = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    close(tm.embed(tp, t(toks).long()), jit(jm.embed)(jp, toks))
    close(tm.logits(tp, t(h)), jit(jm.logits)(jp, h))
    capped = dataclasses.replace(cfg, logit_softcap=30.0)
    close(tlayers.unembed(port_cfg(capped), tp["embed"], t(h)),
          jit(jlayers.unembed, capped)(jp["embed"], h))
    bj = jm.block_params(jp, 0)
    bt = tm.block_params(tp, 0)
    close(tlayers.apply_mlp(tm.cfg, bt["mlp"], t(h)),
          jit(jlayers.apply_mlp, cfg)(bj["mlp"], h))


# ------------------------------------------------------------- attention

def _gqa_case(cfg, s, offsets, valid, s_max=40, seed=3):
    jm, jp, tm, tp = models(cfg)
    spec = jm.specs[0]
    bj, bt = jm.block_params(jp, 0)["attn"], tm.block_params(tp, 0)["attn"]
    rng = np.random.default_rng(seed)
    b = len(offsets)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, s_max, cfg.n_kv_heads, cfg.head_dim_)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    pos = off[:, None] + np.arange(s, dtype=np.int32)[None]
    val = np.asarray(valid, bool)
    out_j, cj = jit(jattn.apply_gqa, cfg, spec)(
        bj, x, positions=pos, offset=off, cache={"k": kc, "v": vc},
        valid=val)
    ct = {"k": t(kc), "v": t(vc)}
    out_t, ct = tattn.apply_gqa(tm.cfg, tm.specs[0], bt, t(x),
                                positions=t(pos).long(), offset=t(off),
                                cache=ct, valid=t(val))
    close(out_t, out_j)
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


@pytest.mark.parametrize("window", [None, 8])
def test_apply_gqa_prefill_with_cache_matches_jax(window):
    """Per-row offsets, a bucket-padded row and a fully masked row."""
    cfg = tiny_dense(sliding_window=window)
    valid = [[True] * 8, [True] * 5 + [False] * 3, [False] * 8]
    _gqa_case(cfg, 8, [0, 9, 30], valid)


def test_apply_gqa_decode_with_cache_matches_jax():
    """S == 1 (the decode kernel's path), with an idle row whose stale
    offset equals S_max: its write is dropped."""
    cfg = tiny_dense()
    _gqa_case(cfg, 1, [0, 17, 40, 39], [[True], [True], [False], [True]])


def test_apply_gqa_without_cache_matches_jax():
    cfg = tiny_dense()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jit(jattn.apply_gqa, cfg, jm.specs[0])(
        jm.block_params(jp, 0)["attn"], x, positions=pos)
    got, _ = tattn.apply_gqa(tm.cfg, tm.specs[0],
                             tm.block_params(tp, 0)["attn"], t(x),
                             positions=t(pos).long())
    close(got, want)


def test_write_cache_drop_semantics_match_jax():
    """Masked tokens and positions >= S_max are dropped, as JAX's
    ``.at[].set(mode="drop")`` drops them (``index_put_`` would raise)."""
    rng = np.random.default_rng(5)
    buf = rng.normal(size=(3, 10, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 6, 2, 4)).astype(np.float32)
    off = np.asarray([0, 7, 10], np.int32)
    ok = rng.random((3, 6)) < 0.7
    want = jit(jattn._write_cache)(buf, new, off, ok)
    got = tattn._write_cache(t(buf), t(new), t(off), t(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- MoE

def _moe_params(cfg, seed=0):
    jp = jmoe.init_moe(cfg, jax.random.PRNGKey(seed))
    return jp, port_tree(cfg, jp)


def test_route_matches_jax_and_topk_is_normalized():
    cfg = tiny_moe()
    jp, tp = _moe_params(cfg)
    x = np.random.default_rng(6).normal(size=(16, cfg.d_model)).astype(np.float32)
    ij, wj, pj = jit(jmoe.route, cfg)(jp, x)
    it, wt, pt = tmoe.route(port_cfg(cfg), tp, t(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(wt, wj)
    close(pt, pj)
    np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, atol=1e-6)


def test_route_ties_go_to_the_lower_expert():
    """``jax.lax.top_k`` breaks ties toward the lower index; the port's
    stable sort does the same, so expert counts match exactly."""
    cfg = tiny_moe(moe=MoEConfig(n_experts=8, top_k=3, expert_d_ff=64))
    p = {"router": torch.zeros(cfg.d_model, 8)}          # all probs equal
    idx, w, _ = tmoe.route(port_cfg(cfg), p, torch.randn(5, cfg.d_model))
    assert idx.tolist() == [[0, 1, 2]] * 5
    jidx, _, _ = jit(jmoe.route, cfg)({"router": jnp.zeros((cfg.d_model, 8))},
                                      jnp.ones((5, cfg.d_model)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("t_,e", [(1, 2), (7, 4), (33, 8), (64, 3)])
def test_ragged_dispatch_matches_jax(t_, e):
    """Slots, keep, counts and tile owners are identical to the JAX
    dispatch, including masked (sentinel) assignments."""
    rng = np.random.default_rng(t_ * e)
    idx = rng.integers(0, e + 1, size=(t_, 2))          # e == sentinel
    m_blk, n_rows = jmoe.ragged_tile_rows(t_ * 2, e)
    assert (m_blk, n_rows) == tmoe.ragged_tile_rows(t_ * 2, e)
    sj, kj, cj, tj = jit(jmoe.ragged_dispatch_indices, n_experts=e,
                         m_blk=m_blk, n_rows=n_rows)(idx)
    st, kt, ct, tt = tmoe.ragged_dispatch_indices(t(idx), e, m_blk, n_rows)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # the sentinel is not counted (jnp.bincount(length=E) drops it)
    assert int(ct.sum()) == int((idx < e).sum())


def test_ragged_masked_tokens_dropped_from_buffer():
    e = 4
    idx = torch.tensor([[0, 1], [e, e], [2, 0]])
    m_blk, n_rows = tmoe.ragged_tile_rows(6, e)
    slot, keep, counts, _ = tmoe.ragged_dispatch_indices(idx, e, m_blk, n_rows)
    assert keep.tolist() == [True, True, False, False, True, True]
    assert int(counts.sum()) == 4
    assert (slot[2:4] == n_rows).all()


def test_ragged_tile_rows_bounds():
    for a, e in [(1, 1), (8, 4), (64, 128), (4096, 128), (260_000, 128)]:
        m_blk, rows = tmoe.ragged_tile_rows(a, e)
        assert (m_blk, rows) == jmoe.ragged_tile_rows(a, e)
        assert rows % m_blk == 0 and rows >= a
        assert rows <= a + e * (m_blk - 1) + m_blk
        assert 8 <= m_blk <= 128


@pytest.mark.parametrize("shared", [0, 1])
def test_apply_moe_ragged_matches_jax(shared):
    """Ragged dispatch with valid masking; shared experts always added."""
    cfg = tiny_moe()
    if shared:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared_experts=1, shared_d_ff=32))
    jp, tp = _moe_params(cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 11:] = False
    out_j, aux_j = jit(jmoe.apply_moe, cfg, moe_dispatch="ragged")(
        jp, x, valid=valid)
    out_t, aux_t = tmoe.apply_moe(port_cfg(cfg), tp, t(x), valid=t(valid))
    close(out_t, out_j)
    np.testing.assert_array_equal(aux_t["expert_counts"].numpy(),
                                  np.asarray(aux_j["expert_counts"]))
    assert int(aux_t["expert_counts"].sum()) == 27 * cfg.moe.top_k
    close(aux_t["aux_loss"], aux_j["aux_loss"])
    assert int(aux_t["dropped"]) == 0


def test_apply_moe_is_per_token():
    cfg = port_cfg(tiny_moe())
    _, p = _moe_params(tiny_moe())
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32))
    full, _ = tmoe.apply_moe(cfg, p, x)
    h1, _ = tmoe.apply_moe(cfg, p, x[:, :4])
    h2, _ = tmoe.apply_moe(cfg, p, x[:, 4:])
    close(full, torch.cat([h1, h2], 1).numpy())


def test_valid_mask_excludes_padding_from_counts():
    cfg = port_cfg(tiny_moe())
    _, p = _moe_params(tiny_moe())
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32))
    valid = torch.tensor([[True] * 5 + [False] * 3])
    out_m, aux = tmoe.apply_moe(cfg, p, x, valid=valid)
    assert int(aux["expert_counts"].sum()) == 5 * cfg.moe.top_k
    out_t, _ = tmoe.apply_moe(cfg, p, x[:, :5])
    close(out_m[:, :5], out_t.numpy())


def test_unported_dispatch_raises():
    """Both dispatches are ported; an unknown one raises ValueError, as
    the JAX apply_moe does."""
    cfg = port_cfg(tiny_moe())
    _, p = _moe_params(tiny_moe())
    with pytest.raises(ValueError, match="unknown moe_dispatch"):
        tmoe.apply_moe(cfg, p, torch.zeros(1, 2, cfg.d_model),
                       moe_dispatch="sparse")
    with pytest.raises(ValueError, match="unknown moe_dispatch"):
        jmoe.apply_moe(tiny_moe(), jax.tree_util.tree_map(
            jnp.asarray, _moe_params(tiny_moe())[0]),
            jnp.zeros((1, 2, cfg.d_model)), moe_dispatch="sparse")


@pytest.mark.parametrize("n_tokens", [1, 7, 8, 16, 33, 100, 1000])
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_capacity_matches_jax(n_tokens, cf):
    cfg = tiny_moe(moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64,
                                 capacity_factor=cf))
    assert tmoe.capacity(port_cfg(cfg), n_tokens) == jmoe.capacity(cfg,
                                                                   n_tokens)


@pytest.mark.parametrize("t_,e,cap", [(1, 2, 1), (7, 4, 3), (33, 8, 8),
                                      (64, 3, 64), (20, 4, 2)])
def test_dispatch_indices_match_jax(t_, e, cap):
    """Slots, keep and counts of the dense capacity buffer are identical
    to the JAX dispatch, with masked (id == E) and over-capacity
    assignments."""
    rng = np.random.default_rng(t_ * e + cap)
    idx = rng.integers(0, e + 1, size=(t_, 2))          # e == sentinel
    sj, kj, cj = jit(jmoe.dispatch_indices, n_experts=e, cap=cap)(idx)
    st, kt, ct = tmoe.dispatch_indices(t(idx), e, cap)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
def test_apply_moe_dense_matches_jax(dropless):
    """Dense dispatch with valid masking and a shared expert: outputs,
    expert counts, active experts and dropped assignments match the JAX
    apply_moe; with GShard capacity (factor 0.5) some assignments drop."""
    cfg = tiny_moe()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=1, shared_d_ff=32, capacity_factor=0.5))
    jp, tp = _moe_params(cfg)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 11:] = False
    out_j, aux_j = jit(jmoe.apply_moe, cfg, dropless=dropless,
                       moe_dispatch="dense")(jp, x, valid=valid)
    out_t, aux_t = tmoe.apply_moe(port_cfg(cfg), tp, t(x), valid=t(valid),
                                  dropless=dropless, moe_dispatch="dense")
    close(out_t, out_j)
    for key in ("expert_counts", "active_experts", "dropped"):
        np.testing.assert_array_equal(aux_t[key].numpy(), np.asarray(aux_j[key]))
    close(aux_t["aux_loss"], aux_j["aux_loss"])
    assert (int(aux_t["dropped"]) == 0) == dropless


def test_dense_and_ragged_dispatch_agree_when_dropless():
    cfg = tiny_moe()
    _, p = _moe_params(cfg)
    x = t(np.random.default_rng(16).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32))
    out_r, aux_r = tmoe.apply_moe(port_cfg(cfg), p, x)
    out_d, aux_d = tmoe.apply_moe(port_cfg(cfg), p, x, dropless=True,
                                  moe_dispatch="dense")
    close(out_d, out_r.numpy())
    assert torch.equal(aux_d["expert_counts"], aux_r["expert_counts"])


# ------------------------------------------------------------- blocks

@pytest.mark.parametrize("make_cfg", [tiny_dense, tiny_moe],
                         ids=["dense", "moe"])
def test_apply_block_matches_jax(make_cfg):
    cfg = make_cfg()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    off = np.asarray([0, 4], np.int32)
    pos = off[:, None] + np.arange(6, dtype=np.int32)[None]
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16)
    cj = jax.tree_util.tree_map(lambda a: a[0], jc[0][0])
    ct = {k: v[0] for k, v in tc[0][0].items()}
    xj, cj, aj = jit(jblocks.apply_block, cfg, jm.specs[0], dropless=True,
                     moe_dispatch="ragged")(
        jm.block_params(jp, 0), x, positions=pos, offset=off, cache=cj)
    xt, ct, at = tblocks.apply_block(
        tm.cfg, tm.specs[0], tm.block_params(tp, 0), t(x),
        positions=t(pos).long(), offset=t(off), cache=ct)
    close(xt, xj)
    close(ct["k"], cj["k"])
    np.testing.assert_array_equal(at["expert_counts"].numpy(),
                                  np.asarray(aj["expert_counts"]))


# ------------------------------------------------------------- model

@pytest.mark.parametrize("make_cfg", [tiny_dense, tiny_moe],
                         ids=["dense", "moe"])
def test_forward_matches_jax(make_cfg):
    """Full forward with a cache at per-row offsets, then a decode step:
    logits and caches within 1e-5, expert counts exact."""
    cfg = make_cfg()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    off = np.asarray([0, 6], np.int32)
    jc, tc = jm.init_cache(2, 40), tm.init_cache(2, 40)
    fwd = jit(jm.forward, dropless=True, moe_dispatch="ragged")
    for sl, o in ((slice(0, 16), off), (slice(16, 17), off + 16)):
        lj, jc, aj = fwd(jp, toks[:, sl], offset=o, cache=jc)
        lt, tc, at = tm.forward(tp, t(toks[:, sl]).long(), offset=t(o),
                                cache=tc)
        close(lt, lj)
        assert tuple(at["expert_counts"].shape) == (cfg.n_layers, max(
            cfg.moe.n_experts, 1))
        np.testing.assert_array_equal(at["expert_counts"].numpy(),
                                      np.asarray(aj["expert_counts"]))
    for leaf in ("k", "v"):
        close(tc[0][0][leaf], jc[0][0][leaf])
    # no-cache forward as well
    lj, _, _ = fwd(jp, toks)
    lt, _, _ = tm.forward(tp, t(toks).long())
    close(lt, lj)


def test_forward_dense_dispatch_matches_jax():
    """The full forward with a cache under the dense dispatch, dropless as
    the engine runs it: logits within 1e-5, expert counts exact."""
    cfg = tiny_moe()
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(17)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    off = np.asarray([0, 3], np.int32)
    jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24)
    fwd = jit(jm.forward, dropless=True, moe_dispatch="dense")
    for sl, o in ((slice(0, 8), off), (slice(8, 9), off + 8)):
        lj, jc, aj = fwd(jp, toks[:, sl], offset=o, cache=jc)
        lt, tc, at = tm.forward(tp, t(toks[:, sl]).long(), offset=t(o),
                                cache=tc, dropless=True, moe_dispatch="dense")
        close(lt, lj)
        np.testing.assert_array_equal(at["expert_counts"].numpy(),
                                      np.asarray(aj["expert_counts"]))
        assert int(at["dropped"]) == int(aj["dropped"]) == 0


def test_run_blocks_split_at_every_boundary():
    """run_blocks(0, k) then run_blocks(k, L - k), at every boundary k,
    equals the JAX package's run over all blocks (x, caches, counts)."""
    cfg = tiny_moe(n_layers=4)
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    off = np.asarray([0, 3], np.int32)
    pos = off[:, None] + np.arange(10, dtype=np.int32)[None]
    valid = np.ones((2, 10), bool)
    valid[0, 7:] = False
    run_all = jit(jm.run_blocks, start=0, n=4, dropless=True,
                  moe_dispatch="ragged")
    xj, jc, aj = run_all(jp, jit(jm.embed)(jp, toks),
                         cache=jm.init_cache(2, 24), positions=pos,
                         offset=off, valid=valid)
    xt0 = tm.embed(tp, t(toks).long())
    kwt = dict(positions=t(pos).long(), offset=t(off), valid=t(valid))
    for k in range(1, 4):
        tc = tm.init_cache(2, 24)
        xt, tc, at1 = tm.run_blocks(tp, xt0, 0, k, cache=tc, **kwt)
        xt, tc, at2 = tm.run_blocks(tp, xt, k, 4 - k, cache=tc, **kwt)
        close(xt, xj)
        for a_t, a_j in zip(at1 + at2, aj):
            np.testing.assert_array_equal(a_t["expert_counts"].numpy(),
                                          np.asarray(a_j["expert_counts"]))
        for leaf in ("k", "v"):
            close(tc[0][0][leaf], jc[0][0][leaf])


def test_index_map_and_block_params_mirror_jax():
    cfg = tiny_moe(n_layers=4)
    jm, jp, tm, tp = models(cfg)
    assert tm.index_map == jm.index_map
    for b in range(4):
        bj, bt = jm.block_params(jp, b), tm.block_params(tp, b)
        close(bt["moe"]["w_gate"], bj["moe"]["w_gate"], atol=0, rtol=0)


def test_init_params_shapes_and_distributions():
    """Port init draws the JAX package's shapes with normal x
    1/sqrt(fan_in) (0.02 for router and embeddings)."""
    cfg = tiny_moe(n_layers=2, d_model=128)
    jm = JaxModel(cfg)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = TorchModel(port_cfg(cfg), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert jax.tree_util.tree_structure(jshapes) == \
        jax.tree_util.tree_structure(tshapes)
    assert jshapes == tshapes
    seg = tp["segments"][0]["pattern"][0]
    assert abs(float(seg["attn"]["w_q"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(seg["moe"]["router"].std()) - 0.02) < 0.002
    assert abs(float(tp["embed"]["tok"].std()) - 0.02) < 0.002


# ------------------------------------- incremental cache (GQA cases)

S, K = 24, 4


def _full_vs_incremental(cfg):
    _, _, tm, tp = models(cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(2, S + K)))
    full, _, _ = tm.forward(tp, toks)
    cache = tm.init_cache(2, S + K + 8)
    lp, cache, _ = tm.forward(tp, toks[:, :S], cache=cache,
                              offset=torch.zeros(2, dtype=torch.int32))
    inc = [lp[:, -1]]
    for i in range(K):
        li, cache, _ = tm.forward(tp, toks[:, S + i:S + i + 1], cache=cache,
                                  offset=torch.full((2,), S + i,
                                                    dtype=torch.int32))
        inc.append(li[:, -1])
    return full[:, S - 1:].numpy(), torch.stack(inc, 1).numpy()


@pytest.mark.parametrize("make_cfg", [tiny_dense, tiny_moe],
                         ids=["gqa", "gqa+moe"])
def test_incremental_matches_full(make_cfg):
    full, inc = _full_vs_incremental(make_cfg())
    np.testing.assert_allclose(inc, full, atol=3e-4, rtol=3e-4)


def test_sliding_window_matches_full():
    full, inc = _full_vs_incremental(tiny_dense(sliding_window=8))
    np.testing.assert_allclose(inc, full, atol=3e-4, rtol=3e-4)


def test_prefill_in_two_chunks_matches_one_shot():
    _, _, tm, tp = models(tiny_dense())
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, 256, (1, S)))
    cache = tm.init_cache(1, S + 8)
    _, cache, _ = tm.forward(tp, toks[:, :S // 2], cache=cache,
                             offset=torch.zeros(1, dtype=torch.int32))
    l2, cache, _ = tm.forward(tp, toks[:, S // 2:], cache=cache,
                              offset=torch.full((1,), S // 2,
                                                dtype=torch.int32))
    full, _, _ = tm.forward(tp, toks)
    np.testing.assert_allclose(l2.numpy(), full[:, S // 2:].numpy(),
                               atol=3e-4, rtol=3e-4)


def test_valid_masked_rows_do_not_corrupt_state():
    """A masked decode step leaves that row's cache (and so its next real
    decode) unchanged — the engine's full-pool decode relies on it."""
    _, _, tm, tp = models(tiny_moe())
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (2, S)))
    cache = tm.init_cache(2, S + 8)
    _, cache, _ = tm.forward(tp, toks, cache=cache,
                             offset=torch.zeros(2, dtype=torch.int32))
    snapshot = [[{k: v.clone() for k, v in c.items()} for c in seg]
                for seg in cache]
    _, cache, aux = tm.forward(tp, torch.tensor([[3], [7]]), cache=cache,
                               offset=torch.tensor([S, S], dtype=torch.int32),
                               valid=torch.tensor([[True], [False]]))
    assert int(aux["expert_counts"].sum()) == 2 * 2     # one row, top-2, 2 blocks
    nxt = torch.tensor([[11], [11]])
    l_ref, _, _ = tm.forward(tp, nxt, cache=snapshot,
                             offset=torch.tensor([S, S], dtype=torch.int32))
    l_got, _, _ = tm.forward(tp, nxt, cache=cache,
                             offset=torch.tensor([S + 1, S], dtype=torch.int32))
    np.testing.assert_allclose(l_got[1].numpy(), l_ref[1].numpy(), **TOL)
