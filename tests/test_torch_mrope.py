"""Qwen2-VL's M-RoPE and vision stub in the port (``qwen2-vl-72b``'s
smoke variant: 8/1 heads of 32, sections (6, 5, 5)) against the JAX
package on the CPU, in fp32, within 1e-5 of the tensor's scale
(tests/test_torch_model.py's tolerance): ``apply_mrope`` with three
different position planes, M-RoPE with equal planes against RoPE, the
attention mixer with ``positions3`` through the cache, the logits with
and without 8 prepended patch embeddings, a twin of
tests/test_attention_cache.py's check that the positions are used, engine
traces (served text-only, as the JAX engine serves it) and the
launcher."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as parity
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from test_torch_model import close, models, port_tree, t

CFG = jax_smoke("qwen2-vl-72b")


@pytest.mark.parametrize("hd,sections", [(32, (6, 5, 5)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_with_three_planes_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 4, hd)).astype(np.float32)
    p3 = rng.integers(0, 3000, (3, 2, 7)).astype(np.int32)
    assert len({tuple(p.ravel()) for p in p3}) == 3
    got = tlayers.apply_mrope(t(x), t(p3), 1e6, sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, sections)
    close(got, want)
    with pytest.raises(AssertionError):
        tlayers.apply_mrope(t(x), t(p3), 1e6, sections[:2])


def test_mrope_with_equal_planes_is_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    plane = tlayers.position_plane(t(pos))
    assert tuple(plane.shape) == (3, 2, 7)
    np.testing.assert_array_equal(
        plane.numpy(), np.asarray(jlayers.position_plane(jnp.asarray(pos))))
    got = tlayers.apply_mrope(t(x), plane, 1e6, (6, 5, 5))
    assert torch.equal(got, tlayers.apply_rope(t(x), t(pos), 1e6))
    close(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_attention_with_positions3_through_the_cache_matches_jax():
    """A 5-token prefill at offsets 0 and 3 with three different position
    planes, over the slot-row cache."""
    jm, jp, tm, tp = models(CFG)
    spec = tm.specs[0]
    jbp = jm.block_params(jp, 0)["attn"]
    tbp = port_tree(CFG, jbp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    off = np.asarray([0, 3], np.int32)
    pos = off[:, None] + np.arange(5, dtype=np.int32)[None]
    p3 = np.stack([pos, pos * 2, pos + 7]).astype(np.int32)
    jc = jattn.init_cache_attn(CFG, spec, 2, 16)
    tc = tattn.init_cache_attn(tm.cfg, spec, 2, 16, "cpu")
    want, jc = jattn.apply_gqa(CFG, spec, jbp, jnp.asarray(x),
                               positions=jnp.asarray(pos),
                               offset=jnp.asarray(off), cache=jc,
                               positions3=jnp.asarray(p3))
    got, tc = tattn.apply_gqa(tm.cfg, spec, tbp, t(x), positions=t(pos),
                              offset=t(off), cache=tc, positions3=t(p3))
    close(got, want)
    close(tc["k"], jc["k"])


@pytest.mark.parametrize("n_patches", [0, 8])
def test_qwen2_vl_logits_match_jax(n_patches):
    """The forward with and without 8 patch embeddings prepended (which
    move the text to positions 8 on)."""
    jm, jp, tm, tp = models(CFG)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 500, (2, 12)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if n_patches:
        extra = (rng.standard_normal((2, n_patches, CFG.d_model))
                 * 0.02).astype(np.float32)
        kw_j["extra_embeds"], kw_t["extra_embeds"] = jnp.asarray(extra), \
            t(extra)
    want, _, _ = jm.forward(jp, jnp.asarray(toks), **kw_j)
    got, _, _ = tm.forward(tp, t(toks).long(), **kw_t)
    assert tuple(got.shape) == (2, 12 + n_patches, CFG.vocab_size)
    close(got, want)


def test_mrope_positions_change_logits():
    """tests/test_attention_cache.py's M-RoPE check on the port: other
    positions give other logits."""
    _, _, tm, tp = models(CFG)
    assert tm.cfg.mrope_sections
    toks = torch.arange(1, 17)[None]
    l1, _, _ = tm.forward(tp, toks)
    l2, _, _ = tm.forward(tp, toks, positions=torch.arange(16)[None] + 5)
    assert not torch.allclose(l1, l2)


@pytest.mark.parametrize("sched", ["layered", "chunked"])
def test_engine_matches_jax_engine(sched):
    rng = np.random.default_rng(4)
    jobs = [(tuple(int(x) for x in rng.integers(1, 500, n)), 6)
            for n in (11, 27, 30)]
    want = parity.run("jax", CFG, sched, jobs=jobs)
    got = parity.run("torch", CFG, sched, jobs=jobs)
    parity.assert_same(got, want, ["plans", "outputs", "ttft", "token_times",
                                   "iterations", "n_dispatches"])


def test_launcher_serves_qwen2_vl(capsys):
    serve.main(["--arch", "qwen2-vl-72b", "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "qwen2-vl-72b-smoke x layered" in out
    assert "[serve] encoder" not in out
