"""The port's training step against the JAX package's on the CPU, in fp32:
``loss_fn`` (``loss``, ``ce``, ``aux_loss``; ``dropped`` exactly) and
every parameter's gradient against ``jax.value_and_grad`` of JAX's
``loss_fn`` on the same weights (the JAX init converted through
``repro_torch.convert``) and the same numpy batch, on the five tiny configs
(dense, MoE with capacity drops, MLA, RG-LRU + local attention, xLSTM);
three AdamW steps against JAX's ``make_train_step`` (metrics, parameters
and moments after them); one step of every assigned smoke config (the
port of ``tests/test_arch_smoke.py::test_smoke_train_step``) against
JAX's loss and grad norm.  Tolerance as in tests/test_torch_model.py:
rtol 1e-5 and atol 1e-5 of each tensor's (each leaf's) scale."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_hybrid, tiny_mla, tiny_moe, tiny_xlstm
from repro.configs import ASSIGNED
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.config import MoEConfig
from repro.training import train as jtrain
from repro.training.optimizer import adamw as jadamw
from repro_torch.convert import from_jax_opt_state
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from test_torch_model import close, models, port_cfg, t

B, S = 2, 16


def tiny_moe_drops():
    """tiny_moe at capacity factor 0.5: the dense dispatch drops."""
    return tiny_moe(moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                                  capacity_factor=0.5))


TINY = {"tiny_dense": tiny_dense, "tiny_moe": tiny_moe_drops,
        "tiny_mla": tiny_mla, "tiny_hybrid": tiny_hybrid,
        "tiny_xlstm": tiny_xlstm}


def batch(cfg, seed: int = 0, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = rng.random((b, s)) > 0.2
    return tokens, targets, mask


def tbatch(tokens, targets, mask, enc_out=None):
    out = {"tokens": t(tokens).long(), "targets": t(targets).long(),
           "mask": t(mask)}
    if enc_out is not None:
        out["enc_out"] = t(enc_out)
    return out


def jax_value_and_grad(jm, jp, tokens, targets, mask, enc_out=None):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(jm, p, tokens, targets, mask, enc_out),
        has_aux=True))
    (_, metrics), grads = fn(jp)
    return metrics, grads


def torch_value_and_grad(tm, tp, b, enc_out=None):
    leaves = topt.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = ttrain.loss_fn(tm, tp, b["tokens"], b["targets"],
                                   b["mask"], enc_out)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return metrics, [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]


def check_metrics(mt, mj):
    for k in ("loss", "ce", "aux_loss"):
        close(mt[k], np.asarray(mj[k]))
    assert int(mt["dropped"]) == int(mj["dropped"])


@pytest.mark.parametrize("name", list(TINY))
def test_loss_and_grads_match_jax(name):
    cfg = TINY[name]()
    jm, jp, tm, tp = models(cfg)
    tokens, targets, mask = batch(cfg)
    mj, gj = jax_value_and_grad(jm, jp, tokens, targets, mask)
    mt, gt = torch_value_and_grad(tm, tp, tbatch(tokens, targets, mask))
    check_metrics(mt, mj)
    if name == "tiny_moe":
        assert int(mt["dropped"]) > 0        # the capacity drops something
    leaves_j = jax.tree_util.tree_leaves(gj)
    assert len(leaves_j) == len(gt)
    for got, want in zip(gt, leaves_j):
        assert tuple(got.shape) == tuple(want.shape)
        close(got, np.asarray(want))


def test_three_adamw_steps_match_jax():
    """Three steps of ``make_train_step`` (WSD schedule in its warmup and
    plateau, the clip active) from the same weights and batches: metrics
    each step, then every parameter and moment."""
    cfg = tiny_moe_drops()
    jm, jp, tm, tp = models(cfg)
    kw = dict(lr=3e-3, schedule="wsd", total_steps=4, warmup=2,
              grad_clip=0.5)
    jo, to = jadamw(**kw), topt.adamw(**kw)
    jstep = jax.jit(jtrain.make_train_step(jm, jo))
    tstep = ttrain.make_train_step(tm, to)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        tokens, targets, mask = batch(cfg, seed=i)
        jp, js, mj = jstep(jp, js, {"tokens": tokens, "targets": targets,
                                    "mask": mask})
        tp, ts, mt = tstep(tp, ts, tbatch(tokens, targets, mask))
        check_metrics(mt, mj)
        close(mt["grad_norm"], np.asarray(mj["grad_norm"]))
        close(mt["lr"], np.asarray(mj["lr"]))
    assert int(ts.step) == int(js.step) == 3
    for got, want in zip(topt.tree_leaves((ts.mu, ts.nu)),
                         jax.tree_util.tree_leaves((js.mu, js.nu))):
        close(got, np.asarray(want))
    # parameters: 1e-5 of the leaf's scale plus 1e-2 of the largest move
    # three steps can make (lr x 3: AdamW's m / (sqrt(v) + eps) is O(1)
    # for any gradient, so an element whose gradient is as small as the
    # two frameworks' summation noise moves by an amount they may round
    # apart — seen up to 1.9e-5, 0.2% of the move, with every gradient,
    # moment and metric within 1e-5)
    for got, want in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        close(got, want, rtol=1e-5, atol=1e-5 * scale + 1e-2 * 3e-3 * 3)


def test_jax_opt_state_continues_in_the_port():
    """A JAX run's (params, opt state) after two steps, converted through
    ``from_jax_params`` / ``from_jax_opt_state``, takes the third step in
    the port as JAX takes it."""
    cfg = tiny_dense()
    jm, jp, tm, _ = models(cfg)
    jo = jadamw(lr=1e-3, schedule="cosine", total_steps=10, warmup=1)
    to = topt.adamw(lr=1e-3, schedule="cosine", total_steps=10, warmup=1)
    jstep = jax.jit(jtrain.make_train_step(jm, jo))
    js = jo.init(jp)
    batches = [batch(cfg, seed=10 + i) for i in range(3)]
    for tokens, targets, mask in batches[:2]:
        jp, js, _ = jstep(jp, js, {"tokens": tokens, "targets": targets,
                                   "mask": mask})
    from repro_torch.convert import from_jax_params
    tp = from_jax_params(port_cfg(cfg), jax.tree_util.tree_map(np.asarray,
                                                               jp), "cpu")
    ts = from_jax_opt_state(port_cfg(cfg), jax.tree_util.tree_map(
        np.asarray, js), "cpu")
    assert int(ts.step) == 2
    tokens, targets, mask = batches[2]
    jp, js, mj = jstep(jp, js, {"tokens": tokens, "targets": targets,
                                "mask": mask})
    tp, ts, mt = ttrain.make_train_step(tm, to)(tp, ts, tbatch(
        tokens, targets, mask))
    check_metrics(mt, mj)
    for got, want in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        # one step of lr 1e-3: 1e-2 of the move, as in the test above
        close(got, want, rtol=1e-5, atol=1e-5 * scale + 1e-2 * 1e-3)


def _smoke_inputs(cfg):
    """tests/test_arch_smoke.py's inputs: tokens arange % (V - 1) + 1,
    targets rolled by one, all-true mask, whisper's frames ones x 0.01 fed
    as ``enc_out``."""
    b, s = 2, 32
    tokens = (np.arange(1, b * s + 1, dtype=np.int32).reshape(b, s)
              % (cfg.vocab_size - 1) + 1)
    targets = np.roll(tokens, -1, axis=1)
    mask = np.ones((b, s), bool)
    enc = (np.ones((b, cfg.encoder.n_frames, cfg.d_model), np.float32) * 0.01
           if cfg.encoder.enabled else None)
    return tokens, targets, mask, enc


@pytest.mark.parametrize("arch", ASSIGNED)
def test_smoke_train_step_matches_jax(arch):
    """One train step of each assigned smoke config: finite positive loss,
    changed parameters, and loss, ce, aux_loss, dropped and the grad norm
    equal to JAX's ``make_train_step``."""
    cfg = jax_get_smoke_config(arch)
    jm, jp, tm, tp = models(cfg)
    tokens, targets, mask, enc = _smoke_inputs(cfg)
    jo = jadamw(lr=1e-3, total_steps=10, warmup=1)
    to = topt.adamw(lr=1e-3, total_steps=10, warmup=1)
    jb = {"tokens": tokens, "targets": targets, "mask": mask}
    if enc is not None:
        jb["enc_out"] = enc
    _, _, mj = jax.jit(jtrain.make_train_step(
        jm, jo, cfg.encoder.enabled))(jp, jo.init(jp), jb)
    before = [p.clone() for p in topt.tree_leaves(tp)]
    tp, _, mt = ttrain.make_train_step(tm, to, cfg.encoder.enabled)(
        tp, to.init(tp), tbatch(tokens, targets, mask, enc))
    loss = float(mt["loss"])
    assert np.isfinite(loss) and loss > 0, (arch, loss)
    delta = sum(float((a - b_).abs().sum())
                for a, b_ in zip(topt.tree_leaves(tp), before))
    assert delta > 0, arch
    check_metrics(mt, mj)
    close(mt["grad_norm"], np.asarray(mj["grad_norm"]))


def test_remat_grads_equal_plain_grads():
    """Activation checkpointing per block recomputes the same forward: the
    gradients are those without it, bit for bit."""
    cfg = tiny_moe_drops()
    _, _, _, tp = models(cfg)
    from repro_torch.models.model import DecoderModel
    b = tbatch(*batch(cfg, seed=3))
    out = []
    for remat in (False, True):
        tm = DecoderModel(port_cfg(cfg), device="cpu", remat=remat)
        out.append(torch_value_and_grad(tm, tp, b))
    (m0, g0), (m1, g1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b_ in zip(g0, g1):
        assert torch.equal(a, b_)


def test_jax_remat_flag_agrees():
    """JAX's own remat path gives the same loss as the port's remat path
    (the two ``remat`` flags compute the same function)."""
    cfg = tiny_dense()
    jm, jp, _, tp = models(cfg)
    from repro.models.model import DecoderModel as JaxModel
    from repro_torch.models.model import DecoderModel
    tokens, targets, mask = batch(cfg, seed=4)
    mj, gj = jax_value_and_grad(JaxModel(cfg, remat=True), jp, tokens,
                                targets, mask)
    mt, gt = torch_value_and_grad(DecoderModel(port_cfg(cfg), device="cpu",
                                               remat=True), tp,
                                  tbatch(tokens, targets, mask))
    check_metrics(mt, mj)
    for got, want in zip(gt, jax.tree_util.tree_leaves(gj)):
        close(got, np.asarray(want))
