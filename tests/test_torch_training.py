"""The port's training substrate (``repro_torch.training``) on the CPU:
the ports of tests/test_training.py's ten tests; AdamW and the schedules
against the JAX package's (fp32 and bf16 leaves, the clip, the decay
mask), identical ``PackedDataset`` batches, checkpoint leaf names equal to
those JAX's ``save`` writes; the plain backward versions of K2 and K4
(``kernels/ref.py``) against ``jax.vjp`` of JAX's ``masked_attention`` /
``expert_ffn_ref`` and against ``torch.autograd`` on the plain forwards;
and the launcher against the JAX launcher's ``[train]`` losses.
Tolerance as in tests/test_torch_model.py (rtol 1e-5, atol 1e-5 of the
tensor's scale) unless a test states another."""

from __future__ import annotations

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.training import checkpoint as jckpt
from repro.training.data import PackedDataset as JPackedDataset
from repro.training.data import SyntheticCorpus as JSyntheticCorpus
from repro.training.optimizer import adamw as jadamw
from repro.training.optimizer import cosine_schedule as jcosine
from repro.training.optimizer import wsd_schedule as jwsd
from repro_torch.kernels import ops, ref
from repro_torch.models.model import DecoderModel
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import PackedDataset, SyntheticCorpus
from repro_torch.training.optimizer import (adamw, cosine_schedule,
                                            tree_leaves, wsd_schedule)
from repro_torch.training.train import Trainer
from test_torch_model import close, models, port_cfg, t


# ------------------------------- the ports of tests/test_training.py


def test_adamw_minimizes_quadratic():
    opt = adamw(lr=0.1, schedule="const")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_applies():
    opt = adamw(lr=0.0, schedule="const", grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, m = opt.update({"w": torch.full((3,), 100.0)}, state, params)
    assert float(m["grad_norm"]) > 1.0   # reported pre-clip


def test_wsd_schedule_shape():
    fn = wsd_schedule(1e-3, total_steps=1000, warmup=100)
    s = lambda i: float(fn(torch.tensor(i)))
    assert s(0) == 0.0
    assert s(50) == pytest.approx(5e-4)
    assert s(100) == pytest.approx(1e-3)
    assert s(500) == pytest.approx(1e-3)       # stable plateau
    assert s(899) == pytest.approx(1e-3)
    assert s(950) < 1e-3                       # decaying
    assert s(1000) == pytest.approx(1e-5, rel=0.01)


def test_cosine_schedule_shape():
    fn = cosine_schedule(1e-3, total_steps=1000, warmup=100)
    s = lambda i: float(fn(torch.tensor(i)))
    assert s(100) == pytest.approx(1e-3)
    assert s(1000) == pytest.approx(1e-4, rel=0.01)   # 10% floor


def test_packed_dataset_shapes_and_mask():
    corpus = SyntheticCorpus(vocab_size=128, seed=0)
    ds = PackedDataset(corpus, seq_len=64, batch_size=4, seed=1)
    it = iter(ds)
    tokens, targets, mask = next(it)
    assert tokens.shape == targets.shape == mask.shape == (4, 64)
    assert tokens.dtype == np.int32
    t2, _, _ = next(it)
    assert not np.array_equal(tokens, t2)      # iterator advances
    assert (~mask[targets == 0]).all()


def test_packed_dataset_deterministic():
    c = SyntheticCorpus(vocab_size=128, seed=0)
    a = next(iter(PackedDataset(c, 32, 2, seed=7)))
    b = next(iter(PackedDataset(c, 32, 2, seed=7)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _tiny_params(cfg):
    return DecoderModel(port_cfg(cfg), device="cpu").init_params(
        torch.Generator().manual_seed(0))


def test_checkpoint_roundtrip(tmp_path):
    params = _tiny_params(tiny_moe())
    path = os.path.join(tmp_path, "ckpt.pt")
    ckpt.save(path, {"params": params, "step": torch.tensor(7)})
    template = {"params": jax.tree_util.tree_map(torch.zeros_like, params),
                "step": torch.tensor(0)}
    restored = ckpt.restore(path, template)
    assert int(restored["step"]) == 7
    for a, b in zip(tree_leaves(params), tree_leaves(restored["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_missing_leaf_raises(tmp_path):
    path = os.path.join(tmp_path, "c.pt")
    ckpt.save(path, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore(path, {"a": torch.zeros(2), "b": torch.zeros(1)})


def test_loss_decreases_on_synthetic_corpus():
    """End-to-end: a tiny model's loss must visibly drop on the structured
    synthetic corpus within 60 steps."""
    cfg = tiny_dense(n_layers=2, d_model=128, vocab_size=128)
    model = DecoderModel(port_cfg(cfg), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw(lr=3e-3, schedule="cosine", total_steps=60, warmup=5)
    trainer = Trainer(model=model, opt=opt, params=params)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
    ds = PackedDataset(corpus, seq_len=64, batch_size=8, seed=0)
    hist = trainer.fit(iter(ds), steps=60, log_every=5)
    first, last = hist[0]["ce"], hist[-1]["ce"]
    assert last < first - 0.5, (first, last)
    assert sorted(hist[0]) == sorted(["loss", "ce", "aux_loss", "dropped",
                                      "grad_norm", "lr", "step", "wall"])


def test_trainer_checkpointing(tmp_path):
    cfg = tiny_dense(d_model=32, n_layers=1, vocab_size=64)
    model = DecoderModel(port_cfg(cfg), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = adamw(lr=1e-3, total_steps=20, warmup=2)
    trainer = Trainer(model=model, opt=opt, params=params)
    corpus = SyntheticCorpus(vocab_size=64, seed=0)
    ds = PackedDataset(corpus, seq_len=32, batch_size=2, seed=0)
    path = os.path.join(tmp_path, "t.pt")
    trainer.fit(iter(ds), steps=10, checkpoint_path=path, checkpoint_every=5)
    assert os.path.exists(path)
    restored = ckpt.restore(path, {"params": trainer.params,
                                   "opt": trainer.opt_state})
    # restored state is the step-10 state
    assert int(restored["opt"].step) == 10
    for a, b in zip(tree_leaves(restored), tree_leaves(
            {"params": trainer.params, "opt": trainer.opt_state})):
        assert torch.equal(a, b)


# ------------------------------------------------ against the JAX package


def _opt_tree(rng):
    """fp32 and bf16 leaves of 1, 2 and 3 dimensions (the decay mask)."""
    return {"norm": rng.normal(size=(8,)).astype(np.float32),
            "w": rng.normal(size=(8, 6)).astype(np.float32),
            "stack": [rng.normal(size=(2, 4, 3)).astype(np.float32)],
            "half": rng.normal(size=(5, 4)).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adamw_update_matches_jax(grad_scale):
    """Three updates: parameters (fp32 and bf16 leaves), moments, grad norm
    (before the clip) and lr against JAX's AdamW under each schedule."""
    rng = np.random.default_rng(0)
    p_np = _opt_tree(rng)
    grads_np = [jax.tree_util.tree_map(lambda a: (a * 0 + rng.normal(
        size=a.shape) * grad_scale).astype(np.float32), p_np)
        for _ in range(3)]
    for schedule in ("wsd", "cosine", "const"):
        kw = dict(lr=1e-2, schedule=schedule, total_steps=4, warmup=2)
        jo, to = jadamw(**kw), adamw(**kw)
        jp = {k: jnp.asarray(v) for k, v in p_np.items() if k != "stack"}
        jp["stack"] = [jnp.asarray(p_np["stack"][0])]
        jp["half"] = jp["half"].astype(jnp.bfloat16)
        tp = jax.tree_util.tree_map(lambda a: t(np.asarray(a, np.float32)),
                                    jp)
        tp["half"] = tp["half"].to(torch.bfloat16)
        js, ts = jo.init(jp), to.init(tp)
        for g in grads_np:
            jg = jax.tree_util.tree_map(jnp.asarray, g)
            jg["half"] = jg["half"].astype(jnp.bfloat16)
            tg = jax.tree_util.tree_map(t, g)
            tg["half"] = tg["half"].to(torch.bfloat16)
            jp, js, mj = jo.update(jg, js, jp)
            tp, ts, mt = to.update(tg, ts, tp)
            close(mt["grad_norm"], np.asarray(mj["grad_norm"]))
            close(mt["lr"], np.asarray(mj["lr"]))
        assert tp["half"].dtype == torch.bfloat16
        for got, want in zip(tree_leaves((tp, ts.mu, ts.nu)),
                             jax.tree_util.tree_leaves((jp, js.mu, js.nu))):
            want = np.asarray(want, np.float32)
            if got.dtype == torch.bfloat16:
                # the same fp32 value rounded once to bf16: at most one
                # bf16 ulp apart where the fp32 values straddle a tie
                close(got.float(), want, rtol=2 ** -7, atol=0)
            else:
                close(got, want)
    # the decay mask: a leaf with ndim >= 2 decays under a zero gradient,
    # a 1-D one does not
    to = adamw(lr=0.1, schedule="const")
    p = {"v": torch.ones(3), "m": torch.ones(2, 2)}
    p, _, _ = to.update({"v": torch.zeros(3), "m": torch.zeros(2, 2)},
                        to.init(p), p)
    assert torch.equal(p["v"], torch.ones(3))
    assert (p["m"] < 1).all()


def test_schedules_match_jax():
    for t_fn, j_fn in ((wsd_schedule, jwsd), (cosine_schedule, jcosine)):
        tf, jf = t_fn(3e-4, 1000, 37), j_fn(3e-4, 1000, 37)
        for step in (0, 1, 5, 36, 37, 38, 500, 899, 900, 901, 950, 999,
                     1000, 1200):
            want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
            close(tf(torch.tensor(step, dtype=torch.int32)), want)
            close(tf(step), want)                  # an int step too


def test_packed_dataset_matches_jax():
    """Identical batches to the JAX package's pipeline (same draws)."""
    for vocab, seq, batch, seed in ((128, 64, 4, 1), (1000, 33, 3, 5)):
        ours = iter(PackedDataset(SyntheticCorpus(vocab, seed=seed), seq,
                                  batch, seed=seed + 1, mean_doc_len=40))
        theirs = iter(JPackedDataset(JSyntheticCorpus(vocab, seed=seed), seq,
                                     batch, seed=seed + 1, mean_doc_len=40))
        for _ in range(6):
            for a, b in zip(next(ours), next(theirs)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_checkpoint_leaf_names_match_jax(tmp_path):
    """The flat leaf names (params and AdamW state) are those JAX's
    ``save`` writes for the same trees."""
    cfg = tiny_moe()
    jm, jp, _, tp = models(cfg)
    jo, to = jadamw(), adamw()
    jpath = os.path.join(tmp_path, "j.msgpack")
    tpath = os.path.join(tmp_path, "t.pt")
    jckpt.save(jpath, {"params": jp, "opt": jo.init(jp),
                       "step": jnp.asarray(3)})
    tree = {"params": tp, "opt": to.init(tp), "step": torch.tensor(3)}
    ckpt.save(tpath, tree)
    with open(jpath, "rb") as f:
        jnames = list(msgpack.unpackb(f.read(), raw=False))
    tnames = list(torch.load(tpath, weights_only=True))
    assert tnames == jnames == ckpt.leaf_names(tree)


# ---------------------------------------- the plain backward versions


def _attn_inputs(rng, b, p, s_max, h, hkv, dk, dv):
    q = rng.normal(size=(b, p, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s_max, hkv, dk)).astype(np.float32)
    v = rng.normal(size=(b, s_max, hkv, dv)).astype(np.float32)
    do = rng.normal(size=(b, p, h, dv)).astype(np.float32)
    return q, k, v, do


# (B, P, S_max, H, Hkv, dk, dv, offsets, window, causal)
ATTN_CASES = {
    "train_g1": (2, 40, 40, 4, 4, 64, 64, (0, 0), None, True),
    "train_g8": (1, 33, 33, 8, 1, 16, 16, (0,), None, True),
    "offsets_window": (2, 12, 40, 6, 2, 8, 8, (5, 28), 9, True),
    "mla_widths": (2, 10, 10, 2, 2, 24, 16, (0, 0), None, True),
    "non_causal": (2, 7, 19, 4, 2, 8, 8, (0, 0), None, False),
    "query_chunks": (1, 1024, 1024, 2, 1, 8, 8, (0,), None, True),
    # recurrentgemma's shape of heads (g 16, one kv head) at hd 32, under
    # a window that binds, without and with a cache before the new tokens
    "g16_window": (2, 40, 40, 16, 1, 32, 32, (0, 0), 9, True),
    "g16_window_offsets": (2, 40, 100, 16, 1, 32, 32, (7, 60), 9, True),
    # MLA's unequal widths (H = Hkv) at offsets into a cache
    "mla_offsets": (2, 10, 40, 2, 2, 24, 16, (3, 30), None, True),
    # cross-attention: S_max past P and off the kernels' key tiles
    "non_causal_partial_tile": (2, 7, 75, 4, 2, 8, 8, (0, 0), None, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_prefill_attention_bwd_ref_matches_jax_vjp(case):
    """``prefill_attention_bwd_ref`` (from the forward's output and
    log-sum-exp) against ``jax.vjp`` of JAX's ``masked_attention`` under
    the prefill contract's masks, and against ``torch.autograd`` through
    the plain forward; the log-sum-exp against ``torch.logsumexp`` of
    the masked scores.  Keys no query sees get zero gradients."""
    b, p, s_max, h, hkv, dk, dv, offs, window, causal = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v, do = _attn_inputs(rng, b, p, s_max, h, hkv, dk, dv)
    off = np.asarray(offs, np.int32)
    q_pos = (off[:, None] + np.arange(p)[None]).astype(np.int32)
    kv_pos = np.arange(s_max, dtype=np.int32)
    kv_valid = kv_pos[None] < (off + p)[:, None]
    if not causal:
        kv_valid = np.ones((b, s_max), bool)

    def jfn(q_, k_, v_):
        return jattn.masked_attention(q_, k_, v_, q_pos, kv_pos, kv_valid,
                                      causal=causal, window=window)
    _, vjp = jax.vjp(jfn, q, k, v)
    want = vjp(do)

    tq, tk, tv = t(q), t(k), t(v)
    offs_t = t(off)
    o = ref.prefill_attention_ref(tq, tk, tv, offs_t, window=window,
                                  causal=causal)
    lse = ref.prefill_attention_lse_ref(tq, tk, tv, offs_t, window=window,
                                        causal=causal)
    got = ref.prefill_attention_bwd_ref(tq, tk, tv, o, lse, t(do), offs_t,
                                        window=window, causal=causal)
    for g_, w_ in zip(got, want):
        close(g_, np.asarray(w_))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = ref.prefill_attention_ref(*leaves, offs_t, window=window,
                                    causal=causal)
    auto = torch.autograd.grad(out, leaves, t(do))
    for g_, a_ in zip(got, auto):
        close(g_, a_.numpy())
    # the autograd Function of the wrapper (plain versions on the CPU)
    # gives the same gradients
    fn_leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    fn_out = ops.prefill_attention(*fn_leaves, offs_t, window=window,
                                   causal=causal)
    for g_, a_ in zip(got, torch.autograd.grad(fn_out, fn_leaves, t(do))):
        assert torch.equal(g_, a_)
    vis = ref._prefill_visible(tq, tk, offs_t, window, causal)
    s = ref._grouped_scores(tq, tk, vis)
    close(lse, torch.logsumexp(s, -1).reshape(b, h, p).numpy())
    if causal:
        seen = vis.any(dim=1)                       # (B, S_max)
        assert (got[1][~seen] == 0).all() and (got[2][~seen] == 0).all()


@pytest.mark.parametrize("widths", [(4, 5, 16, 24), (3, 1, 12, 20)])
def test_moe_gmm_bwd_ref_matches_jax_vjp(widths):
    """``moe_gmm_bwd_ref`` against ``jax.vjp`` of JAX's ``expert_ffn_ref``
    (the function JAX's training path differentiates) and against
    ``torch.autograd`` through ``moe_gmm_ref``; also the wrapper's autograd
    Function, d and F off a multiple of 8 included."""
    e, c, d, f = widths
    rng = np.random.default_rng(e * c)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    wg = rng.normal(size=(e, d, f)).astype(np.float32) / np.sqrt(d)
    wu = rng.normal(size=(e, d, f)).astype(np.float32) / np.sqrt(d)
    wd = rng.normal(size=(e, f, d)).astype(np.float32) / np.sqrt(f)
    dy = rng.normal(size=(e, c, d)).astype(np.float32)

    def jfn(x_, wg_, wu_, wd_):
        return jmoe.expert_ffn_ref(None, {"w_gate": wg_, "w_up": wu_,
                                          "w_down": wd_}, x_)
    _, vjp = jax.vjp(jfn, x, wg, wu, wd)
    want = vjp(dy)
    args = [t(a) for a in (x, wg, wu, wd)]
    got = ref.moe_gmm_bwd_ref(*args, t(dy))
    for g_, w_ in zip(got, want):
        close(g_, np.asarray(w_))
    leaves = [a.clone().requires_grad_(True) for a in args]
    auto = torch.autograd.grad(ref.moe_gmm_ref(*leaves), leaves, t(dy))
    for g_, a_ in zip(got, auto):
        close(g_, a_.numpy())
    leaves = [a.clone().requires_grad_(True) for a in args]
    fn = torch.autograd.grad(ops.moe_gmm(*leaves), leaves, t(dy))
    for g_, a_ in zip(got, fn):
        assert torch.equal(g_, a_)


def test_backward_launches_count_nothing_on_the_cpu():
    """The CPU path takes the plain versions: no launch is counted."""
    ops.reset_launches()
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 4, 2, 8, requires_grad=True)
    out = ops.prefill_attention(q, k, k, torch.zeros(1, dtype=torch.int32))
    out.sum().backward()
    assert not any(ops.LAUNCHES.values())


# ----------------------------------------------------------- launcher


def _train_lines(text: str):
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in re.finditer(r"\[train\] step +(\d+) loss=([\d.]+) "
                                 r"lr=([\d.e+-]+)", text)]


def _jax_launcher_loop(cfg, steps: int, batch: int, seq: int):
    """The JAX launcher's loop (``repro/launch/train.py``: init from
    PRNGKey(0), WSD at lr 6e-4, warmup max(steps // 10, 1), the jitted
    ``make_train_step`` over ``PackedDataset`` seed 0, a line at step 1
    and every tenth) without its mesh: on this JAX version the launcher's
    sharding context raises (the seed's failing
    tests/test_sharding.py::test_shard_hint_applies_in_context).  Returns
    (initial params, [(step, loss, lr)], final params, step 1's
    gradients)."""
    from repro.models.model import DecoderModel as JaxModel
    from repro.training.train import loss_fn, make_train_step
    model = JaxModel(cfg, remat=False)
    opt = jadamw(lr=6e-4, schedule="wsd", total_steps=steps,
                 warmup=max(steps // 10, 1))
    p0 = jax.jit(model.init)(jax.random.PRNGKey(0))
    params, state = p0, opt.init(p0)
    step_fn = jax.jit(make_train_step(model, opt, cfg.encoder.enabled))
    ds = iter(JPackedDataset(JSyntheticCorpus(cfg.vocab_size, seed=0),
                             seq_len=seq, batch_size=batch, seed=0))
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(
        model, p, b["tokens"], b["targets"], b["mask"], b.get("enc_out"))[0]))
    lines = []
    for step in range(1, steps + 1):
        tokens, targets, mask = next(ds)
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets), "mask": jnp.asarray(mask)}
        if cfg.encoder.enabled:
            jbatch["enc_out"] = jnp.zeros(
                (batch, cfg.encoder.n_frames, cfg.d_model), cfg.dtype)
        if step == 1:
            g1 = grad_fn(params, jbatch)
        params, state, m = step_fn(params, state, jbatch)
        if step % 10 == 0 or step == 1:
            lines.append((step, float(m["loss"]), float(m["lr"])))
    return p0, lines, params, g1


# the launcher's default, and the three archs whose attention trains
# through K2's backward at a window, MLA's widths or causal=False
LAUNCHER_ARCHS = ["minicpm-2b", "deepseek-v2-236b", "recurrentgemma-9b",
                  "whisper-base"]


def _port_step1_grads(cfg, params, batch: int, seq: int):
    """The port's step-1 gradients (in ``tree_leaves`` order, as numpy)
    at ``params`` on the launcher's first batch."""
    from repro_torch.training.train import device_batch, loss_fn
    model = DecoderModel(port_cfg(cfg), device="cpu")
    tokens, targets, mask = next(iter(PackedDataset(
        SyntheticCorpus(cfg.vocab_size, seed=0), seq_len=seq,
        batch_size=batch, seed=0)))
    b = device_batch(model, tokens, targets, mask)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(model, params, b["tokens"], b["targets"], b["mask"],
                      b.get("enc_out"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return [np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", LAUNCHER_ARCHS)
def test_launcher_matches_jax_launcher(tmp_path, arch):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 3
    --arch <arch>`` from the JAX launcher's initial weights (converted,
    given by ``--init``) prints the JAX launcher's ``[train]`` loss and
    lr, and its checkpoint after three steps holds the JAX loop's
    parameters (within 1e-5 of each leaf's scale plus 1e-2 of three
    steps' move, as in tests/test_torch_train_jax.py) and step.

    One exemption, for every arch: an element whose step-1 gradient is
    below 100 x AdamW's eps on both sides and not zero on both is held to
    AdamW's own bound instead (at most lr = 6e-4 a step, plus 1e-5 of the
    leaf's scale).  There the first normalised update m / (sqrt(v) + eps)
    takes its sign and size from fp32 summation noise (seen: -3.8e-8
    against -8.0e-10 at recurrentgemma's RG-LRU gate, moves of -3.7e-4
    against -4.5e-4).  An element of zero gradient on both sides (an
    embedding row no token of the batch reaches, whisper's encoder) keeps
    the tolerance above.  The share of each leaf exempted is printed."""
    from repro.configs import get_smoke_config
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import train as tlaunch
    cfg = get_smoke_config(arch)
    p0, jlines, jparams, jgrads = _jax_launcher_loop(cfg, 3, 2, 32)
    tp0 = from_jax_params(port_cfg(cfg),
                          jax.tree_util.tree_map(np.asarray, p0), "cpu")
    init = os.path.join(tmp_path, "init.pt")
    ckpt.save(init, {"params": tp0})
    tgrads = _port_step1_grads(cfg, tp0, 2, 32)
    tck = os.path.join(tmp_path, "t.pt")
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--device", "cpu", "--init", init,
                      "--ckpt", tck])
    text = out.getvalue()
    tlines = _train_lines(text)
    assert f"[train] {arch}-smoke:" in text and "on device cpu" in text
    assert f"[train] checkpoint -> {tck}" in text
    assert [s for s, _, _ in tlines] == [s for s, _, _ in jlines] == [1]
    for (_, tl, tr), (_, jl, jr) in zip(tlines, jlines):
        assert abs(tl - jl) <= 1e-3 and tr == pytest.approx(jr, rel=1e-2)
    tstate = torch.load(tck, weights_only=True)
    names = ckpt.leaf_names({"params": jparams})
    exempted = {}
    for name, want, gj, gt, w0 in zip(
            names, jax.tree_util.tree_leaves(jparams),
            jax.tree_util.tree_leaves(jgrads), tgrads,
            jax.tree_util.tree_leaves(p0)):
        want, w0 = np.asarray(want), np.asarray(w0)
        gj, gt = np.abs(np.asarray(gj)), np.abs(gt)
        got = tstate[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        noisy = (np.maximum(gj, gt) < 100 * 1e-8) & ((gj > 0) | (gt > 0))
        if noisy.any():
            exempted[name] = float(noisy.mean())
        close(got[~noisy], want[~noisy], rtol=1e-5,
              atol=1e-5 * scale + 1e-2 * 6e-4 * 3)
        assert (np.abs(got - w0)[noisy] <= 6e-4 * 3 + 1e-5 * scale).all(), name
    print(f"{arch}: share of each leaf exempted {exempted}")
    assert int(tstate["opt/.step"]) == 3


def test_train_small_example_config_matches_jax():
    """``examples/train_small_torch.py``'s ``small_minicpm()`` is the JAX
    example's, field for field."""
    import dataclasses
    import runpy
    root = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
    want = runpy.run_path(os.path.join(root, "train_small.py"))
    got = runpy.run_path(os.path.join(root, "train_small_torch.py"))
    assert dataclasses.asdict(got["small_minicpm"]()) == \
        dataclasses.asdict(want["small_minicpm"]())


def test_launcher_refuses_production_mesh():
    """Without the 256-rank process group torchrun starts, the launcher's
    ``--production-mesh`` refuses and says what it needs (its per-rank
    body runs in tests/test_torch_sharded_train.py)."""
    from repro_torch.launch import train as tlaunch
    with pytest.raises(SystemExit, match="needs a process group of 256"):
        tlaunch.main(["--smoke", "--device", "cpu", "--production-mesh"])
