"""Whisper's encoder-decoder in the port (``whisper-base``'s smoke variant:
2 encoder + 2 decoder layers, 64 frames) against the JAX package on the
CPU, in fp32.

* Layers: the sinusoidal and the learned positions, ``encode``,
  ``precompute_cross_kv``, ``encode_cross_kv``, ``apply_cross_attn`` (one
  token and several), the plain non-causal prefill attention against the
  Pallas flash kernel in interpret mode, the forward with ``enc_out`` and
  through the cache, the parameter tree through ``convert.py``: within
  1e-5 of the tensor's scale (tests/test_torch_model.py's tolerance).
* The engine, with seeded frames per request: plans, token streams, TTFTs
  and dispatch counts identical to the JAX engine's under all five
  schedulers, with slot reuse (recompute and swap) and on two pools
  (stream and whole); one cross-K/V install per admission.
* Where the JAX engine departs from its own model the port follows the
  model (ROADMAP §3), and these tests show both sides: a prefix hit across
  different frames (the JAX engine reuses decoder K/V computed under the
  other request's audio; the port roots each request's prefix chains at a
  digest of its frames, and still hits as the JAX engine does where the
  frames are the same), and a request without frames in a used slot (the
  JAX engine attends over the previous occupant's cross K/V; the port
  installs zeros, which is what the JAX engine gives it in a fresh slot).
  Speculative verify is right in both packages.
* Submission checks, the refused draft model, and the launcher."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as parity
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models.model import sinusoidal_positions as jax_sinusoidal
from repro_torch.core.plan import SubmitSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.config import ServeConfig
from repro_torch.models import attention as tattn
from repro_torch.models.model import sinusoidal_positions
from repro_torch.serving.engine import Engine
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from test_engine_equivalence import SCHEDS
from test_torch_model import close, models, t

CFG = jax_smoke("whisper-base")
FRAMES = CFG.encoder.n_frames
PAD = 64            # the reference forward's one length: prompt + new tokens


def frames(rng, scale=1.0):
    return (rng.standard_normal((FRAMES, CFG.d_model)) * scale).astype(
        np.float32)


def _jobs(n: int, seed: int, max_new: int):
    """n (prompt, max_new, frames) triples, frames seeded per request."""
    rng = np.random.default_rng(seed)
    return [(tuple(int(x) for x in rng.integers(1, 500, int(rng.integers(
        4, 20)))), max_new, frames(rng)) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_fns():
    jm, jp, _, _ = models(CFG)
    fwd = jax.jit(lambda toks, enc: jm.forward(jp, toks, enc_out=enc)[0])
    enc = jax.jit(lambda f: jm.encode(jp, f))
    return fwd, enc


def _reference(prompt, frm, max_new: int):
    """JAX's cache-free greedy stream of ``prompt`` under ``frm``: the
    encoder once, then the full forward over the growing sequence (jitted
    at one padded length: the decoder is causal)."""
    fwd, enc = _jax_fns()
    e = enc(jnp.asarray(frm)[None])
    toks = list(prompt)
    for _ in range(max_new):
        padded = np.zeros((1, PAD), np.int32)
        padded[0, :len(toks)] = toks
        logits = fwd(jnp.asarray(padded), e)
        toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
    return toks[len(prompt):]


# ------------------------------------------------------------------ layers

def test_positions_match_jax():
    close(sinusoidal_positions(FRAMES, CFG.d_model, "cpu"),
          jax_sinusoidal(FRAMES, CFG.d_model))
    _, jp, tm, tp = models(CFG)
    assert tuple(tp["embed"]["pos"].shape) == (CFG.max_seq_len, CFG.d_model)
    close(tp["embed"]["pos"], jp["embed"]["pos"])
    jm = models(CFG)[0]
    toks = np.asarray([[3, 9, 27], [5, 1, 2]], np.int32)
    pos = np.asarray([[0, 1, 2], [CFG.max_seq_len - 1, CFG.max_seq_len,
                                  CFG.max_seq_len + 9]], np.int32)
    close(tm.embed(tp, t(toks).long(), positions=t(pos)),
          jm.embed(jp, jnp.asarray(toks), positions=jnp.asarray(pos)))


def test_encode_and_cross_kv_match_jax():
    jm, jp, tm, tp = models(CFG)
    frm = np.stack([frames(np.random.default_rng(i)) for i in range(2)])
    je = jm.encode(jp, jnp.asarray(frm))
    te = tm.encode(tp, t(frm))
    close(te, je)
    jx = jm.precompute_cross_kv(jp, je)
    tx = tm.precompute_cross_kv(tp, t(je))
    assert [[c is None for c in seg] for seg in tx] == \
        [[c is None for c in seg] for seg in jx]
    for jseg, tseg in zip(jx, tx):
        for jc, tc in zip(jseg, tseg):
            close(tc["xk"], jc["xk"])
            close(tc["xv"], jc["xv"])
    bp = jax.tree_util.tree_map(lambda a: a[0],
                                jp["segments"][0]["pattern"][0]["attn"])
    tbp = {k: v[0] for k, v in tp["segments"][0]["pattern"][0]["attn"].items()
           if k != "x_norm"}
    for got, want in zip(tattn.encode_cross_kv(tm.cfg, tbp, t(je)),
                         jattn.encode_cross_kv(CFG, bp, je)):
        close(got, want)


@pytest.mark.parametrize("s", [1, 5])
def test_apply_cross_attn_matches_jax(s):
    """One token takes decode attention at lengths = n_frames, several
    take prefill attention with ``causal=False``: both see every frame."""
    _, jp, tm, tp = models(CFG)
    rng = np.random.default_rng(s)
    bp = jax.tree_util.tree_map(lambda a: a[0],
                                jp["segments"][0]["pattern"][0]["attn"])
    tbp = {k: v[0] for k, v in tp["segments"][0]["pattern"][0]["attn"].items()
           if k != "x_norm"}
    x = rng.standard_normal((2, s, CFG.d_model)).astype(np.float32)
    xk = rng.standard_normal((2, FRAMES, CFG.n_kv_heads, CFG.head_dim_))
    xv = rng.standard_normal((2, FRAMES, CFG.n_kv_heads, CFG.head_dim_))
    xk, xv = xk.astype(np.float32), xv.astype(np.float32)
    got = tattn.apply_cross_attn(tm.cfg, tbp, t(x),
                                 {"xk": t(xk), "xv": t(xv)})
    want = jattn.apply_cross_attn(CFG, bp, jnp.asarray(x),
                                  {"xk": jnp.asarray(xk), "xv": jnp.asarray(xv)})
    close(got, want)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_plain_prefill_attention_non_causal_matches_pallas(h, hkv):
    """``causal=False`` is JAX's ``flash_attention_pallas(causal=False)``
    (interpret mode) at S 128; offset and window are ignored."""
    rng = np.random.default_rng(h + hkv)
    b, s, hd = 2, 128, 32
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    zeros = torch.zeros(b, dtype=torch.int32)
    got = ops.prefill_attention(t(q), t(k), t(v), zeros, causal=False)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    other = ops.prefill_attention(t(q), t(k), t(v),
                                  torch.tensor([3, 70], dtype=torch.int32),
                                  window=16, causal=False)
    assert torch.equal(other, got)


def test_whisper_forward_matches_jax():
    """The forward with ``enc_out``, and the same tokens through the cache
    holding the cross K/V (a prefill, then one decode step)."""
    jm, jp, tm, tp = models(CFG)
    rng = np.random.default_rng(7)
    je = jm.encode(jp, jnp.asarray(np.stack([frames(rng), frames(rng)])))
    toks = rng.integers(1, 500, (2, 12)).astype(np.int32)
    jl, _, _ = jm.forward(jp, jnp.asarray(toks), enc_out=je)
    tl, _, _ = tm.forward(tp, t(toks).long(), enc_out=t(je))
    close(tl, jl)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    for s, (jseg, tseg) in enumerate(zip(jm.precompute_cross_kv(jp, je),
                                         tm.precompute_cross_kv(tp, t(je)))):
        for p, (jx, tx) in enumerate(zip(jseg, tseg)):
            jc[s][p] = dict(jc[s][p], xk=jx["xk"], xv=jx["xv"])
            tc[s][p]["xk"].copy_(tx["xk"])
            tc[s][p]["xv"].copy_(tx["xv"])
    jl2, jc, _ = jm.forward(jp, jnp.asarray(toks), cache=jc)
    tl2, tc, _ = tm.forward(tp, t(toks).long(), cache=tc)
    close(tl2, jl2)
    nxt = np.asarray([[5], [7]], np.int32)
    off = np.asarray([12, 12], np.int32)
    jl3, _, _ = jm.forward(jp, jnp.asarray(nxt), cache=jc,
                           offset=jnp.asarray(off))
    tl3, _, _ = tm.forward(tp, t(nxt).long(), cache=tc, offset=t(off))
    close(tl3, jl3)


def test_parameter_tree_through_convert():
    """The JAX tree comes across whole: the stacked decoder segments with
    their cross-attention leaves, the encoder's unstacked blocks, the
    learned position table."""
    _, jp, tm, tp = models(CFG)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (_, a), (_, b) in zip(tleaves, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(tp["encoder"]["blocks"]) == CFG.encoder.n_layers
    assert "x_q" in tp["segments"][0]["pattern"][0]["attn"]
    # the port's own init draws the same tree
    own = tm.init_params()
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(tp)


# ------------------------------------------------------------------ engine

KEYS = ["plans", "outputs", "ttft", "token_times", "iterations",
        "n_dispatches", "n_preempted", "n_swapped_out", "n_swapped_in"]


@pytest.mark.parametrize("sched", SCHEDS)
def test_engine_matches_jax_engine(sched):
    jobs = _jobs(3, 0, 6)
    want = parity.run("jax", CFG, sched, jobs=jobs)
    got = parity.run("torch", CFG, sched, jobs=jobs)
    parity.assert_same(got, want, KEYS)


@pytest.mark.parametrize("mode", ["reuse", "recompute", "swap"])
def test_slot_reuse_and_preemption_match_jax(mode):
    """Six requests on two slots; then an oversubscribed page pool under
    recompute (a victim re-encodes at re-admission) and swap preemption
    (the cross K/V go to host memory and come back whole)."""
    jobs = _jobs(6 if mode == "reuse" else 8, 3, 8)
    kw = (dict(sched_kw=dict(n_slots=2), n_slots=2) if mode == "reuse" else
          dict(pages=12, page_size=4, decode_reserve=1,
               preemption_mode=mode))
    want = parity.run("jax", CFG, "layered", jobs=jobs, **kw)
    got = parity.run("torch", CFG, "layered", jobs=jobs, **kw)
    parity.assert_same(got, want, KEYS)
    if mode == "recompute":
        assert got["n_preempted"] > 0
    if mode == "swap":
        assert got["n_swapped_out"] == got["n_swapped_in"] > 0
    for rid, (prompt, n, frm) in enumerate(jobs[:2]):
        assert got["outputs"][rid] == _reference(prompt, frm, n)


def test_cross_kv_installed_once_per_admission():
    jobs = _jobs(8, 3, 8)
    eng = parity.build("torch", CFG, "layered", pages=12, page_size=4,
                       decode_reserve=1)
    parity.submit(eng, jobs)
    runtime = ServingRuntime(EngineExecutor(eng), clock="iteration",
                             record_plans=True)
    runtime.run((), max_iterations=1000)
    assert eng.n_preempted > 0
    assert eng.n_cross_installs == sum(len(p.admitted_ids)
                                       for p in runtime.plans) > len(jobs)
    assert not eng.enc_frames                 # dropped as requests finish


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "whole"])
def test_two_pools_match_jax(streaming):
    """Two pools: the cross K/V move whole with each block's chunk (or the
    whole-prompt row) and the frames with the request."""
    jobs = _jobs(6, 7, 6)
    kw = dict(n_slots=2, sched_kw=dict(n_slots=2), jobs=jobs)
    want = parity.run_disagg("jax", CFG, [], streaming=streaming, **kw)
    got = parity.run_disagg("torch", CFG, [], streaming=streaming, **kw)
    for key in ("plans", "outputs", "per_request", "run", "handoffs"):
        assert got[key] == want[key], key
    assert got["handoffs"][0] == len(jobs)
    cross = 2 * CFG.n_layers * FRAMES * CFG.n_kv_heads * CFG.head_dim_ * 4
    for _, n_tok, _, nbytes in got["migrations"]:
        assert nbytes == n_tok * CFG.kv_bytes_per_token(4) + cross


# ------------------------------------------------ faults of the reference

def test_prefix_hit_needs_the_same_frames():
    """Two requests share a 40-token prefix, one slot.  Under different
    frames the JAX engine hits and reuses decoder K/V computed under the
    other request's frames (request 1 parts from the model at its 6th
    token); the port misses and gives the model's stream.  Under the same
    frames both engines hit alike."""
    rng = np.random.default_rng(0)
    prefix = [int(x) for x in rng.integers(1, 500, 40)]
    jobs = [(tuple(prefix + [int(x) for x in rng.integers(1, 500, 5)]), 6,
             frames(rng)) for _ in range(2)]
    kw = dict(sched_kw=dict(n_slots=1), n_slots=1)
    want = parity.run("jax", CFG, "layered", jobs=jobs, **kw)
    got = parity.run("torch", CFG, "layered", jobs=jobs, **kw)
    ref = [_reference(p, f, n) for p, n, f in jobs]
    assert want["n_prefix_hits"] == 1 and got["n_prefix_hits"] == 0
    assert want["outputs"][1] == [86, 86, 86, 86, 74, 74]
    assert ref[1] == [86, 86, 86, 86, 74, 86]
    assert [got["outputs"][0], got["outputs"][1]] == ref
    same = [(p, n, jobs[0][2]) for p, n, _ in jobs]
    want = parity.run("jax", CFG, "layered", jobs=same, **kw)
    got = parity.run("torch", CFG, "layered", jobs=same, **kw)
    assert got["n_prefix_hits"] == 1
    parity.assert_same(got, want, KEYS + ["n_prefix_tokens",
                                          "n_prefix_restores"])


def test_request_without_frames_sees_zero_cross_kv():
    """A request without frames after one with frames, one slot: the JAX
    engine attends over the first request's cross K/V; the port installs
    zeros, as the JAX engine has them in a fresh slot."""
    rng = np.random.default_rng(0)
    a = (tuple(int(x) for x in rng.integers(1, 500, 12)), 6, frames(rng))
    b = (tuple(int(x) for x in rng.integers(1, 500, 9)), 6)
    kw = dict(sched_kw=dict(n_slots=1), n_slots=1)
    want = parity.run("jax", CFG, "layered", jobs=[a, b], **kw)
    got = parity.run("torch", CFG, "layered", jobs=[a, b], **kw)
    alone = parity.run("jax", CFG, "layered", jobs=[b], **kw)
    assert got["plans"] == want["plans"]
    assert got["outputs"][0] == want["outputs"][0]
    assert want["outputs"][1] != alone["outputs"][0]
    assert got["outputs"][1] == alone["outputs"][0]
    assert parity.run("torch", CFG, "layered", jobs=[b],
                      **kw)["outputs"] == alone["outputs"]


def test_speculation_matches_jax_and_spec_off():
    """n-gram speculative verify reads the cross K/V and writes only KV
    rows past the committed offset: both engines give spec off's
    streams, with the same proposals and acceptances."""
    rng = np.random.default_rng(0)
    jobs = [((5, 3, 7) * 6, 10, frames(rng)),
            (tuple(range(1, 20)), 10, frames(rng))]
    want = parity.run("jax", CFG, "layered", jobs=jobs, spec_mode="ngram")
    got = parity.run("torch", CFG, "layered", jobs=jobs, spec_mode="ngram")
    parity.assert_same(got, want, ["plans", "outputs", "ttft",
                                   "n_spec_proposed", "n_spec_accepted",
                                   "spec_log"])
    assert got["n_spec_proposed"] > 0 and got["n_spec_accepted"] > 0
    off = parity.run("torch", CFG, "layered", jobs=jobs)
    assert got["outputs"] == off["outputs"]


# ---------------------------------------------------- refusals, launcher

def test_submission_and_draft_refusals():
    _, _, tm, tp = models(CFG)
    eng = Engine(tm, tp, "layered", n_slots=2, max_len=64)
    with pytest.raises(ValueError, match="n_frames"):
        eng.submit_spec(SubmitSpec(max_new_tokens=2, prompt_tokens=[1, 2],
                                   enc_frames=np.zeros((FRAMES + 1,
                                                        CFG.d_model))))
    assert not eng.requests
    with pytest.raises(ValueError, match="encoder"):
        Engine(tm, tp, "layered", n_slots=2, max_len=64, spec_mode="draft",
               draft_model=tm, draft_params=tp)
    with pytest.raises(ValueError, match="encoder"):
        ServeConfig(arch="phi4-mini-3.8b", spec="draft",
                    draft_config="whisper-base").validate()
    a = ServeConfig(arch="whisper-base", spec="ngram").validate()
    assert a.prefix_cache_on()


def test_launcher_serves_whisper(capsys):
    """The closed loop gives every request zero frames (the JAX
    launcher's); one cross-K/V install per admission; two pools too."""
    serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "whisper-base-smoke x layered" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] encoder"))
    assert "over 64 frames: 3 cross-K/V installs" in line
    serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-len", "64",
                "--disagg"])
    out = capsys.readouterr().out
    assert "[serve-disagg] whisper-base-smoke" in out
    assert "decode-pool prefill slices 0" in out
