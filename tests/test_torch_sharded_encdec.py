"""Whisper's encoder-decoder under a mesh, on the CPU in fp32 on 4 gloo
ranks (``tests/_torch_shard_worker.py``), against the JAX package; and the
dry-run of the archs this slice shards:

- the sharded prefill (the frames through the encoder, as JAX's prefill
  step), decode over the installed cross K/V and layered steps of a tiny
  whisper against JAX's unsharded forward, as ``test_torch_sharding.py``
  holds the GQA runs: logits within 1e-5 of the tensor's scale, and every
  cache leaf, the self-attention ``k``/``v`` and the cross ``xk``/``xv``,
  put together from the ranks' blocks equal to JAX's.  The runs take the
  cross K/V heads split over ``model`` (one kv head a rank's pair on
  (2, 2)) and whole (6 heads on a 4-way axis: a rank's ``x_q`` columns
  cover a head and a half, so it widens to whole heads), an encoder whose
  residual is split over the sequence and one whose residual is whole,
  and the decoder's learned positions over a kv-head-split and a
  sequence-split self-attention cache;
- two sharded training steps (seeded ``enc_out``: cross-attention passes
  gradients) against JAX's own ``make_train_step`` under ``Mesh(...)``;
- ``python -m repro_torch.launch.dryrun`` on recurrentgemma-9b at
  ``long_500k`` (16x16) and whisper-base at ``prefill_32k`` (2x16x16):
  parameter bytes a device equal the local shards', ``model_flops`` equals
  JAX's estimate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models.config import EncoderConfig
from repro_torch.models import attention as tattn
from repro_torch.sharding import partition as tpart
from test_torch_sharded_train import DM, check_train_run, run_train
from test_torch_sharding import (StandIn, _check_dryrun, _flat,
                                 check_step_run, run_steps)


def tiny_whisper(**kw):
    """whisper-base's smoke variant (2 + 2 layers, hd 32) at 30 frames:
    they divide over a 2-way axis, where ``cache_specs`` splits the cross
    cache's kv heads first, and not over a 4-way one, so the frames are
    never split (as whisper-base's 1500 over 8 or 16)."""
    base = jax_smoke("whisper-base")
    return dataclasses.replace(
        base, encoder=EncoderConfig(n_layers=2, n_frames=30),
        **kw).validate()


# 6 heads of 32 on a 4-way model axis: kv heads whole (6 % 4), x_q columns
# cut heads; 30 frames do not divide over 4 (the encoder's residual whole)
SIX = dict(n_heads=6, n_kv_heads=6, d_model=192, d_ff=384)

STEP_RUNS = [
    # (name, cfg, mesh, b, s, cache_len, dispatch, layered group, P)
    # cross and self K/V heads split over model; the encoder's residual
    # split over the sequence (30 frames over 2)
    ("whisper-heads", tiny_whisper(), (2, 2), 4, 16, 32, "dense", (0, 2),
     16),
    # cross K/V whole, self-attention cache split over the sequence (the
    # split softmax with learned positions); the encoder's residual whole
    ("whisper-whole-tp4", tiny_whisper(**SIX), (1, 4), 2, 16, 32, "dense",
     (0, 2), 16),
]


def test_step_runs_cover_every_regime():
    """The runs take the cross K/V split and whole, a rank's query columns
    cutting a head, the encoder residual split and whole, and the self-
    attention cache kv-head-split and sequence-split."""
    seen = set()
    for name, cfg, mesh, b, s, clen, _, group, p_len in STEP_RUNS:
        m = StandIn(mesh, DM)
        n = m.shape["model"]
        rules = tpart.default_rules(m)
        t = cfg.encoder.n_frames
        assert t % n or cfg.n_kv_heads % n == 0   # frames never split
        seen.add("cross heads" if cfg.n_kv_heads % n == 0 else "cross whole")
        if (cfg.n_heads * cfg.head_dim // n) % cfg.head_dim:
            seen.add("q columns cut a head")
            sets = tattn._head_sets(_port(cfg), n, None, "rep",
                                    [tuple(range(r * 48, (r + 1) * 48))
                                     for r in range(n)])
            # widened to whole heads, over the kv heads they read
            assert all(len(q) == len(kv) <= 2 for q, kv in sets), sets
        seen.add("encoder seq split" if t % n == 0 else "encoder whole")
        seen.add("self " + tpart.kv_cache_mode(m, rules, cfg.n_kv_heads,
                                               clen))
    assert {"cross heads", "cross whole", "q columns cut a head",
            "encoder seq split", "encoder whole", "self heads",
            "self seq"} <= seen, seen


def _port(cfg):
    from test_torch_model import port_cfg
    return port_cfg(cfg)


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("encdec_ranks")),
                     STEP_RUNS)


@pytest.mark.parametrize("i", range(len(STEP_RUNS)),
                         ids=[r[0] for r in STEP_RUNS])
def test_sharded_whisper_steps_match_jax(step_results, i):
    refs, results = step_results
    leaves = {p.rsplit("/", 1)[-1] for p, _ in _flat(refs[i]["cache"])}
    assert {"k", "v", "xk", "xv"} <= leaves, leaves
    # the cross K/V are the installed encoder projections, not zeros
    xk = [a for p, a in _flat(refs[i]["cache"]) if p.endswith("xk")]
    assert all(np.abs(np.asarray(a)).max() > 0 for a in xk)
    check_step_run(STEP_RUNS[i], refs[i], results, i)


# ------------------------------------------------------------- training

TRAIN_RUNS = [
    # (name, cfg factory, its kwargs, mesh shape, axes, global batch, seq)
    ("whisper", tiny_whisper, {}, (2, 2), DM, 4, 32),
    ("whisper-six-tp4", tiny_whisper, SIX, (1, 4), DM, 4, 32),
]


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("encdec_train"), TRAIN_RUNS)


@pytest.mark.parametrize("i", range(len(TRAIN_RUNS)),
                         ids=[r[0] for r in TRAIN_RUNS])
def test_sharded_whisper_train_step_matches_jax(train_results, i):
    jax_out, results = train_results
    ref_ = jax_out[i]
    # cross-attention's weights get gradients (seeded enc_out)
    grads = dict(zip([p for p, _ in _flat(ref_["init"])],
                     ref_["steps"][0]["grads"]))
    for leaf in ("attn/x_q", "attn/x_k", "attn/x_v", "attn/x_o"):
        assert any(leaf in p and np.abs(g).max() > 0
                   for p, g in grads.items()), leaf
    check_train_run(TRAIN_RUNS[i], ref_, [r[i] for r in results])
    assert np.isfinite(results[0][i]["steps"][1]["metrics"]["loss"])


# ------------------------------------------------------------- dry-run


@pytest.mark.parametrize("arch,shape,mesh_name", [
    ("recurrentgemma-9b", "long_500k", "16x16"),
    ("whisper-base", "prefill_32k", "2x16x16")])
def test_dryrun_subprocess_new_archs(tmp_path, arch, shape, mesh_name):
    """recurrentgemma-9b's 524k-position decode (the split softmax under
    its 2048-key window over a sequence-split cache) and whisper-base's
    prefill with 1500 frames through the encoder: exit 0, parameter bytes
    a device the local shards', model_flops JAX's estimate."""
    _check_dryrun(tmp_path, arch, mesh_name, shape)
