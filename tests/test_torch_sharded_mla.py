"""Multi-head latent attention and shared experts under a mesh, on the CPU
in fp32 on 4 gloo ranks (``tests/_torch_shard_worker.py``), against the
JAX package:

- the sharded prefill, decode and layered steps of a tiny MLA model
  (``q_lora_rank`` > 0, a dense block 0, routed and shared experts)
  against JAX's unsharded forward, as ``test_torch_sharding.py`` holds the
  GQA runs: logits within 1e-5 of the tensor's scale, expert counts and
  drops equal, the ranks' cache blocks put together equal to JAX's cache.
  The runs take every regime of ``attention._apply_mla_sharded`` (the
  latent split over the sequence and gathered for a prefill, the split
  softmax at decode, a latent whole over ``model``), a call where JAX's
  plan is its "mha" region (s 256), a (1, 4) mesh, both MoE dispatches,
  and the shared experts' partial sums over ``model`` (or, where the guard
  keeps their width whole, no sum);
- two sharded training steps against JAX's own ``make_train_step``
  jitted under ``Mesh(...)`` on 4 forced host devices: each rank's
  gradient shards (the compressions ``w_dq``, ``w_dkv``, ``w_kr``,
  ``q_norm``, ``kv_norm`` and ``moe/shared/*`` among them), moment shards
  and parameter blocks against JAX's whole leaves cut by the specs.
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_mla
from repro.models.config import MLAConfig, MoEConfig
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.sharding import partition as tpart
from test_torch_model import port_cfg
from test_torch_sharded_train import DM, check_train_run, run_train
from test_torch_sharding import StandIn, _flat, check_step_run, run_steps

# routed experts with room for every token (factor E / top_k: the dense
# regimes' group-wise capacity cannot bind), two shared experts
MOE = dict(n_experts=4, top_k=2, expert_d_ff=64, n_shared_experts=2,
           shared_d_ff=32, capacity_factor=2.0)
MLA = dict(kv_lora_rank=32, q_lora_rank=24, qk_rope_dim=8, qk_nope_dim=16,
           v_head_dim=16)
KW = {"moe": MOE, "mla": MLA, "dense_block_ids": (0,)}


def mla_cfg(**moe):
    return tiny_mla(moe=MoEConfig(**{**MOE, **moe}), mla=MLAConfig(**MLA),
                    dense_block_ids=(0,))


STEP_RUNS = [
    # (name, cfg, mesh, b, s, cache_len, dispatch, layered group, P)
    # the latent split over the sequence: gathered at the prefill and the
    # layered row, the split softmax at decode; a2a, gathered and psum MoE
    ("seq-dense", mla_cfg(), (2, 2), 4, 16, 32, "dense", (0, 2), 32),
    ("seq-ragged", mla_cfg(), (2, 2), 4, 16, 32, "ragged", (0, 2), 32),
    # a latent whole over model (33 positions do not divide over 2)
    ("whole", mla_cfg(), (2, 2), 4, 16, 33, "dense", (0, 2), 16),
    # s 256, where JAX's plan is its "mha" region
    ("mha-256", mla_cfg(), (2, 2), 4, 256, 264, "dense", None, None),
    # one head a rank on a 4-way model axis over one data rank; the shared
    # width (2 x 33) does not divide over 4: the guard keeps it whole
    ("tp4", mla_cfg(shared_d_ff=33), (1, 4), 2, 16, 32, "ragged", (0, 2),
     16),
]


def test_step_runs_cover_every_regime():
    """The runs below take, between them, every regime of
    ``_apply_mla_sharded`` (its decision, ``_mla_regime``), JAX's "mha"
    attention region, each MoE regime under both dispatches, and the
    shared experts' partial sums over ``model`` (and a shared width the
    guard keeps whole, whose output is not summed)."""
    seen = set()
    for name, cfg, mesh, b, s, clen, disp, group, p_len in STEP_RUNS:
        m = StandIn(mesh, ("data", "model"))
        tcfg = port_cfg(cfg)
        n = m.shape["model"]
        e = tcfg.moe
        seen.add("shared partial" if n > 1 and (
            e.n_shared_experts * e.shared_d_ff) % n == 0 else "shared whole")
        with tpart.sharding_context(m):
            calls = [(b, s), (b, 1)] + ([(1, p_len)] if group else [])
            for cb, cs in calls:
                seen.add("mla " + tattn._mla_regime(n, True, clen, cs))
                plan = tmoe._sharded_moe_plan(tcfg, cb, cs)
                seen.add(f"moe {plan[-1] if plan else 'gathered'} {disp}")
                if tattn._attn_shard_plan(tcfg, cb, cs, n_kv=tcfg.n_heads,
                                          force_mha=True):
                    seen.add("jax mha region")
    assert {"mla heads", "mla gather", "mla split", "jax mha region",
            "moe a2a dense", "moe a2a ragged", "moe psum dense",
            "moe psum ragged", "moe gathered dense", "moe gathered ragged",
            "shared partial", "shared whole"} <= seen, seen


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("mla_ranks")), STEP_RUNS)


@pytest.mark.parametrize("i", range(len(STEP_RUNS)),
                         ids=[r[0] for r in STEP_RUNS])
def test_sharded_mla_steps_match_jax(step_results, i):
    refs, results = step_results
    check_step_run(STEP_RUNS[i], refs[i], results, i)


# ------------------------------------------------------------- training

# (name, cfg factory, its kwargs, mesh shape, axes, global batch, sequence)
TRAIN_RUNS = [
    # a2a dense MoE (JAX's group-wise capacity), no cache: the rank's heads
    ("mla-a2a", tiny_mla, KW, (2, 2), DM, 4, 32),
    # JAX's "mha" shard_map region (s 256)
    ("mla-mha-256", tiny_mla, KW, (2, 2), DM, 4, 256),
]
# the leaves whose gradient on a rank must be its heads' share (whole on
# every rank, summed over model by ZeRO-1's plan)
SHARED_LEAVES = ("attn/w_dq", "attn/w_dkv", "attn/w_kr", "attn/q_norm",
                 "attn/kv_norm", "moe/shared/w_gate", "moe/shared/w_up",
                 "moe/shared/w_down")


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("mla_train"), TRAIN_RUNS)


@pytest.mark.parametrize("i", range(len(TRAIN_RUNS)),
                         ids=[r[0] for r in TRAIN_RUNS])
def test_sharded_mla_train_step_matches_jax(train_results, i):
    jax_out, results = train_results
    ref = jax_out[i]
    paths = [p for p, _ in _flat(ref["init"])]
    for leaf in SHARED_LEAVES:
        assert any(leaf in p for p in paths), leaf
    mesh = StandIn(TRAIN_RUNS[i][3], DM)
    specs = dict(_flat(tpart.param_specs(ref["init"], mesh)))
    assert all(tpart.spec_axes(specs[p]) == set() for p in paths
               if any(leaf in p for leaf in SHARED_LEAVES[:5])), specs
    assert all("model" in tpart.spec_axes(specs[p]) for p in paths
               if "moe/shared/" in p), specs
    check_train_run(TRAIN_RUNS[i], ref, [r[i] for r in results])
    assert np.isfinite(results[0][i]["steps"][1]["metrics"]["loss"])


def _no_draw(monkeypatch):
    """The launcher's draws raise: a refusal must come before them."""
    from repro_torch.models.model import DecoderModel

    def drawn(*a, **kw):
        raise AssertionError("drew before refusing")
    monkeypatch.setattr(DecoderModel, "init_params", drawn)
    monkeypatch.setattr(DecoderModel, "init_shards", drawn)


@pytest.mark.parametrize("flag", ["--init", "--ckpt"])
def test_production_mesh_whole_checkpoints_refuse_up_front(monkeypatch,
                                                           flag):
    """``--production-mesh``'s two paths that take the whole tree on every
    rank refuse deepseek-v2-236b on an 80 GB card before anything is drawn
    or restored (and so before the first step): ``--init`` restores its
    471.5 GB of parameters, ``--ckpt`` gathers them and the fp32 moments
    (2357.4 GB); each names the ROADMAP.md item of a streamed, sharded
    checkpoint and gives its reckoning."""
    from repro_torch.launch import train as tlaunch
    _no_draw(monkeypatch)
    monkeypatch.setattr(tlaunch, "_free_bytes", lambda dev: int(80e9))
    args = tlaunch.build_parser().parse_args(
        ["--arch", "deepseek-v2-236b", "--device", "cpu", "--steps", "1",
         flag, "/nonexistent/ck.pt"])
    whole = r"471\.5 GB" if flag == "--init" else r"2357\.4 GB"
    with pytest.raises(SystemExit, match=whole + r".*80\.0 GB free; this "
                       r"size needs a streamed, sharded checkpoint "
                       r"\(ROADMAP\.md §1 item 2, step 5\)"):
        tlaunch.train_sharded(args, StandIn((16, 16), DM), device="cpu")


def test_production_mesh_guard_reckons_the_rank(monkeypatch):
    """``train_sharded``'s guard reckons the rank's own bytes at 16x16
    (``rank_bytes``), not the whole model's: deepseek-v2-236b's rank needs
    20.93 GB (4.68 of parameter shards, as much of gradients, 11.54 of
    ZeRO-1's fp32 gradients and moments, a 32 MiB chunk), refused on a
    device with 20 GB free before drawing, admitted on an 80 GB card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as tlaunch
    _no_draw(monkeypatch)
    monkeypatch.setattr(tlaunch, "_free_bytes", lambda dev: int(20e9))
    args = tlaunch.build_parser().parse_args(
        ["--arch", "deepseek-v2-236b", "--device", "cpu", "--steps", "1"])
    mesh = StandIn((16, 16), DM)
    with pytest.raises(SystemExit, match=(
            r"deepseek-v2-236b: a rank needs 20\.93 GB \(parameter shards "
            r"4\.68, their gradients 4\.68, ZeRO-1's fp32 gradients and "
            r"moments 11\.54, one draw chunk 0\.034\); the device has "
            r"20\.0 GB free")):
        tlaunch.train_sharded(args, mesh, device="cpu")
    need = tlaunch.rank_bytes(get_config("deepseek-v2-236b"), mesh)
    tlaunch._admit(get_config("deepseek-v2-236b"), args, need, int(80e9))
