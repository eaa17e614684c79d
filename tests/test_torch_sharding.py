"""The port's multi-device code against the JAX package's, on the CPU:

- ``param_specs``, ``cache_specs`` and ``moment_specs`` equal JAX's leaf
  by leaf for all 12 configs on both production meshes (JAX's functions
  read only ``mesh.shape`` and ``mesh.axis_names``: a stand-in object, no
  forced host devices);
- the MoE and attention plan decisions equal JAX's over a grid of
  (config, b, s, mesh shape);
- the sharded prefill, decode and layered steps, on gloo CPU ranks in
  fp32 with JAX's parameters through ``shard_params``, against JAX's
  unsharded forward within 1e-5 of the tensor's scale: logits, the
  gathered cache, expert counts and drops equal.  Together the runs cover
  the MoE's a2a and psum regimes (dense and ragged each) and its gathered
  (JAX: None) regime, with binding capacity too, the "gqa" attention
  region, and kv-head-split, sequence-split and whole caches;
- the a2a dense regime with binding capacity against JAX's own
  ``shard_map`` path (4 forced host devices, in a subprocess);
- the dry-run as a subprocess at (2, 16, 16);
- K3's log-sum-exp in its plain version, and a two-slice merge equal to
  one unsplit call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.launch import analysis as janalysis
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch.steps import make_layered_step_fn as jax_layered
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.config import MoEConfig
from repro.models.model import DecoderModel as JaxModel
from repro.sharding import partition as jpart
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.model import DecoderModel as TorchModel
from repro_torch.sharding import partition as tpart
from test_torch_model import close, port_cfg, port_tree

import _torch_shard_worker as worker

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What JAX's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.coords = {a: 0 for a in axes}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _is_spec(x) -> bool:
    """A spec: a tuple of None, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _jax_specs(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {jpart._path_str(p): tuple(tuple(e) if isinstance(e, list) else e
                                      for e in s) for p, s in leaves}


def _port_shapes(cfg, b, clen):
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = TorchModel(cfg, device="cpu")
    with FakeTensorMode():
        return (model.init_params(torch.Generator().manual_seed(0)),
                model.init_cache(b, clen))


# ------------------------------------------------------------- specs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jax_list_configs())
def test_specs_equal_jax(arch, mesh_name):
    """param/cache/moment specs leaf by leaf, at decode_32k's cache and
    at long_500k's (one row: the batch stays whole)."""
    shape, axes = MESHES[mesh_name]
    mesh = StandIn(shape, axes)
    jcfg = jax_get_config(arch)
    jm = JaxModel(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tcfg = get_config(arch)
    want = _jax_specs(jpart.param_specs(jp, mesh))
    want_m = _jax_specs(jpart.moment_specs(jp, mesh))
    for b, clen in ((128, 32768 + jcfg.vision.n_patches), (1, 1024)):
        jc = jax.eval_shape(lambda: jm.init_cache(b, clen))
        tp, tc = _port_shapes(tcfg, b, clen)
        got = dict(_flat(tpart.param_specs(tp, mesh)))
        assert got == want
        assert dict(_flat(tpart.moment_specs(tp, mesh))) == want_m
        got_c = dict(_flat(tpart.cache_specs(tc, mesh, b)))
        assert got_c == _jax_specs(jpart.cache_specs(jc, mesh, b))


def test_hints_cut_the_ranks_block():
    """``shard_hint`` and ``shard_seq_hint`` keep JAX's names: no-ops
    outside a context; inside one, this rank's block of a tensor it holds
    whole (a dim its axes do not divide stays whole)."""
    x = torch.arange(4 * 8 * 2.).reshape(4, 8, 2)
    assert tpart.shard_hint(x, "batch", None, None) is x
    assert tpart.shard_seq_hint(x) is x
    mesh = StandIn((2, 4), ("data", "model"))
    mesh.coords = {"data": 1, "model": 3}
    with tpart.sharding_context(mesh):
        assert torch.equal(tpart.shard_hint(x, "batch", None, None), x[2:])
        assert torch.equal(tpart.shard_hint(x, None, "tp", None), x[:, 6:])
        assert torch.equal(tpart.shard_hint(x[:3], "batch"), x[:3])
        assert torch.equal(tpart.shard_seq_hint(x, 4), x[:, 6:])
        assert torch.equal(tpart.shard_seq_hint(x[:, :6], 4), x[:, :6])


PLAN_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 8), ("data", "model")), ((2, 2), ("data", "model")),
               ((4, 1), ("data", "model"))]


@pytest.mark.parametrize("mesh_shape", PLAN_MESHES,
                         ids=["x".join(map(str, m[0])) for m in PLAN_MESHES])
def test_plan_decisions_equal_jax(mesh_shape):
    mesh = StandIn(*mesh_shape)
    n = 0
    for arch in jax_list_configs():
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        for b in (1, 2, 4, 32, 128):
            for s in (1, 16, 256, 4096, 32768):
                with jpart.sharding_context(mesh):
                    jm = jmoe._sharded_moe_plan(jcfg, b, s)
                    ja = jattn._attn_shard_plan(jcfg, b, s)
                with tpart.sharding_context(mesh):
                    tm = tmoe._sharded_moe_plan(tcfg, b, s)
                    ta = tattn._attn_shard_plan(tcfg, b, s)
                assert (jm[1:] if jm else None) == tm, (arch, b, s)
                assert (ja[1:] if ja else None) == ta, (arch, b, s)
                n += (tm is not None) + (ta is not None)
    if mesh.shape.get("model", 1) > 1:
        assert n > 0


# ------------------------------------------------------------- steps


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_run(cfg, jp, b, s, clen, dispatch, group=None, p_len=None,
             seed=0):
    """JAX's unsharded forward through prefill, decode and (with
    ``group``) its layered step; returns the references and the inputs
    the ranks replay."""
    jm = JaxModel(cfg)
    fwd = jax.jit(lambda p_, t_, c_, o_, v_, e_=None: jm.forward(
        p_, t_, cache=c_, offset=o_, valid=v_, enc_out=e_,
        moe_dispatch=dispatch))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    enc = None
    if cfg.encoder.enabled:
        # whisper: the prefill encodes seeded frames (JAX's prefill step),
        # then the cross K/V are installed for the decodes
        frames = rng.normal(size=(b, cfg.encoder.n_frames, cfg.d_model)
                            ).astype(np.float32)
        enc = jax.jit(jm.encode)(jp, frames)
    lg, cache, aux = fwd(jp, toks, jm.init_cache(b, clen),
                         np.zeros((b,), np.int32), None, enc)
    if enc is not None:
        kv = jm.precompute_cross_kv(jp, enc)
        cache = [[c if kv[si][pi] is None else dict(c, **kv[si][pi])
                  for pi, c in enumerate(seg)]
                 for si, seg in enumerate(cache)]
    refs = {"prefill": (lg[:, -1], aux["expert_counts"], aux["dropped"])}
    toks2 = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
    off2 = np.full((b,), s, np.int32)
    lg, cache, aux = fwd(jp, toks2, cache, off2, None)
    refs["decode"] = (lg[:, -1], aux["expert_counts"], aux["dropped"])
    inputs = {"tokens": toks, "tokens2": toks2, "offsets2": off2}
    if enc is not None:
        inputs["frames"] = frames
    if group is not None:
        toks3 = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(
            np.int32)
        off3 = off2 + 1
        valid3 = np.ones((b,), bool)
        valid3[0] = False
        hidden = rng.normal(size=(1, p_len, cfg.d_model)).astype(np.float32)
        _, _, aux3 = fwd(jp, toks3, cache, off3, valid3[:, None])
        row = jax.tree_util.tree_map(lambda a: a[:, :1], cache)
        _, _, auxes = jm.run_blocks(
            jp, hidden, group[0], group[1] - group[0],
            positions=jnp.arange(p_len, dtype=jnp.int32)[None],
            offset=jnp.zeros((1,), jnp.int32), cache=row)
        logits3, h_out, cache = jax.jit(jax_layered(
            jm, group=group, prefill_len=p_len))(jp, cache, {
                "tokens": toks3, "offsets": off3, "valid": valid3,
                "hidden": hidden})
        refs["layered"] = (logits3, h_out, aux3["expert_counts"],
                           jnp.stack([a["expert_counts"] for a in auxes]))
        inputs.update(tokens3=toks3, offsets3=off3, valid3=valid3,
                      hidden=hidden)
    refs["cache"] = cache
    return refs, {k: _t(v) for k, v in inputs.items()}


def _gather_cache(results, i, mesh_shape, axes, cache_ref, b):
    """The ranks' cache blocks of run ``i`` put together; ranks that hold
    the same block of a leaf (a replica) must hold the same values."""
    mesh = StandIn(mesh_shape, axes)
    specs = tpart.cache_specs(cache_ref, mesh, b)
    whole = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   cache_ref)
    placed = {}

    def place(path, dst, spec, src, coords):
        sl = tpart.local_slices(dst.shape, spec, mesh, coords)
        key = (path, repr(sl))
        if key in placed:
            close(src, placed[key])
        placed[key] = src.numpy()
        dst[sl] = src.numpy()
    for res in results:
        r = res[i]
        flat_w = list(_flat(whole))
        flat_s = dict(_flat(specs))
        flat_l = dict(_flat(r["cache"]))
        for path, dst in flat_w:
            place(path, dst, flat_s[path], flat_l[path], r["coords"])
    return whole


# Dense dispatch under a plan has group-wise capacity, the unsharded
# forward one capacity over all tokens: the step runs give the experts
# room for every token (factor E / top_k), so the dense regimes are held
# to the unsharded forward; binding capacity is held against JAX's own
# shard_map region below.
ROOMY = MoEConfig(n_experts=4, top_k=2, expert_d_ff=64, capacity_factor=2.0)
# the gathered (JAX: None) regime ranks the whole call's tokens within
# each expert, so its capacity binds as the unsharded call's does (factor
# 0.5 < E / top_k)
TIGHT = MoEConfig(n_experts=4, top_k=2, expert_d_ff=64, capacity_factor=0.5)

STEP_RUNS = [
    # (name, cfg, mesh, b, s, cache_len, dispatch, layered group, P)
    # a2a dense prefill, gathered decode, psum layered; kv-head-split cache
    ("moe-kvheads", tiny_moe(moe=ROOMY), (2, 2), 4, 16, 32, "dense", (0, 1), 32),
    # a2a ragged prefill, ragged gathered decode, psum ragged layered row
    ("moe-ragged", tiny_moe(moe=ROOMY), (2, 2), 4, 16, 32, "ragged", (0, 1),
     32),
    # the gathered regime at prefill (16 tokens) and decode with binding
    # capacity: drops and counts are the unsharded call's
    ("moe-binding", tiny_moe(moe=TIGHT), (2, 2), 4, 4, 8, "dense", None,
     None),
    # sequence-split cache: the split softmax at prefill (K2) and decode
    # (K3), and the layered row's prefill at B = 1
    ("moe-seq", tiny_moe(n_kv_heads=1, moe=ROOMY), (2, 2), 4, 16, 32, "dense", (0, 2),
     32),
    # the "gqa" region at s 256 over a sequence-split cache
    ("moe-gqa", tiny_moe(n_kv_heads=1, moe=ROOMY), (2, 2), 4, 256, 264, "dense",
     None, None),
    # dense MLP, kv-head-split cache, vocab-parallel embedding
    ("dense-kvheads", tiny_dense(), (2, 2), 4, 16, 32, "dense", (1, 2),
     32),
    # whole cache (33 rows over 2), vocab kept whole by the guard (255)
    ("dense-whole", tiny_dense(n_kv_heads=1, vocab_size=255), (2, 2), 2, 8,
     33, "dense", None, None),
    # a 4-way model axis over 1 data rank: heads cut by columns
    ("dense-tp4", tiny_dense(n_heads=6, n_kv_heads=2, d_model=48), (1, 4),
     2, 16, 32, "dense", (0, 2), 16),
    # the same heads over a whole cache (33 rows over 4): a rank's w_o
    # rows cover at most Hkv heads, cut between ranks, and every rank
    # writes and reads every kv head
    ("dense-tp4-whole", tiny_dense(n_heads=6, n_kv_heads=2, d_model=48),
     (1, 4), 2, 16, 33, "dense", (0, 2), 16),
]


def test_step_runs_cover_every_regime():
    """The step runs below take, between them, every regime of this slice:
    the MoE's a2a, psum and gathered (JAX: None) regimes, the "gqa"
    attention region, the split softmax, and kv-head-split, sequence-split
    and whole caches (one where a rank's heads are at most Hkv)."""
    seen = set()
    for name, cfg, mesh, b, s, clen, disp, group, p_len in STEP_RUNS:
        m = StandIn(mesh, ("data", "model"))
        tcfg = port_cfg(cfg)
        with tpart.sharding_context(m):
            rules = tpart.default_rules(m)
            mode = tpart.kv_cache_mode(m, rules, cfg.n_kv_heads, clen)
            seen.add(f"cache {mode}")
            hd, cols = cfg.head_dim_, cfg.n_heads * cfg.head_dim_ // mesh[1]
            if mode == "rep" and any(
                    ((r + 1) * cols - 1) // hd + 1 - r * cols // hd
                    <= cfg.n_kv_heads for r in range(mesh[1])):
                seen.add("cache rep, a rank's heads within Hkv")
            calls = [(b, s), (b, 1)] + ([(1, p_len)] if group else [])
            for cb, cs in calls:
                plan = tmoe._sharded_moe_plan(tcfg, cb, cs)
                if tcfg.moe.enabled:
                    seen.add(f"moe {plan[-1] if plan else 'gathered'} "
                             f"{disp}")
                attn = tattn._attn_shard_plan(tcfg, cb, cs)
                seen.add("attn gqa" if attn else
                         "attn split softmax" if mode == "seq" else
                         "attn heads")
    assert {"moe a2a dense", "moe a2a ragged", "moe psum dense",
            "moe psum ragged", "moe gathered dense", "moe gathered ragged",
            "attn gqa",
            "attn split softmax", "attn heads", "cache heads", "cache seq",
            "cache rep", "cache rep, a rank's heads within Hkv"} <= seen, seen


def run_steps(tmp: str, step_runs):
    """JAX's unsharded references of ``step_runs`` (``STEP_RUNS``' rows)
    and the port's sharded steps on 4 gloo ranks: (references, the
    ranks' results)."""
    runs, refs = [], []
    for name, cfg, mesh, b, s, clen, disp, group, p_len in step_runs:
        jp = jax.jit(JaxModel(cfg).init)(jax.random.PRNGKey(0))
        r, inputs = _jax_run(cfg, jp, b, s, clen, disp, group, p_len)
        path = os.path.join(tmp, f"{name}.pt")
        torch.save(port_tree(cfg, jp), path)
        runs.append({"kind": "steps", "mesh": mesh,
                     "axes": ("data", "model"), "cfg": port_cfg(cfg),
                     "params": path, "b": b, "s": s, "cache_len": clen,
                     "dispatch": disp, "group": group, "inputs": inputs})
        refs.append(r)
    return refs, worker.run_ranks(4, tmp, {"runs": runs})


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("ranks")), STEP_RUNS)


def _rows_of(res, key, idx, mesh, b):
    """Rank blocks of a (B, ...) output put together (ranks on one batch
    block hold the same rows)."""
    b_n = mesh[0]
    parts = {}
    for r in res:
        parts.setdefault(r["coords"]["data"], r[key][idx])
    if b % b_n:
        return parts[0]
    return torch.cat([parts[i] for i in range(b_n)])


@pytest.mark.parametrize("i", range(len(STEP_RUNS)),
                         ids=[r[0] for r in STEP_RUNS])
def test_sharded_steps_match_jax(step_results, i):
    refs, results = step_results
    check_step_run(STEP_RUNS[i], refs[i], results, i)


def check_step_run(run, ref_, results, i):
    """Run ``i`` of the ranks' ``results`` against JAX's unsharded
    forward (``ref_``): the logits, expert counts and drops of every step,
    the layered row's output, and the ranks' cache blocks put together."""
    name, cfg, mesh, b, s, clen, disp, group, p_len = run
    res = [r[i] for r in results]
    for key in ("prefill", "decode"):
        close(_rows_of(res, key, 0, mesh, b), ref_[key][0])
        for r in res:
            np.testing.assert_array_equal(r[key][1].numpy(),
                                          np.asarray(ref_[key][1]))
            assert int(r[key][2]) == int(ref_[key][2])
        if cfg.moe.enabled and (cfg.moe.capacity_factor
                                < cfg.moe.n_experts / cfg.moe.top_k):
            assert int(ref_[key][2]) > 0, "capacity does not bind"
    if group is not None:
        close(_rows_of(res, "layered", 0, mesh, b), ref_["layered"][0])
        h_parts = {}
        for r in res:
            h_parts.setdefault(r["coords"]["model"], r["layered"][1])
        h = torch.cat([h_parts[k] for k in sorted(h_parts)], dim=1) \
            if p_len % mesh[1] == 0 and mesh[1] > 1 else h_parts[0]
        close(h, ref_["layered"][1])
        for r in res:
            np.testing.assert_array_equal(r["layered"][2].numpy(),
                                          np.asarray(ref_["layered"][2]))
            np.testing.assert_array_equal(r["layered"][3].numpy(),
                                          np.asarray(ref_["layered"][3]))
    whole = _gather_cache(results, i, mesh, ("data", "model"), ref_["cache"],
                          b)
    for (pa, got), (_, want) in zip(_flat(whole), _flat(
            jax.tree_util.tree_map(np.asarray, ref_["cache"]))):
        close(got, want)


# ------------------------------------------------- a2a dense vs shard_map

_JAX_A2A = r"""
import sys, os
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
from jax.sharding import Mesh
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from conftest import tiny_moe
from repro.models import moe
from repro.models.config import MoEConfig
from repro.sharding.partition import sharding_context
cfg = tiny_moe(moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                             capacity_factor=0.5))
p = moe.init_moe(cfg, jax.random.PRNGKey(0))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
with sharding_context(mesh):
    assert moe._sharded_moe_plan(cfg, 4, 16)[-1] == "a2a"
    y, aux = jax.jit(lambda p_, x_: moe.apply_moe(cfg, p_, x_))(p, x)
np.savez(sys.argv[1], x=np.asarray(x), y=np.asarray(y),
         counts=np.asarray(aux["expert_counts"]),
         dropped=np.asarray(aux["dropped"]),
         **{k: np.asarray(v) for k, v in p.items()})
print("JAX-A2A-OK")
"""


def test_a2a_dense_binding_capacity_matches_jax_shard_map(tmp_path):
    """Per-group capacity binds (factor 0.5): the port's a2a dense regime
    drops what JAX's ``shard_map`` region drops, as each of its groups is
    JAX's (the rank's rows x sequence block regrouped into contiguous
    token blocks; two rows a rank here)."""
    out = tmp_path / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _JAX_A2A, str(out)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    z = np.load(out)
    assert int(z["dropped"]) > 0, "capacity must bind"
    cfg = tiny_moe(moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                                 capacity_factor=0.5))
    p = {k: torch.from_numpy(z[k]) for k in ("router", "w_gate", "w_up",
                                            "w_down")}
    res = worker.run_ranks(4, str(tmp_path), {"runs": [{
        "kind": "moe", "mesh": (2, 2), "axes": ("data", "model"),
        "cfg": port_cfg(cfg), "params": p,
        "x": torch.from_numpy(z["x"]), "dispatch": "dense"}]})
    y = np.zeros_like(z["y"])
    for rr in res:
        r0 = rr[0]
        d, m = r0["coords"]["data"], r0["coords"]["model"]
        y[2 * d:2 * d + 2, 8 * m:8 * m + 8] = r0["out"].numpy()
        np.testing.assert_array_equal(r0["counts"].numpy(), z["counts"])
        assert int(r0["dropped"]) == int(z["dropped"])
    close(y, z["y"])


# ------------------------------------------------------------- dry-run


def test_dryrun_subprocess_multipod(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on yi-34b x decode_32k at
    (2, 16, 16): exits 0, writes its JSON; the parameter bytes a device are
    the local shards' the specs give, and model_flops is JAX's estimate."""
    _check_dryrun(tmp_path, "yi-34b", "2x16x16")


def test_dryrun_subprocess_mla(tmp_path):
    """The same for deepseek-v2-236b x decode_32k at 16x16: multi-head
    latent attention (the split softmax over the sequence-split latent)
    and the shared experts under the production mesh."""
    _check_dryrun(tmp_path, "deepseek-v2-236b", "16x16")


def _check_dryrun(tmp_path, arch: str, mesh_name: str,
                  shape: str = "decode_32k"):
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", shape, "--out", str(tmp_path)]
        + (["--multi-pod"] if mesh_name == "2x16x16" else []), env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "all requested combinations traced" in r.stdout
    rec = json.loads((tmp_path / f"{arch}_{shape}_{mesh_name}.json")
                     .read_text())
    mesh = StandIn(*MESHES[mesh_name])
    assert rec["status"] == "ok"
    assert rec["n_chips"] == int(np.prod(list(mesh.shape.values())))
    shapes, _ = _port_shapes(get_config(arch), 1, 8)
    want = 0
    for (path, x), (_, spec) in zip(
            _flat(shapes), _flat(tpart.param_specs(shapes, mesh))):
        want += int(np.prod(tpart.local_shape(tuple(x.shape), spec, mesh))) \
            * x.element_size()
    assert rec["param_bytes_per_device"] == want
    assert rec["model_flops"] == janalysis.model_flops_estimate(
        jax_get_config(arch), JSHAPES[shape])
    assert rec["peak_memory_per_device"] >= want + rec["cache_bytes_per_device"]
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes"):
        assert rec[k] > 0, k


# ------------------------------------------------------------- K3 lse


def test_decode_lse_and_two_slice_merge():
    """The plain K3's log-sum-exp is logsumexp of the visible scaled
    scores (-inf at length 0), and merging two sequence slices' (o, lse)
    gives one unsplit call's output."""
    _check_lse_merge(8, 2, 32, 32)


def test_decode_lse_and_two_slice_merge_mla():
    """The same at multi-head latent attention's widths: H = Hkv = 128,
    query/key 192, value 128 (deepseek-v2-236b's split-softmax decode)."""
    _check_lse_merge(128, 128, 192, 128)


def _check_lse_merge(h, hkv, hd, hd_v):
    g = torch.Generator().manual_seed(0)
    b, s_max = 3, 40
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((b, s_max, hkv, hd), generator=g)
    v = torch.randn((b, s_max, hkv, hd_v), generator=g)
    lengths = torch.tensor([40, 17, 0], dtype=torch.int32)
    out, lse = ops.decode_attention(q, k, v, lengths, return_lse=True)
    close(out, ref.decode_attention_ref(q, k, v, lengths))
    kv = k.repeat_interleave(1, 2)
    for bi in range(2):
        for hi in range(h):
            sc = (k[bi, :int(lengths[bi]), hi % hkv] @ q[bi, hi]) / hd ** 0.5
            close(lse[bi, hi], torch.logsumexp(sc, 0))
    assert torch.isinf(lse[2]).all() and (lse[2] < 0).all()
    assert kv.shape == k.shape
    half = 20
    parts = []
    for lo in (0, half):
        ln = (lengths - lo).clamp(0, half)
        parts.append(ops.decode_attention(q, k[:, lo:lo + half],
                                          v[:, lo:lo + half], ln,
                                          return_lse=True))
    lses = torch.stack([p_[1] for p_ in parts])
    m = lses.max(0).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)
    merged = (w[..., None] * torch.stack([p_[0] for p_ in parts])).sum(0) \
        / w.sum(0).clamp(min=1e-30)[..., None]
    close(merged[:2], out[:2])
    close(torch.logsumexp(lses, 0)[:2], lse[:2])
