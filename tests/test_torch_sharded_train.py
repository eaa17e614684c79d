"""The port's sharded training step against the JAX package's, on the CPU in
fp32, on 4 gloo ranks (``tests/_torch_shard_worker.py``):

- two steps of the port's ``make_train_step`` under a sharding context
  (JAX's parameters through ``shard_params``, ZeRO-1 moments) against
  JAX's own ``make_train_step`` jitted under its mesh (4 forced host
  devices, a subprocess; the mesh built with ``Mesh(...)``: JAX's
  ``make_mesh`` gives Explicit axes, on which ``shard_hint`` raises), on
  the same global batches: loss, ce, aux_loss and grad norm within 1e-5 of
  the tensor's scale on every rank, ``dropped`` equal exactly; each rank's
  gradient shards (the moments' layout) of the first step, and its
  parameter blocks (the near-zero-gradient rule) and moment shards after
  each step, against JAX's whole leaves cut by the specs.
  The runs take the a2a dense MoE with binding capacity (JAX's group-wise
  capacity: it drops), attention's "gqa" region (s 256), the psum and the
  gathered (JAX: GSPMD) MoE regimes, a vocab the guard keeps whole, and a
  (pod, data, model) mesh whose gradients are summed over ``pod``; one run
  where capacity cannot bind is held against JAX's unsharded step;
- each collective's gradient (and ``regroup``'s, an item sent to two
  ranks) against the same function computed whole on one process, and
  ``RECORD`` counting the backward calls;
- the launcher's per-rank body at (2, 2): the ``[train]`` lines, finite
  metrics, ce falling, and ``--ckpt``: whole leaves under JAX's leaf names
  that the one-device ``--init`` reads, equal to a one-device run's.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import tiny_dense, tiny_moe
from repro.models.config import MLAConfig, MoEConfig
from repro_torch.launch import train as tlaunch
from repro_torch.sharding import partition as tpart
from repro_torch.training import checkpoint as ckpt_io
from repro_torch.training import optimizer as topt
from test_torch_model import close, port_cfg
from test_torch_sharding import StandIn

import _torch_shard_worker as worker

ROOT = os.path.join(os.path.dirname(__file__), "..")
DM = ("data", "model")
ROOMY = dict(n_experts=4, top_k=2, expert_d_ff=64, capacity_factor=2.0)
OPT = dict(lr=3e-3, schedule="wsd", total_steps=4, warmup=1)

# (name, cfg factory, its kwargs, mesh shape, axes (None: against JAX's
# unsharded step), global batch, sequence)
RUNS = [
    # a2a dense, capacity 1.25 per token group: JAX drops
    ("a2a-binding", tiny_moe, {}, (2, 2), DM, 4, 32),
    # attention's "gqa" region (s >= 256, fewer kv heads than model)
    ("gqa-256", tiny_moe, {"n_kv_heads": 1}, (2, 2), DM, 4, 256),
    # the psum MoE regime (31 positions do not divide over model)
    ("psum", tiny_moe, {}, (2, 2), DM, 4, 31),
    # the gathered regime (JAX leaves 24 tokens to GSPMD)
    ("gathered", tiny_moe, {}, (2, 2), DM, 4, 6),
    # a dense MLP, the 255-row vocab kept whole by the guard
    ("whole-vocab", tiny_dense, {"vocab_size": 255}, (2, 2), DM, 4, 32),
    # gradients summed over pod; no ZeRO cut (data is 1)
    ("pod", tiny_moe, {"moe": ROOMY}, (2, 1, 2), ("pod", "data", "model"),
     4, 32),
    # capacity cannot bind: against JAX's unsharded step
    ("unsharded", tiny_moe, {"moe": ROOMY}, (2, 2), None, 4, 32),
]


def _cfg(factory, kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    if "mla" in kw:
        kw["mla"] = MLAConfig(**kw["mla"])
    return factory(**kw)


def _batch(cfg, b, s, seed):
    """A seeded global batch; whisper's ``enc_out`` seeded frames too
    (the launchers feed zeros, under which cross-attention passes no
    gradient)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "mask": rng.random((b, s)) > 0.2}
    if cfg.encoder.enabled:
        out["enc_out"] = rng.normal(size=(b, cfg.encoder.n_frames,
                                          cfg.d_model)).astype(np.float32)
    return out


_JAX_TRAIN = r"""
import contextlib, dataclasses, importlib, os, pickle, sys
import jax, numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
from jax.sharding import Mesh
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import conftest
from repro.models.config import MLAConfig, MoEConfig
from repro.models.model import DecoderModel
from repro.sharding.partition import sharding_context
from repro.training.optimizer import AdamW, adamw
from repro.training.train import make_train_step


class Recording(AdamW):
    # JAX's AdamW, its gradients returned among the step's metrics
    def update(self, grads, state, params):
        p, s, m = AdamW.update(self, grads, state, params)
        return p, s, dict(m, grads=grads)


def leaves(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]


spec = pickle.load(open(sys.argv[1], "rb"))
out = []
for run in spec["runs"]:
    kw = dict(run["kw"])
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    if "mla" in kw:
        kw["mla"] = MLAConfig(**kw["mla"])
    cfg = getattr(importlib.import_module(run["module"]),
                  run["factory"])(**kw)
    model = DecoderModel(cfg, remat=True)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    base = adamw(**spec["opt"])
    opt = Recording(**{f.name: getattr(base, f.name)
                       for f in dataclasses.fields(base)})
    state = opt.init(params)
    init = jax.tree_util.tree_map(np.asarray, params)
    step = jax.jit(make_train_step(model, opt, cfg.encoder.enabled))
    if run["axes"] is None:
        ctx = contextlib.nullcontext
    else:
        n = int(np.prod(run["mesh"]))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(run["mesh"]),
                    run["axes"])

        @contextlib.contextmanager
        def ctx():
            with mesh, sharding_context(mesh):
                yield
    steps = []
    for b in run["batches"]:
        with ctx():
            params, state, m = step(params, state, b)
        steps.append({
            "metrics": {k: float(v) for k, v in m.items() if k != "grads"},
            "grads": leaves(m["grads"]), "params": leaves(params),
            "mu": leaves(state.mu), "nu": leaves(state.nu)})
    out.append({"init": init, "steps": steps})
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-TRAIN-OK")
"""


def run_train(tmp, runs_spec, extra=()):
    """JAX's steps of ``runs_spec`` (``RUNS``' rows) in a subprocess with 4
    forced host devices, and the port's on 4 gloo ranks (with the jobs
    ``extra`` after them): (JAX's results, the ranks' results)."""
    runs, jax_runs = [], []
    for name, factory, kw, mesh, axes, b, s in runs_spec:
        cfg = _cfg(factory, kw)
        batches = [_batch(cfg, b, s, seed) for seed in (0, 1)]
        jax_runs.append({"factory": factory.__name__,
                         "module": factory.__module__, "kw": kw,
                         "mesh": mesh, "axes": axes, "batches": batches})
    spec_path, out_path = tmp / "spec.pkl", tmp / "jax.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump({"runs": jax_runs, "opt": OPT}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _JAX_TRAIN, str(spec_path),
                        str(out_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out_path, "rb") as f:
        jax_out = pickle.load(f)
    for (name, factory, kw, mesh, axes, b, s), jr, ref in zip(
            runs_spec, jax_runs, jax_out):
        cfg = _cfg(factory, kw)
        path = str(tmp / f"{name}.pt")
        torch.save(tpart.tree_map_with_path(
            lambda _, a: torch.from_numpy(np.array(a)), ref["init"]), path)
        runs.append({"kind": "train", "mesh": mesh, "axes": axes or DM,
                     "cfg": port_cfg(cfg), "params": path, "opt": OPT,
                     "batches": [{k: torch.from_numpy(v).long()
                                  if k in ("tokens", "targets")
                                  else torch.from_numpy(v)
                                  for k, v in bt.items()}
                                 for bt in jr["batches"]]})
    runs.extend(extra)
    return jax_out, worker.run_ranks(4, str(tmp), {"runs": runs})


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("train"), RUNS, [
        {"kind": "colls", "mesh": (2, 2), "axes": DM, **_COLL_JOB}])


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[r[0] for r in RUNS])
def test_sharded_train_step_matches_jax(train_results, i):
    jax_out, results = train_results
    check_train_run(RUNS[i], jax_out[i], [r[i] for r in results])


def check_train_run(run, ref, ranks):
    """One run's steps on every rank (``ranks``) against JAX's (``ref``):
    the metrics, the first step's gradient shards, the moment shards and
    the parameter blocks after each step."""
    name, factory, kw, mesh_shape, axes, b, s = run
    mesh = StandIn(mesh_shape, axes or DM)
    plan = topt.tree_leaves(tpart.zero1_plan(ref["init"], mesh))
    pspecs = [lp.spec for lp in plan]
    mspecs = [lp.moment for lp in plan]
    shapes = [np.shape(x) for x in topt.tree_leaves(ref["init"])]
    # per leaf and element: the steps so far whose JAX gradient there lay
    # within the gradients' own tolerance (1e-5)
    noisy = [np.zeros(sh) for sh in shapes]
    for k, want in enumerate(ref["steps"]):
        wm = want["metrics"]
        if name == "a2a-binding" and k == 0:
            assert wm["dropped"] > 0, "capacity must bind"
        for n_, g in zip(noisy, want["grads"]):
            n_ += np.abs(g) <= 1e-5
        for rank in ranks:
            got = rank["steps"][k]
            coords = rank["coords"]
            gm = got["metrics"]
            for key in ("loss", "ce", "aux_loss", "grad_norm", "lr"):
                close(np.float32(gm[key]), np.float32(wm[key]))
            assert gm["dropped"] == wm["dropped"], (gm, wm)
            # the gradients of the first step (the second step's start
            # from parameters the near-zero rule below lets part)
            kinds = (("grads", mspecs),) if k == 0 else ()
            for kind, specs in kinds + (("mu", mspecs), ("nu", mspecs),
                                        ("params", pspecs)):
                for shape, spec, g, w, n_ in zip(shapes, specs, got[kind],
                                                 want[kind], noisy):
                    sl = tpart.local_slices(shape, spec, mesh, coords)
                    assert tuple(g.shape) == w[sl].shape, (kind, spec)
                    if kind != "params":
                        close(g, w[sl])
                        continue
                    # the near-zero-gradient rule: AdamW's m / (sqrt(v) +
                    # eps) is O(1) for any gradient, so an element whose
                    # gradient is small moves by an amount the two
                    # frameworks' summation noise moves: 1e-2 of the
                    # largest move (lr a step), as in
                    # tests/test_torch_train_jax.py, and up to lr either
                    # way in a step where its gradient lay within that
                    # noise (seen: 4.6e-8 in a leaf of scale 0.1, moved
                    # 1.7e-4 apart); beyond that 1e-5 of the leaf's scale
                    scale = max(1.0, float(np.abs(w).max()))
                    err = np.abs(g.numpy() - w[sl])
                    limit = 1e-5 * scale + 1e-5 * np.abs(w[sl]) \
                        + OPT["lr"] * (1e-2 * (k + 1) + 2 * n_[sl])
                    assert (err <= limit).all(), (
                        kind, spec, float((err - limit).max()))


# ------------------------------------------------------------- collectives

_RNG = np.random.default_rng(7)


def _rand(*shape):
    return torch.from_numpy(_RNG.normal(size=shape).astype(np.float32))


_A2AV = {0: ([2, 3], [2, 4]), 1: ([4, 1], [3, 1])}     # model index: send, recv
_REGROUP = (((0, 1), (2, 3)), ((0, 2, 3), (1, 2)))      # item 2 to both ranks
_SHAPES = {"all_gather": (3, 2, 4), "reduce_scatter": (3, 4, 2),
           "all_reduce": (2, 3), "all_to_all": (4, 3),
           "all_to_all_v": (5, 2), "regroup": (3, 2)}
_COLL_JOB = {
    "cases": [(name, [_rand(*shape) for _ in range(4)],
               [_rand(64) for _ in range(4)])
              for name, shape in _SHAPES.items()],
    "counts": {r: _A2AV[r % 2] for r in range(4)},
    "regroup": _REGROUP,
}


def _whole(name, xs):
    """Every rank's output of collective ``name`` from all ranks' inputs
    ``xs`` (rank r at (data, model) = (r // 2, r % 2)), in one process."""
    ys = []
    for r in range(4):
        d, m = divmod(r, 2)
        row = [xs[2 * d], xs[2 * d + 1]]          # the model group
        col_ = [xs[m], xs[m + 2]]                 # the data group
        if name == "all_gather":
            ys.append(torch.cat(row, dim=1))
        elif name == "reduce_scatter":
            ys.append((row[0] + row[1])[:, 2 * m:2 * m + 2])
        elif name == "all_reduce":
            ys.append(sum(xs))
        elif name == "all_to_all":
            ys.append(torch.cat([x.chunk(2, dim=0)[d] for x in col_], dim=1))
        elif name == "all_to_all_v":
            parts = []
            for j, x in enumerate(row):
                send = _A2AV[j][0]
                start = sum(send[:m])
                parts.append(x[start:start + send[m]])
            ys.append(torch.cat(parts))
        else:
            src, dst = _REGROUP
            items = {it: row[g][:, k] for g in range(2)
                     for k, it in enumerate(src[g])}
            ys.append(torch.stack([items[it] for it in dst[m]], dim=1))
    return ys


_CALLS = {"all_gather": {"all-gather": 1, "reduce-scatter": 1},
          "reduce_scatter": {"reduce-scatter": 1, "all-gather": 1},
          "all_reduce": {"all-reduce": 2}, "all_to_all": {"all-to-all": 2},
          "all_to_all_v": {"all-to-all": 2}, "regroup": {"all-to-all": 2}}


@pytest.mark.parametrize("name", list(_SHAPES))
def test_collective_gradients(train_results, name):
    """The gradient of the ranks' summed terms through each collective, on
    each rank's block, equals the same function's computed whole; the
    forward output too; ``RECORD`` counts the forward and the backward
    call."""
    _, results = train_results
    case = next(c for c in _COLL_JOB["cases"] if c[0] == name)
    xs = [x.clone().requires_grad_(True) for x in case[1]]
    ys = _whole(name, xs)
    sum((y * w[:y.numel()].reshape(y.shape)).sum()
        for y, w in zip(ys, case[2])).backward()
    for r, rank in enumerate(results):
        y, g, calls = rank[-1][name]
        torch.testing.assert_close(y, ys[r].detach())
        torch.testing.assert_close(g, xs[r].grad)
        assert {k: v for k, v in calls.items() if v} == _CALLS[name]


# ------------------------------------------------------------- launcher


def test_launcher_rank_body_and_checkpoint(tmp_path, capfd):
    """``train_sharded`` at (2, 2) on minicpm-2b's smoke config, three
    steps: rank 0 prints the JAX launcher's ``[train]`` lines; the metrics
    are finite, equal on every rank and within 1e-5 of a one-device run's
    of the same steps, ce falls; ``--ckpt`` writes whole leaves under the
    one-device checkpoint's (JAX's) leaf names, each rank's blocks of them
    exactly, and the one-device ``--init`` reads them back bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import DecoderModel
    from repro_torch.training.data import PackedDataset, SyntheticCorpus
    from repro_torch.training.train import device_batch, make_train_step
    sharded, again = str(tmp_path / "sharded.pt"), str(tmp_path / "again.pt")
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "64", "--lr", "3e-3"]
    res = worker.run_ranks(4, str(tmp_path), {"runs": [{
        "kind": "launcher", "mesh": (2, 2), "axes": DM,
        "argv": argv + ["--ckpt", sharded]}]})
    out = capfd.readouterr().out
    assert "[train] minicpm-2b-smoke:" in out
    assert "params on mesh {'data': 2, 'model': 2}" in out
    assert "[train] step     1 loss=" in out
    assert f"[train] checkpoint -> {sharded}" in out
    hist = [r[0]["history"] for r in res]
    assert all(h == hist[0] for h in hist)
    ce = [m["ce"] for m in hist[0]]
    assert len(ce) == 3 and all(np.isfinite(ce)) and ce[2] < ce[0], ce
    # the same three steps on one device
    args = tlaunch.build_parser().parse_args(argv)
    cfg = get_smoke_config(args.arch)
    model = DecoderModel(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = tlaunch._optimizer(args)
    state, step = opt.init(params), make_train_step(model, opt)
    ds = iter(PackedDataset(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                            seed=0), seq_len=args.seq,
                            batch_size=args.batch, seed=0))
    for m_sh in hist[0]:
        params, state, m = step(params, state,
                                device_batch(model, *next(ds)))
        for key in ("loss", "ce", "grad_norm", "lr"):
            close(np.float32(m_sh[key]), m[key].numpy())
    got = torch.load(sharded, weights_only=True)
    assert list(got) == ckpt_io.leaf_names({"params": params, "opt": state})
    mesh = StandIn((2, 2), DM)
    plan = tpart.zero1_plan(model.param_shapes(), mesh)
    names = ckpt_io.leaf_names(plan)
    for kind, key, spec_of in (("params", "params", lambda lp: lp.spec),
                               ("opt/.mu", "mu", lambda lp: lp.moment),
                               ("opt/.nu", "nu", lambda lp: lp.moment)):
        for r in res:
            for name, lp, block in zip(names, topt.tree_leaves(plan),
                                       r[0][key]):
                whole = got[f"{kind}/{name}"]
                sl = tpart.local_slices(tuple(whole.shape), spec_of(lp),
                                        mesh, r[0]["coords"])
                assert torch.equal(whole[sl], block), (kind, name)
    tlaunch.main(["--smoke", "--device", "cpu", "--steps", "0", "--init",
                  sharded, "--ckpt", again])
    restored = torch.load(again, weights_only=True)
    for k, v in got.items():
        if k.startswith("params/"):
            assert torch.equal(restored[k], v), k
