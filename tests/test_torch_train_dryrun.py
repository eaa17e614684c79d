"""The multi-device dry-run of ``train_4k``, on the CPU: ``python -m
repro_torch.launch.dryrun`` traces qwen3-30b-a3b's sharded training step
(rank 0 of 16x16 on fake tensors: forward and backward with remat, K2's and
K4's backward kernels as custom ops, the ZeRO-1 update) in a subprocess;
deepseek-v2-236b's traces in process; the architectures whose mixers a
mesh does not take yet are written as skipped with the ROADMAP.md item
that ports them."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from repro_torch.launch import dryrun
from repro_torch.configs import get_config
from repro_torch.models.model import DecoderModel
from repro_torch.sharding import partition as tpart
from test_torch_sharding import MESHES, StandIn, _flat

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_dryrun_train_4k_subprocess(tmp_path):
    """Exit 0, status ok; peak memory a device below the card's 80 GB and
    above the rank's parameter and moment shards; the moments are the
    ZeRO-1 shards ``moment_specs`` gives; collective bytes of every kind
    the step uses (all-gather, reduce-scatter, all-reduce, all-to-all)
    nonzero."""
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-30b-a3b", "--shape", "train_4k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen3-30b-a3b_train_4k_16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    shapes = DecoderModel(get_config("qwen3-30b-a3b"),
                          device="cpu").param_shapes()
    mesh = StandIn(*MESHES["16x16"])
    want = 0
    for (_, x), (_, spec) in zip(_flat(shapes),
                                 _flat(tpart.moment_specs(shapes, mesh))):
        want += 2 * int(np.prod(tpart.local_shape(tuple(x.shape), spec,
                                                  mesh))) * 4
    assert rec["moment_bytes_per_device"] == want
    peak = rec["peak_memory_per_device"]
    assert rec["param_bytes_per_device"] + want < peak < 80e9
    for kind in ("all-gather", "reduce-scatter", "all-reduce",
                 "all-to-all"):
        assert rec["collective_by_kind"][kind] > 0, kind
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0


def test_dryrun_train_4k_skips_name_their_roadmap_item():
    """deepseek-v2-236b (multi-head latent attention, shared experts)
    traces at ``train_4k`` within the card's 80 GB a device; the archs
    whose mixers a mesh does not take yet skip, naming their item."""
    rec = dryrun.dryrun_one("deepseek-v2-236b", "train_4k", verbose=False)
    assert rec["status"] == "ok", rec
    assert (rec["param_bytes_per_device"] + rec["moment_bytes_per_device"]
            < rec["peak_memory_per_device"] < 80e9), rec
    for arch in ("recurrentgemma-9b", "xlstm-1.3b", "whisper-base"):
        rec = dryrun.dryrun_one(arch, "train_4k", verbose=False)
        assert rec["status"] == "skipped", rec
        assert "ROADMAP.md §1 item 2" in rec["reason"], rec
        assert "step 1" in rec["reason"], rec
