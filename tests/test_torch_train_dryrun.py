"""The multi-device dry-run of ``train_4k``, on the CPU: ``python -m
repro_torch.launch.dryrun`` traces qwen3-30b-a3b's sharded training step
(rank 0 of 16x16 on fake tensors: forward and backward with remat, K2's and
K4's backward kernels as custom ops, the ZeRO-1 update) in a subprocess;
deepseek-v2-236b's, recurrentgemma-9b's, xlstm-1.3b's and whisper-base's
trace in process."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

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
    for op in BACKWARD_OPS["qwen3-30b-a3b"]:
        assert rec["flops_by_op"].get(op, 0) > 0, (op, rec["flops_by_op"])


# the backward custom ops each arch's train step reaches (the kernels' and
# the recurrences' one-op forms)
BACKWARD_OPS = {
    "qwen3-30b-a3b": ("repro_torch.prefill_attention_bwd",
                      "repro_torch.moe_gmm_bwd"),
    "deepseek-v2-236b": ("repro_torch.prefill_attention_bwd",
                         "repro_torch.moe_gmm_bwd"),
    "recurrentgemma-9b": ("repro_torch.prefill_attention_bwd",),
    "xlstm-1.3b": ("repro_torch.slstm_scan_bwd",
                   "repro_torch.mlstm_chunkwise_bwd"),
    "whisper-base": ("repro_torch.prefill_attention_bwd",),
}


@pytest.fixture(scope="module")
def train_recs():
    return {arch: dryrun.dryrun_one(arch, "train_4k", verbose=False)
            for arch in ("deepseek-v2-236b", "recurrentgemma-9b",
                         "xlstm-1.3b", "whisper-base")}


def test_dryrun_train_4k_counts_backward_flops(train_recs):
    """Every backward custom op a ``train_4k`` step reaches counts its
    flops (``launch/analysis.py``'s formulas): none is counted as 0."""
    for arch, rec in train_recs.items():
        for op in BACKWARD_OPS[arch]:
            assert rec["flops_by_op"].get(op, 0) > 0, (arch, op,
                                                       rec["flops_by_op"])


def test_dryrun_train_4k_skips_name_their_roadmap_item(train_recs):
    """deepseek-v2-236b (multi-head latent attention, shared experts) and
    the archs that were skipped before their mixers took a mesh
    (recurrentgemma-9b, xlstm-1.3b, whisper-base) trace at ``train_4k``
    within the card's 80 GB a device: no ``train_4k`` combination is
    skipped any more."""
    for arch, rec in train_recs.items():
        assert rec["status"] == "ok", rec
        assert (rec["param_bytes_per_device"]
                + rec["moment_bytes_per_device"]
                < rec["peak_memory_per_device"] < 80e9), rec
