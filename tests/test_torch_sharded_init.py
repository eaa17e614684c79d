"""The port's sharded init, on the CPU, without a process group:

- every rank's ``DecoderModel.init_shards`` equals its block
  (``partition.local_shard`` under ``param_specs``) of the one-device
  ``init_params`` at the same seed, bit for bit, for the tiny MoE, dense,
  MLA (shared experts, a dense block 0), RG-LRU + local and xLSTM models
  and whisper-base's and qwen2-vl-72b's smoke configs, on four meshes, at
  the default chunk size and at a small one whose chunks cut dims in the
  middle and straddle the ranks' blocks;
- the draw is the same in a process with another ``PYTHONHASHSEED``;
- a stack's copies and leaves of one shape under other paths differ;
- at 16x16, ``launch/train.py``'s reckoning of a rank (``rank_bytes``)
  for the three models a whole draw kept out: its parameter shards are
  the local shards' bytes, its largest chunk at most 32 MiB, and the
  guard admits the rank on an 80 GB card.
"""

from __future__ import annotations

import itertools
import math
import os
import subprocess
import sys

import pytest
import torch

from conftest import tiny_dense, tiny_hybrid, tiny_mla, tiny_moe, tiny_xlstm
from repro.models.config import MLAConfig, MoEConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers
from repro_torch.models.model import DecoderModel
from repro_torch.sharding import partition as tpart
from repro_torch.training.optimizer import tree_leaves
from test_torch_model import port_cfg
from test_torch_sharding import StandIn

ROOT = os.path.join(os.path.dirname(__file__), "..")
SEED = 5

CFGS = {
    "tiny_moe": lambda: port_cfg(tiny_moe()),
    "tiny_dense": lambda: port_cfg(tiny_dense()),
    "tiny_mla": lambda: port_cfg(tiny_mla(
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64,
                      n_shared_experts=2, shared_d_ff=32),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24, qk_rope_dim=8,
                      qk_nope_dim=16, v_head_dim=16),
        dense_block_ids=(0,), n_layers=3)),
    "tiny_hybrid": lambda: port_cfg(tiny_hybrid()),
    "tiny_xlstm": lambda: port_cfg(tiny_xlstm()),
    "whisper-base-smoke": lambda: get_smoke_config("whisper-base"),
    "qwen2-vl-72b-smoke": lambda: get_smoke_config("qwen2-vl-72b"),
}
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# a chunk size that is no power of two: runs of 15 rows of 64, 3 of 256
SMALL_CHUNK = 1000


def _all_coords(mesh):
    for idx in itertools.product(*(range(mesh.shape[a])
                                   for a in mesh.axis_names)):
        yield dict(zip(mesh.axis_names, idx))


def _leaves(tree):
    out = []
    tpart.tree_map_with_path(lambda p, x: out.append((tpart.path_str(p), x)),
                             tree)
    return out


def _straddles(shapes, blocks) -> bool:
    """Whether some chunk of some leaf meets a rank's block in part, on a
    dim the block cuts."""
    for path, x in _leaves(shapes):
        shape = tuple(x.shape)
        k, rows = layers.chunk_layout(shape)
        lo, hi, _ = blocks[path][k].indices(shape[k])
        if (lo, hi) != (0, shape[k]) and (lo % rows or hi % rows) \
                and hi != shape[k]:
            return True
    return False


@pytest.mark.parametrize("chunk", ["default", "small"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CFGS))
def test_shards_equal_the_whole_draw(monkeypatch, name, mesh_name, chunk):
    if chunk == "small":
        monkeypatch.setattr(layers, "CHUNK", SMALL_CHUNK)
    model = DecoderModel(CFGS[name](), device="cpu")
    whole = model.init_params(torch.Generator().manual_seed(SEED))
    mesh = StandIn(*MESHES[mesh_name])
    specs = tpart.param_specs(whole, mesh)
    shapes = model.param_shapes()
    cut = False
    for coords in _all_coords(mesh):
        got = model.init_shards(torch.Generator().manual_seed(SEED), mesh,
                                coords)
        want = tpart.map_with_specs(
            lambda x, s: tpart.local_shard(x, s, mesh, coords), whole, specs)
        assert [p for p, _ in _leaves(got)] == [p for p, _ in _leaves(want)]
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), (path, coords)
        cut |= _straddles(shapes, tpart.param_blocks(shapes, mesh, coords))
    if chunk == "small":
        assert cut, "no chunk straddles a rank's block"
    # shards of a split leaf are smaller than the leaf
    assert sum(x.numel() for x in tree_leaves(got)) < \
        sum(x.numel() for x in tree_leaves(whole))


_CHILD = """
import sys, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import DecoderModel
from repro_torch.sharding.collectives import Mesh
model = DecoderModel(get_smoke_config("qwen3-30b-a3b"), device="cpu")
g = lambda: torch.Generator().manual_seed(%d)
mesh = Mesh((2, 2), ("data", "model"), rank=3)
torch.save({"whole": model.init_params(g()),
            "shards": model.init_shards(g(), mesh)}, sys.argv[1])
"""


def test_draw_is_the_same_in_every_process(tmp_path):
    """A process with another string-hash salt draws the same leaves: the
    chunks' streams are seeded through hashlib, never ``hash()``."""
    from repro_torch.sharding.collectives import Mesh
    model = DecoderModel(get_smoke_config("qwen3-30b-a3b"), device="cpu")
    whole = model.init_params(torch.Generator().manual_seed(SEED))
    shards = model.init_shards(torch.Generator().manual_seed(SEED),
                               Mesh((2, 2), ("data", "model"), rank=3))
    salt = "2" if os.environ.get("PYTHONHASHSEED") == "1" else "1"
    out = str(tmp_path / "draw.pt")
    env = dict(os.environ, PYTHONHASHSEED=salt,
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", _CHILD % SEED, out], env=env,
                   check=True, timeout=120)
    got = torch.load(out, weights_only=True)
    for mine, theirs in ((whole, got["whole"]), (shards, got["shards"])):
        a, b = tree_leaves(mine), tree_leaves(theirs)
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_copies_and_paths_draw_apart(monkeypatch, chunk):
    """A stack's ``reps`` copies differ, two leaves of one shape under
    other paths differ, another seed differs; with small chunks, the
    chunks of one leaf differ too."""
    if chunk == "small":
        monkeypatch.setattr(layers, "CHUNK", SMALL_CHUNK)
    model = DecoderModel(port_cfg(tiny_moe(n_layers=3)), device="cpu")
    p = model.init_params(torch.Generator().manual_seed(SEED))
    blk = p["segments"][0]["pattern"][0]
    gate = blk["moe"]["w_gate"]
    assert gate.shape[0] == 3
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert not torch.equal(gate[i], gate[j])
    assert gate.shape == blk["moe"]["w_up"].shape
    assert not torch.equal(gate, blk["moe"]["w_up"])
    assert blk["attn"]["w_k"].shape == blk["attn"]["w_v"].shape
    assert not torch.equal(blk["attn"]["w_k"], blk["attn"]["w_v"])
    other = model.init_params(torch.Generator().manual_seed(SEED + 1))
    assert not torch.equal(other["embed"]["tok"], p["embed"]["tok"])
    # every expert matrix has its own values (small chunks: one chunk each
    # at most; several chunks within one at the default size never arise
    # at this size)
    flat = gate.reshape(-1, *gate.shape[-2:])
    assert len({tuple(m.flatten()[:8].tolist()) for m in flat}) == \
        flat.shape[0]
    if chunk == "small":
        k, rows = layers.chunk_layout(tuple(gate.shape))
        assert rows < gate.shape[k]
        runs = gate.flatten().split(rows * math.prod(gate.shape[k + 1:]))
        assert not torch.equal(runs[0], runs[1][:runs[0].numel()])


# the three models whose whole draw no card holds: a rank's parameter
# shards at 16x16 (GB)
FULL = {"deepseek-v2-236b": 4.68, "qwen3-moe-235b-a22b": 2.87,
        "qwen2-vl-72b": 9.09}


@pytest.mark.parametrize("arch", list(FULL))
def test_full_size_reckoning_admits_the_rank(arch):
    """``rank_bytes`` at 16x16, on meta tensors: the parameter shards are
    the local shards' bytes, the largest chunk at most 32 MiB, the whole
    tree no card's, and the rank's total under an H100's 80 GB, so the
    guard admits it (and would refuse it on a card with less free)."""
    cfg = get_config(arch)
    mesh = StandIn((16, 16), ("data", "model"))
    need = tlaunch.rank_bytes(cfg, mesh)
    shapes = DecoderModel(cfg, device="cpu").param_shapes()
    kept = []
    tpart.map_with_specs(lambda x, s: kept.append(
        math.prod(tpart.local_shape(tuple(x.shape), s, mesh))
        * x.element_size()), shapes, tpart.param_specs(shapes, mesh))
    assert need["params"] == sum(kept)
    assert round(need["params"] / 1e9, 2) == FULL[arch]
    assert need["grads"] == need["params"]
    assert 0 < need["chunk"] <= 32 * 2 ** 20
    assert need["whole"] > 80e9
    assert need["params"] < need["drawn"] < need["whole"]
    assert need["rank"] == (need["params"] + need["grads"] + need["zero1"]
                            + need["chunk"]) < 80e9
    args = tlaunch.build_parser().parse_args(["--arch", arch])
    tlaunch._admit(cfg, args, need, int(80e9))
    with pytest.raises(SystemExit, match="a rank needs"):
        tlaunch._admit(cfg, args, need, need["rank"] - 1)
