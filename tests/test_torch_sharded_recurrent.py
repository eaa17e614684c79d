"""The recurrent mixers and local attention under a mesh, on the CPU in fp32
on 4 gloo ranks (``tests/_torch_shard_worker.py``), against the JAX
package:

- the sharded prefill, decode and layered steps of ``tiny_hybrid``
  (RG-LRU and local attention) and ``tiny_xlstm`` (mLSTM and sLSTM)
  against JAX's unsharded forward, as ``test_torch_sharding.py`` holds the
  GQA runs: logits within 1e-5 of the tensor's scale, and every cache leaf
  (RG-LRU's ``conv`` and ``h``, mLSTM's ``C``/``n``/``m``/``conv``,
  sLSTM's ``c``/``n``/``h``/``m``, local attention's ``k``/``v``) put
  together from the ranks' blocks equal to JAX's.  The runs take a window
  that cuts a slice and slices wholly before it (the split softmax, K3 and
  K2 with their log-sum-exp, under the window), the windowed "gqa" region
  over the gathered cache, mLSTM stepwise (S < 256) and chunkwise (S 256),
  a (2, 2) and a (1, 4) mesh;
- two sharded training steps of each against JAX's own
  ``make_train_step`` jitted under ``Mesh(...)`` on 4 forced host
  devices: each rank's gradient shards of the leaves it holds whole but
  uses a slice of (``conv_w``, ``conv_b``, ``a_param``, ``w_rec_gate``),
  of the one whose blocks it regroups (``w_input_gate``), and of the
  weights every rank computes whole (mLSTM's ``w_q``/``w_k``/``w_v``/
  ``w_z``/``w_if``, all of sLSTM's);
- K3's contract for a query past its slice (a length past S_max), with
  and without a window, in the plain version against ``ref.py``, and K2's
  (offsets past S_max) under a window against a direct computation.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_hybrid, tiny_xlstm
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.sharding import partition as tpart
from test_torch_model import close, port_cfg
from test_torch_sharded_train import DM, check_train_run, run_train
from test_torch_sharding import StandIn, _flat, check_step_run, run_steps

STEP_RUNS = [
    # (name, cfg, mesh, b, s, cache_len, dispatch, layered group, P)
    # window 8 over a 64-position cache on model 4 (slices of 16): the
    # decode at position 44 sees keys 37-44, so slices 0 and 1 lie wholly
    # before the window and slice 2 is cut by it; the prefill (its last
    # query sees keys 36-43) and the layered row (20-27) take the split
    # softmax, K2 with its log-sum-exp, cut by the window too
    ("hybrid-window-tp4", tiny_hybrid(local_window=8), (1, 4), 2, 44, 64,
     "dense", (0, 3), 28),
    # s 256 on (2, 2): JAX's "gqa" region (K2 windowed over the gathered
    # cache), then K3 windowed over a slice the window cuts
    ("hybrid-gqa-256", tiny_hybrid(), (2, 2), 4, 256, 272, "dense", (0, 3),
     32),
    # mLSTM stepwise (S 16), sLSTM's h split over model, the layered row
    ("xlstm-step", tiny_xlstm(), (2, 2), 4, 16, 32, "dense", (0, 2), 16),
    # mLSTM chunkwise (S 256) on model 4
    ("xlstm-chunk-tp4", tiny_xlstm(), (1, 4), 2, 256, 264, "dense", None,
     None),
]


def test_step_runs_cover_every_regime():
    """The runs below take, between them: local attention's split softmax
    under a window that cuts a slice and leaves others wholly before it
    (decode and prefill), JAX's "gqa" region with the window over the
    gathered cache, RG-LRU on whole gate blocks with ``w_input_gate``
    regrouped, mLSTM stepwise and chunkwise, sLSTM with its ``h`` split,
    on both meshes; ``spmd.unported`` is gone (every registry config
    shards)."""
    from repro_torch.sharding import spmd
    assert not hasattr(spmd, "unported")
    seen = set()
    for name, cfg, mesh, b, s, clen, _, group, p_len in STEP_RUNS:
        m = StandIn(mesh, DM)
        n = m.shape["model"]
        seen.add(f"mesh {mesh}")
        tcfg = port_cfg(cfg)
        rules = tpart.default_rules(m)
        if "rglru" in cfg.mixer_pattern:
            w = cfg.lru_width
            assert (w // n) % (w // 16) == 0
            seen.add("rglru gate blocks regrouped")
            mode = tpart.kv_cache_mode(m, rules, cfg.n_kv_heads, clen)
            with tpart.sharding_context(m):
                calls = [(b, s, 0), (b, 1, s)] + (
                    [(1, p_len, 0)] if group else [])
                for cb, cs, off in calls:
                    if tattn._attn_shard_plan(tcfg, cb, cs):
                        seen.add("local gqa region")
                        continue
                    assert mode == "seq"
                    s_c = clen // n
                    last = off + cs - 1
                    lo = last - cfg.local_window + 1
                    for j in range(n):
                        if (j + 1) * s_c <= lo:
                            seen.add("slice before the window")
                        elif j * s_c < lo < (j + 1) * s_c:
                            seen.add(f"window cuts a slice s={min(cs, 2)}")
        else:
            seen.add("mlstm chunkwise" if s >= 256 and s % 128 == 0
                     else "mlstm stepwise")
            if cfg.d_model % n == 0:
                seen.add("slstm h split")
    assert {"mesh (2, 2)", "mesh (1, 4)", "rglru gate blocks regrouped",
            "local gqa region", "slice before the window",
            "window cuts a slice s=1", "window cuts a slice s=2",
            "mlstm stepwise", "mlstm chunkwise", "slstm h split"} <= seen, \
        seen


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("rec_ranks")), STEP_RUNS)


@pytest.mark.parametrize("i", range(len(STEP_RUNS)),
                         ids=[r[0] for r in STEP_RUNS])
def test_sharded_recurrent_steps_match_jax(step_results, i):
    refs, results = step_results
    leaves = {p.rsplit("/", 1)[-1] for p, _ in _flat(refs[i]["cache"])}
    want = ({"conv", "h", "k", "v"} if "hybrid" in STEP_RUNS[i][0]
            else {"C", "n", "m", "conv", "c", "h"})
    assert want <= leaves, leaves
    check_step_run(STEP_RUNS[i], refs[i], results, i)


# ------------------------------------------------------------- training

# (name, cfg factory, its kwargs, mesh shape, axes, global batch, sequence)
TRAIN_RUNS = [
    # RG-LRU on (2, 2) and local attention over the rank's heads
    ("hybrid", tiny_hybrid, {"local_window": 8}, (2, 2), DM, 4, 32),
    # mLSTM chunkwise and sLSTM, model 4
    ("xlstm-tp4", tiny_xlstm, {}, (1, 4), DM, 4, 256),
]
# the leaves each rank holds whole and whose gradient is its share, summed
# over model by ZeRO-1's plan; and the one regrouped by an all-to-all
SHARE_LEAVES = {
    "hybrid": ("rglru/conv_w", "rglru/conv_b", "rglru/a_param",
               "rglru/w_rec_gate"),
    "xlstm-tp4": ("lstm/w_z", "lstm/w_q", "lstm/w_k", "lstm/w_v",
                  "lstm/w_if", "lstm/b_if", "lstm/conv_w", "lstm/w_zifo",
                  "lstm/r_zifo", "lstm/b_zifo"),
}


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("rec_train"), TRAIN_RUNS)


@pytest.mark.parametrize("i", range(len(TRAIN_RUNS)),
                         ids=[r[0] for r in TRAIN_RUNS])
def test_sharded_recurrent_train_step_matches_jax(train_results, i):
    jax_out, results = train_results
    ref_ = jax_out[i]
    name = TRAIN_RUNS[i][0]
    mesh = StandIn(TRAIN_RUNS[i][3], DM)
    specs = dict(_flat(tpart.param_specs(ref_["init"], mesh)))
    paths = list(specs)
    for leaf in SHARE_LEAVES[name]:
        hits = [p for p in paths if p.endswith(leaf)]
        assert hits and all(tpart.spec_axes(specs[p]) == set()
                            for p in hits), (leaf, specs)
    if name == "hybrid":
        ig = [p for p in paths if p.endswith("rglru/w_input_gate")]
        assert ig and all(specs[p][-1] == "model" for p in ig), specs
    # every share reaches JAX's gradient (a rank's share dropped fails)
    check_train_run(TRAIN_RUNS[i], ref_, [r[i] for r in results])
    assert np.isfinite(results[0][i]["steps"][1]["metrics"]["loss"])


# ------------------------------------------------------------- K3 contract


@pytest.mark.parametrize("window", [None, 8])
def test_decode_past_the_slice_matches_ref(window):
    """A length past S_max: the query sits beyond this slice and sees keys
    ``[max(0, length - window), min(length, S_max))``; a range left empty
    gives o = 0 and lse = -inf.  The plain version against ``ref.py`` and
    against attention over the whole row cut to the slice's keys."""
    g = torch.Generator().manual_seed(3)
    b, h, hkv, hd, s_max = 5, 4, 1, 16, 16
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((b, s_max, hkv, hd), generator=g)
    v = torch.randn((b, s_max, hkv, hd), generator=g)
    # inside, at the end, just past, cut by the window, wholly past it
    lengths = torch.tensor([9, 16, 17, 21, 40], dtype=torch.int32)
    out, lse = ops.decode_attention(q, k, v, lengths, window=window,
                                    return_lse=True)
    close(out, ref.decode_attention_ref(q, k, v, lengths, window=window))
    close(lse, ref.decode_attention_lse_ref(q, k, lengths, window=window))
    for bi, ln in enumerate(lengths.tolist()):
        lo = max(0, ln - window) if window else 0
        hi = min(ln, s_max)
        if hi <= lo:
            assert (out[bi] == 0).all()
            assert torch.isinf(lse[bi]).all() and (lse[bi] < 0).all()
            continue
        sc = torch.einsum("hd,sd->hs", q[bi], k[bi, lo:hi, 0]) / hd ** 0.5
        close(lse[bi], torch.logsumexp(sc, -1))
        close(out[bi], torch.softmax(sc, -1) @ v[bi, lo:hi, 0])
    if window:
        assert (out[4] == 0).all() and not (out[3] == 0).all()


def test_prefill_past_the_slice_matches_direct():
    """K2's contract for queries beyond a slice (offsets past S_max, the
    split softmax of a prefill over an earlier slice): query i sees keys
    ``[offset + i - window + 1, offset + i]`` within the slice, none where
    that range misses it (output 0, log-sum-exp -inf)."""
    g = torch.Generator().manual_seed(4)
    b, p, h, hkv, hd, s_max, window = 3, 6, 4, 1, 16, 16, 8
    q = torch.randn((b, p, h, hd), generator=g)
    k = torch.randn((b, s_max, hkv, hd), generator=g)
    v = torch.randn((b, s_max, hkv, hd), generator=g)
    offset = torch.tensor([12, 18, 30], dtype=torch.int32)
    out, lse = ops.prefill_attention(q, k, v, offset, window=window,
                                     return_lse=True)
    for bi, off in enumerate(offset.tolist()):
        for i in range(p):
            lo, hi = max(0, off + i - window + 1), min(off + i + 1, s_max)
            if hi <= lo:
                assert (out[bi, i] == 0).all()
                assert torch.isinf(lse[bi, :, i]).all()
                continue
            sc = torch.einsum("hd,sd->hs", q[bi, i], k[bi, lo:hi, 0]) \
                / hd ** 0.5
            close(lse[bi, :, i], torch.logsumexp(sc, -1))
            close(out[bi, i], torch.softmax(sc, -1) @ v[bi, lo:hi, 0])
    assert (out[2] == 0).all() and not (out[1] == 0).all()
