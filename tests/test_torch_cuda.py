"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test here carries the ``cuda`` marker and
skips where there is no CUDA device (the kernels have no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_cuda.py

Tolerances: bf16 inputs against the fp32 plain versions — attention
(prefill, decode, paged decode and paged verify) within atol = rtol =
2e-2, the ragged and the dense SwiGLU within 1e-2 relative Frobenius (the
kernels round H to bf16 between their two phases)."""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _ragged_layout(e, m_blk, counts):
    padded = [-(-c // m_blk) * m_blk for c in counts]
    n_rows = sum(padded) + m_blk            # leave a sentinel tail tile
    te = []
    for ex, p_ in enumerate(padded):
        te += [ex] * (p_ // m_blk)
    te += [e] * ((n_rows - sum(padded)) // m_blk)
    return n_rows, np.asarray(te, np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev, torch.bfloat16)


# (E, d, F, m_blk, counts): the last four run the TMA ring around several
# times (d 512: 8 stages of gate/up, F 256: 4 of down) over empty experts
# and a sentinel tail, at tile heights 8, 128 (two consumer warpgroups), 16
# (an all-padding buffer) and 32 (d 520 and F 264, off the 64-column
# tiles: a partial reduction stage and a last d-tile of 8 columns)
RAGGED_CASES = [
    (4, 256, 128, 8, [16, 0, 3, 1]), (8, 128, 256, 64, [64, 0, 0, 70, 0, 0, 0, 1]),
    (16, 512, 256, 8, [9, 0, 0, 1, 24, 0, 7, 0, 0, 0, 3, 0, 0, 0, 0, 17]),
    (16, 512, 256, 128, [130, 0, 0, 1, 240, 0, 7, 0, 0, 0, 3, 0, 0, 0, 0, 17]),
    (16, 512, 256, 16, [0] * 16),
    (16, 520, 264, 32, [33, 0, 5] + [0] * 13),
]


@pytest.mark.cuda
@pytest.mark.parametrize("e,d,f,m_blk,counts", RAGGED_CASES)
def test_moe_gmm_ragged_kernel_matches_plain(cuda, e, d, f, m_blk, counts):
    """The two-phase ragged kernel against its plain version; sentinel
    tiles give zero rows; two launches give bit-identical outputs."""
    n_rows, te = _ragged_layout(e, m_blk, counts)
    rng = np.random.default_rng(0)
    args = (_bf16(rng, (n_rows, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5),
            torch.from_numpy(te).to(cuda), m_blk)
    before = ops.LAUNCHES["moe_gmm_ragged"]
    got = ops.moe_gmm_ragged(*args)
    again = ops.moe_gmm_ragged(*args)
    assert ops.LAUNCHES["moe_gmm_ragged"] == before + 2
    assert torch.equal(got, again)
    sentinel = torch.from_numpy(te == e).to(cuda).repeat_interleave(m_blk)
    assert not got[sentinel].any()
    assert torch.isfinite(got.float()).all()
    want = ref.moe_gmm_ragged_ref(*args).float()
    # (an all-padding buffer has want = 0 and must give exactly 0)
    assert (got.float() - want).norm() <= 1e-2 * want.norm()


@pytest.mark.cuda
def test_moe_kernels_give_the_same_rows_at_every_tile_height(cuda):
    """The same tokens of one expert through K1 (m_blk 8, 64, 128) and K4
    (C 8, 64 and 72, so row tiles of 8, 64 and 128) come out bit for bit
    the same: one instruction, K order and rounding for every row,
    whatever the tile height, the consumer warpgroup or the kernel."""
    rng = np.random.default_rng(10)
    e, d, f, n_tok = 4, 256, 192, 72
    tokens = _bf16(rng, (n_tok, d), cuda)
    w = (_bf16(rng, (e, d, f), cuda, d ** -0.5), _bf16(rng, (e, d, f), cuda, d ** -0.5),
         _bf16(rng, (e, f, d), cuda, f ** -0.5))
    outs = []
    for m_blk in (8, 64, 128):
        # expert 0: 5 other rows; expert 1: the tokens; sentinel tail
        n_rows, te = _ragged_layout(e, m_blk, [5, n_tok, 0, 0])
        rows = _bf16(rng, (n_rows, d), cuda)
        rows[m_blk:m_blk + n_tok] = tokens
        y = ops.moe_gmm_ragged(rows, *w, torch.from_numpy(te).to(cuda), m_blk)
        outs.append(y[m_blk:m_blk + n_tok])
    for c in (8, 64, 72):
        x = _bf16(rng, (e, c, d), cuda)
        n = min(c, n_tok)
        x[1, :n] = tokens[:n]
        outs.append(ops.moe_gmm(x, *w)[1, :n])
    for y in outs[1:]:
        assert torch.equal(y, outs[0][:len(y)])


@pytest.mark.cuda
def test_attention_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    b, p, s_max, h, hkv, hd = 3, 40, 128, 16, 2, 64
    q = _bf16(rng, (b, p, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    off = torch.tensor([0, 50, 88], dtype=torch.int32, device=cuda)
    for window in (None, 20):
        got = ops.prefill_attention(q, k, v, off, window=window).float()
        want = ref.prefill_attention_ref(q, k, v, off, window=window).float()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        lens = off + 7
        got = ops.decode_attention(q[:, 0].contiguous(), k, v, lens,
                                   window=window).float()
        want = ref.decode_attention_ref(q[:, 0], k, v, lens,
                                        window=window).float()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


# (hd, H, Hkv): hd 128 / 64 / 32 (qwen3-30b-a3b, the test above, the
# reduced model), group sizes 1, 4, 8 and 16
ATTN_SHAPES = [(128, 32, 4), (64, 8, 2), (32, 8, 1), (64, 4, 4),
               (128, 16, 1), (32, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 70])
def test_decode_attention_kernel_matches_plain(cuda, hd, h, hkv, window):
    """The split-K decode kernel against its plain version: lengths of 1,
    exactly at split and tile boundaries, mid-tile, S_max, and the idle
    clamp S_max + 1; a window that crosses splits and tile edges; two
    launches give bit-identical outputs (the splits merge in a fixed
    order, no float atomics)."""
    rng = np.random.default_rng(6)
    b, s_max = 8, 320
    split = ops.decode_split(b, hkv, s_max)
    assert split > 1
    lens = [1, s_max + 1, 16 * split, 64 * split, 17, s_max, 129,
            16 * split + 1]
    q = _bf16(rng, (b, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, lengths, window=window)
    again = ops.decode_attention(q, k, v, lengths, window=window)
    assert ops.LAUNCHES["decode_attention"] == before + 2
    want = ref.decode_attention_ref(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_decode_attention_unsplit_and_empty_rows(cuda):
    """One 64-key tile per row (split 1: no merge launch) and a row of
    length 0, which sees no key and outputs 0."""
    rng = np.random.default_rng(7)
    b, h, hkv, hd, s_max = 4, 8, 1, 64, 64
    assert ops.decode_split(b, hkv, s_max) == 1
    q = _bf16(rng, (b, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    lengths = torch.tensor([0, 1, 40, 64], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_max,lens", [
    # qwen3-30b-a3b's 8-slot decode step (split > 1: the merge launch
    # writes the log-sum-exp)
    (8, 2048, [601, 700, 1516, 2048, 2049, 1, 64, 1000]),
    # a rank's 128-position slice of a sequence-split cache: lengths
    # clamped to the slice, 0 where it lies past the row
    (2, 128, [0, 128]), (4, 128, [0, 0, 37, 128])])
def test_decode_attention_lse_matches_plain(cuda, b, s_max, lens):
    """K3's optional log-sum-exp at qwen3's heads (32/4 of 128) against
    its plain version (-inf where a query sees no key, and output 0); the
    output keeps the bits of the serve call without it."""
    _check_decode_lse(cuda, b, s_max, lens, 32, 4, 128, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_max,lens", [
    # deepseek-v2-236b's sharded decode step on (2, 8): a rank's row over
    # its 128-position slice of a 1024-row latent, every head (the split
    # softmax), lengths clamped to the slice, 0 past the row
    (1, 128, [0]), (2, 128, [0, 128]), (4, 128, [1, 0, 37, 128]),
    # the unsharded 8-slot decode step (split > 1)
    (8, 2048, [601, 700, 1516, 2048, 2049, 1, 64, 1000])])
def test_decode_attention_lse_mla_widths(cuda, b, s_max, lens):
    """K3's log-sum-exp at multi-head latent attention's widths (H = Hkv
    = 128, query/key 192, value 128) against its plain version, as
    ``test_decode_attention_lse_matches_plain`` holds it at qwen3's; the
    output within the file's attention tolerance (K3 rounds P to bf16
    before P.V: 2 bf16 ulps at these widths, where qwen3's stay within
    one)."""
    _check_decode_lse(cuda, b, s_max, lens, 128, 128, 192, 128,
                      dict(atol=2e-2, rtol=2e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("window,lens", [
    # recurrentgemma-9b's sharded decode (2, 8): a rank's 512-position
    # slice of a 4096-row cache, the query past it (a length past S_max):
    # slice 0 at position 2816 lies wholly before the 2048-key window,
    # slice 1 (2816 - 512) is cut by it, one inside, one past the row
    (2048, [2817, 2305, 300, 0]),
    # without a window a length past S_max sees the whole slice
    (None, [2817, 513, 300, 0])])
def test_decode_attention_past_the_slice(cuda, window, lens):
    """K3's contract for a query beyond its slice: it sees keys
    ``[max(0, length - window), min(length, S_max))``, with its log-sum-
    exp; an empty range gives 0 and -inf; at recurrentgemma-9b's heads
    (16/1 of 256) against the plain version."""
    _check_decode_lse(cuda, 4, 512, lens, 16, 1, 256, 256,
                      dict(atol=2e-2, rtol=2e-2), window=window)


def _check_decode_lse(cuda, b, s_max, lens, h, hkv, hd, hd_v,
                      out_tol=dict(atol=1e-3, rtol=2 ** -7), window=None):
    rng = np.random.default_rng(20)
    q = _bf16(rng, (b, h, hd), cuda)
    k = _bf16(rng, (b, s_max, hkv, hd), cuda)
    v = _bf16(rng, (b, s_max, hkv, hd_v), cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    serve = ops.decode_attention(q, k, v, lengths, window=window)
    got, lse = ops.decode_attention(q, k, v, lengths, window=window,
                                    return_lse=True)
    assert torch.equal(got, serve)
    want = ref.decode_attention_lse_ref(q, k, lengths, window=window)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(lse))
    # fp32, about ln of the keys seen: a 16-key tile missed among 1000
    # keys would move it by about 0.016
    torch.testing.assert_close(lse[fin], want[fin], atol=1e-4, rtol=0)
    assert (lse[~fin] < 0).all()
    empty = ~fin.any(-1)
    assert not got[empty].any()
    # bf16 against the plain version rounded to bf16: one ulp apart at most
    # at qwen3's widths
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(
        q, k, v, lengths, window=window).float(), **out_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 20, 150])
def test_prefill_attention_kernel_matches_plain(cuda, hd, h, hkv, window):
    """The wgmma prefill kernel against its plain version: P = 40 is no
    multiple of the 128-row tile at any group size; offsets put the end of
    the keys mid-tile and past the 128-key tile edge; S_max = 300 is no
    multiple of the key tile; the 150-key window crosses a tile edge; two
    launches give bit-identical outputs."""
    rng = np.random.default_rng(8)
    b, p, s_max = 4, 40, 300
    q = _bf16(rng, (b, p, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    off = torch.tensor([0, 50, 101, 260], dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, off, window=window)
    again = ops.prefill_attention(q, k, v, off, window=window)
    want = ref.prefill_attention_ref(q, k, v, off, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", [(128, 32, 4), (32, 8, 1)])
def test_prefill_attention_kernel_long_rows_and_no_cache_call(cuda, hd, h,
                                                              hkv):
    """Rows of many key tiles (the two-stage ring wraps several times),
    and the no-cache call of apply_gqa: S_max = P, offsets 0."""
    rng = np.random.default_rng(9)
    b, p, s_max = 3, 300, 1000
    q = _bf16(rng, (b, p, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    off = torch.tensor([0, 333, 700], dtype=torch.int32, device=cuda)
    for window in (None, 200):
        got = ops.prefill_attention(q, k, v, off, window=window)
        want = ref.prefill_attention_ref(q, k, v, off, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    kn = k[:, :p].contiguous()
    vn = v[:, :p].contiguous()
    zeros = torch.zeros(b, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, kn, vn, zeros)
    want = ref.prefill_attention_ref(q, kn, vn, zeros)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


# (hd, H, Hkv): group sizes that do not divide the kernel's 128 query
# rows (phi4-mini's 3, yi-34b's 7, and 5, 6), at hd 64 and 128
GROUP_SHAPES = [(64, 3, 1), (128, 24, 8), (64, 10, 2), (128, 5, 1),
                (64, 12, 2), (128, 6, 1), (64, 7, 1), (128, 56, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", GROUP_SHAPES)
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("p,offsets", [(40, (0, 50, 101, 260)),
                                       (5, (7, 127, 128, 295)),
                                       (130, (0, 3, 60, 170))])
def test_prefill_attention_kernel_at_any_group_size(cuda, hd, h, hkv, window,
                                                    p, offsets):
    """K2 where g does not divide 128: 128 // g positions per CTA, the
    rows past them padding.  P 40 and 130 span one and several q tiles;
    P 5 is the verify window (spec_k 4 plus the bonus token) at non-zero
    offsets, one across the 128-key tile edge; two launches agree."""
    rng = np.random.default_rng(13)
    b, s_max = 4, 300
    q = _bf16(rng, (b, p, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, off, window=window)
    again = ops.prefill_attention(q, k, v, off, window=window)
    want = ref.prefill_attention_ref(q, k, v, off, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)


# (H, P, offsets, lengths): multi-head latent attention's widths (dk 192 =
# 128 nope + 64 rope, dv 128) at H = Hkv: 4 heads (the decode kernel
# splits the keys), 128 heads (deepseek-v2-236b: one split); P 40 and 130
# span one and two q tiles, offsets past the 128-key tile edge
MLA_SHAPES = [(4, 40, (0, 50, 101, 170), (1, 301, 128, 17)),
              (4, 130, (0, 3, 60, 170), (300, 64, 129, 2)),
              (128, 40, (0, 77, 130, 260), (1, 300, 129, 257))]


@pytest.mark.cuda
@pytest.mark.parametrize("h,p,offsets,lens", MLA_SHAPES)
@pytest.mark.parametrize("window", [None, 70])
def test_attention_kernels_at_mla_widths_match_plain(cuda, h, p, offsets,
                                                     lens, window):
    """K2 and K3 at (dk, dv) = (192, 128): output width dv, scale
    1/sqrt(192), against their plain versions; two launches agree bit for
    bit (a stale length S_max + 1 included)."""
    rng = np.random.default_rng(15)
    b, s_max = 4, 300
    q = _bf16(rng, (b, p, h, 192), cuda)
    k, v = _bf16(rng, (b, s_max, h, 192), cuda), _bf16(rng, (b, s_max, h, 128), cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, off, window=window)
    want = ref.prefill_attention_ref(q, k, v, off, window=window)
    assert got.shape == (b, p, h, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.prefill_attention(q, k, v, off, window=window))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q1 = q[:, 0].contiguous()
    got = ops.decode_attention(q1, k, v, lengths, window=window)
    want = ref.decode_attention_ref(q1, k, v, lengths, window=window)
    assert got.shape == (b, h, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.decode_attention(q1, k, v, lengths,
                                                 window=window))


# recurrentgemma-9b's local attention: (dk, dv) = (256, 256); g 16 (its
# 16/1 heads: two n-tiles in K3) and g 4; P 40 and 130 span five and
# seventeen q tiles of 8 positions at g 16, offsets past the 64-key tile
# edge; a stale length S_max + 1
HD256_SHAPES = [(16, 1, 40, (0, 50, 101, 170), (1, 301, 128, 17)),
                (16, 1, 130, (0, 3, 60, 170), (300, 64, 129, 2)),
                (8, 2, 40, (0, 77, 130, 260), (1, 300, 129, 257))]


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,p,offsets,lens", HD256_SHAPES)
@pytest.mark.parametrize("window", [None, 70])
def test_attention_kernels_at_head_width_256_match_plain(cuda, h, hkv, p,
                                                         offsets, lens,
                                                         window):
    """K2 and K3 at (dk, dv) = (256, 256) against their plain versions;
    two launches agree bit for bit."""
    rng = np.random.default_rng(16)
    b, s_max = 4, 300
    q = _bf16(rng, (b, p, h, 256), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, 256), cuda), _bf16(rng, (b, s_max, hkv, 256), cuda)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, off, window=window)
    want = ref.prefill_attention_ref(q, k, v, off, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.prefill_attention(q, k, v, off, window=window))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q1 = q[:, 0].contiguous()
    got = ops.decode_attention(q1, k, v, lengths, window=window)
    want = ref.decode_attention_ref(q1, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.decode_attention(q1, k, v, lengths,
                                                 window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["rglru+local", "xlstm"])
def test_recurrent_engine_serves_on_the_card(cuda, which):
    """``chip_smoke``'s small recurrent models in bf16 through the engine,
    more requests than slots (every slot reused, its state reset at
    admission): every request completes; the RG-LRU model launches K2 and
    K3 at (256, 256) and nothing else, the xLSTM model none of the six
    kernels."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.models.model import DecoderModel
    from repro_torch.serving.engine import Engine
    cfg = _chip_smoke().small_recurrent_configs()[which]
    model = DecoderModel(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1))
    ops.reset_launches()
    sched = make_scheduler("layered", model.n_blocks, n_slots=2, quantum=16)
    eng = Engine(model, params, sched, n_slots=2, max_len=96,
                 prefix_cache=False)
    rng = np.random.default_rng(0)
    for _ in range(5):
        eng.submit(rng.integers(1, 500, int(rng.integers(4, 60))).tolist(), 6)
    eng.run()
    assert all(len(t) == 6 for t in eng.outputs.values())
    path = ("prefill_attention", "decode_attention") if which == 0 else ()
    assert all(ops.LAUNCHES[k] > 0 for k in path), ops.LAUNCHES
    assert all(n == 0 for k, n in ops.LAUNCHES.items() if k not in path), \
        ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("moe_dispatch", ["ragged", "dense"])
def test_mla_engine_serves_on_the_card(cuda, moe_dispatch):
    """``chip_smoke``'s small MLA model (a dense block 0, an MoE block 1
    with a shared expert; MLA's full head widths) in bf16 through the
    engine: every request completes, K2/K3 at (192, 128) and the
    dispatch's MoE kernel launch, nothing else does."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.models.model import DecoderModel
    from repro_torch.serving.engine import Engine
    model = DecoderModel(_chip_smoke().small_mla_config(), device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1))
    ops.reset_launches()
    sched = make_scheduler("layered", model.n_blocks, n_slots=4, quantum=16)
    eng = Engine(model, params, sched, n_slots=4, max_len=96,
                 moe_dispatch=moe_dispatch)
    rng = np.random.default_rng(0)
    for _ in range(5):
        eng.submit(rng.integers(1, 500, int(rng.integers(4, 40))).tolist(), 6)
    eng.run()
    assert all(len(t) == 6 for t in eng.outputs.values())
    path = PATH_KERNELS[moe_dispatch]
    assert all(ops.LAUNCHES[k] > 0 for k in path), ops.LAUNCHES
    assert all(n == 0 for k, n in ops.LAUNCHES.items() if k not in path), \
        ops.LAUNCHES


# (B, P, S_max, H, Hkv, hd): whisper-base's encoder (1500 frames over
# themselves) and cross-attention prefill (512 prompt tokens over 1500
# frames), both off K2's 128-row query tile and 128-key tile; g 8 at hd
# 128; g 2 at hd 32 over fewer keys than one tile; g 16 at hd 256 (64-key
# tiles)
NON_CAUSAL_SHAPES = [(1, 1500, 1500, 8, 8, 64), (4, 512, 1500, 8, 8, 64),
                     (3, 40, 300, 32, 4, 128), (2, 130, 77, 8, 4, 32),
                     (2, 70, 200, 16, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s_max,h,hkv,hd", NON_CAUSAL_SHAPES)
def test_prefill_attention_non_causal_matches_plain(cuda, b, p, s_max, h,
                                                    hkv, hd):
    """K2 with ``causal=False`` against its plain version: every query
    sees all S_max keys (the last key tile's keys past S_max are masked,
    not scored as zeros); offsets and a window change nothing; two
    launches agree bit for bit."""
    rng = np.random.default_rng(s_max + p)
    q = _bf16(rng, (b, p, h, hd), cuda)
    k = _bf16(rng, (b, s_max, hkv, hd), cuda)
    v = _bf16(rng, (b, s_max, hkv, hd), cuda)
    zeros = torch.zeros(b, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["prefill_attention"]
    got = ops.prefill_attention(q, k, v, zeros, causal=False)
    assert ops.LAUNCHES["prefill_attention"] == before + 1
    want = ref.prefill_attention_ref(q, k, v, zeros, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    off = torch.arange(b, dtype=torch.int32, device=cuda) * 7
    assert torch.equal(got, ops.prefill_attention(q, k, v, off, window=16,
                                                  causal=False))
    causal = ops.prefill_attention(q, k, v, zeros)
    assert not torch.equal(got, causal)


@pytest.mark.cuda
def test_decode_attention_over_1500_frames_matches_plain(cuda):
    """K3 at cross-attention decode: 8 slots, S_max = lengths = 1500 (24
    64-key tiles, the last of 28 keys), 8/8 heads of 64; two launches bit
    for bit; the same as K2 non-causal for one query."""
    rng = np.random.default_rng(1500)
    b, s_max, h, hd = 8, 1500, 8, 64
    q = _bf16(rng, (b, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, h, hd), cuda), _bf16(rng, (b, s_max, h, hd),
                                                      cuda)
    lengths = torch.full((b,), s_max, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.decode_attention(q, k, v, lengths))
    full = ref.prefill_attention_ref(q[:, None], k, v, lengths * 0,
                                     causal=False)[:, 0]
    torch.testing.assert_close(want.float(), full.float(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.cuda
def test_prefill_attention_non_causal_refuses_what_it_does_not_take(cuda):
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    bf = dict(dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="hd"):
        ops.prefill_attention(torch.zeros(1, 4, 8, 48, **bf),
                              torch.zeros(1, 8, 8, 48, **bf),
                              torch.zeros(1, 8, 8, 48, **bf), z, causal=False)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.prefill_attention(torch.zeros(1, 4, 8, 64, device=cuda),
                              torch.zeros(1, 8, 8, 64, device=cuda),
                              torch.zeros(1, 8, 8, 64, device=cuda), z,
                              causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["whisper", "qwen2-vl"])
def test_encdec_and_mrope_engines_serve_on_the_card(cuda, which):
    """``chip_smoke``'s small whisper model (frames seeded per request; a
    request without frames too) and small qwen2-vl model in bf16 through
    the engine, more requests than slots: every request completes, one
    cross-K/V install per admission, K2 and K3 launch and nothing else."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.models.model import DecoderModel
    from repro_torch.serving.engine import Engine
    cfg = _chip_smoke().small_encdec_configs()[which]
    model = DecoderModel(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1))
    ops.reset_launches()
    sched = make_scheduler("layered", model.n_blocks, n_slots=2, quantum=16)
    eng = Engine(model, params, sched, n_slots=2, max_len=96)
    rng = np.random.default_rng(0)
    for i in range(5):
        frames = None
        if cfg.encoder.enabled and i != 3:
            frames = (rng.normal(size=(cfg.encoder.n_frames, cfg.d_model))
                      * 0.01).astype(np.float32)
        eng.submit(rng.integers(1, 500, int(rng.integers(4, 60))).tolist(), 6,
                   frames)
    eng.run()
    assert all(len(t) == 6 for t in eng.outputs.values())
    assert eng.n_cross_installs == (5 if cfg.encoder.enabled else 0)
    path = ("prefill_attention", "decode_attention")
    assert all(ops.LAUNCHES[k] > 0 for k in path), ops.LAUNCHES
    assert all(n == 0 for k, n in ops.LAUNCHES.items() if k not in path), \
        ops.LAUNCHES


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_prefill_attention_at_g8_keeps_its_bits(cuda):
    """At a group size that divides 128 the repaired K2 gives the bits the
    kernel gave before it took every group size (a digest of its outputs
    on hashed inputs, taken from the earlier kernel)."""
    smoke = _chip_smoke()
    assert smoke.k2_g8_digest() == smoke.K2_G8_SHA256


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,hkv", [(128, 24, 8), (128, 56, 8),
                                      (64, 3, 1), (64, 14, 2)])
@pytest.mark.parametrize("window", [None, 70])
def test_decode_attention_kernel_at_groups_3_and_7(cuda, hd, h, hkv, window):
    """K3 at phi4-mini's (g 3) and yi-34b's (g 7) group sizes."""
    rng = np.random.default_rng(14)
    b, s_max = 8, 320
    q = _bf16(rng, (b, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    lengths = torch.tensor([1, s_max + 1, 64, 17, s_max, 129, 200, 300],
                           dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths, window=window)
    want = ref.decode_attention_ref(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, ops.decode_attention(q, k, v, lengths,
                                                 window=window))


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor the kernel does not take raises ValueError, never
    falls back: prefill needs (hd, hd_v) in (32, 32), (64, 64), (128,
    128), (192, 128), (256, 256) and a group size of at most 128 (any
    other group size it takes: g 3 runs); decode takes hd = hd_v a
    multiple of 16 up to 128, (192, 128) or (256, 256), and at most 16
    query heads per kv head.  Pairs that are not built, (192, 64) and
    (256, 128), are refused by both."""
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    bf = dict(dtype=torch.bfloat16, device=cuda)
    for hd in (48, 24, 160):
        with pytest.raises(ValueError, match="hd"):
            ops.prefill_attention(torch.zeros(1, 4, 8, hd, **bf),
                                  torch.zeros(1, 8, 2, hd, **bf),
                                  torch.zeros(1, 8, 2, hd, **bf), z)
    for hd in (24, 160):
        with pytest.raises(ValueError, match="hd"):
            ops.decode_attention(torch.zeros(1, 8, hd, **bf),
                                 torch.zeros(1, 8, 2, hd, **bf),
                                 torch.zeros(1, 8, 2, hd, **bf), z)
    with pytest.raises(ValueError, match="hd"):
        ops.prefill_attention(torch.zeros(1, 4, 2, 192, **bf),
                              torch.zeros(1, 8, 2, 192, **bf),
                              torch.zeros(1, 8, 2, 64, **bf), z)
    with pytest.raises(ValueError, match="hd"):
        ops.decode_attention(torch.zeros(1, 2, 192, **bf),
                             torch.zeros(1, 8, 2, 192, **bf),
                             torch.zeros(1, 8, 2, 64, **bf), z)
    with pytest.raises(ValueError, match="hd"):
        ops.prefill_attention(torch.zeros(1, 4, 2, 256, **bf),
                              torch.zeros(1, 8, 2, 256, **bf),
                              torch.zeros(1, 8, 2, 128, **bf), z)
    with pytest.raises(ValueError, match="hd"):
        ops.decode_attention(torch.zeros(1, 2, 256, **bf),
                             torch.zeros(1, 8, 2, 256, **bf),
                             torch.zeros(1, 8, 2, 128, **bf), z)
    with pytest.raises(ValueError, match="group size"):
        ops.prefill_attention(torch.zeros(1, 4, 256, 64, **bf),
                              torch.zeros(1, 8, 1, 64, **bf),
                              torch.zeros(1, 8, 1, 64, **bf), z)
    out = ops.prefill_attention(torch.zeros(1, 4, 3, 64, **bf),
                                torch.zeros(1, 8, 1, 64, **bf),
                                torch.zeros(1, 8, 1, 64, **bf), z)
    assert out.shape == (1, 4, 3, 64)
    with pytest.raises(ValueError, match="16 query heads"):
        ops.decode_attention(torch.zeros(1, 32, 64, **bf),
                             torch.zeros(1, 8, 1, 64, **bf),
                             torch.zeros(1, 8, 1, 64, **bf), z)


def _rel_fro(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(4, 8, 256, 128), (3, 130, 128, 64),
                                     (2, 13, 40, 100), (3, 300, 200, 40)])
def test_moe_gmm_kernel_matches_plain(cuda, e, c, d, f):
    """The dense SwiGLU at a decode-like C, a C past one 128-row tile, and
    C, d and F off every tile size (TMA zero-fills the edges; F 100 is
    padded to 104); two launches give bit-identical outputs."""
    rng = np.random.default_rng(2)
    args = (_bf16(rng, (e, c, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5))
    before = ops.LAUNCHES["moe_gmm"]
    padded = ops.PAD_COPIES["moe_gmm"]
    got = ops.moe_gmm(*args)
    again = ops.moe_gmm(*args)
    assert ops.LAUNCHES["moe_gmm"] == before + 2
    # d or F off a multiple of 8 takes the zero-padded copy
    assert ops.PAD_COPIES["moe_gmm"] == padded + 2 * bool(d % 8 or f % 8)
    assert got.shape == (e, c, d) and got.is_contiguous()
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    assert _rel_fro(got, ref.moe_gmm_ref(*args)) <= 1e-2


def _pool(rng, b, page, n_pages, max_pages, hkv, hd, dev, min_len=1,
          lengths=None):
    """K/V pages and block tables over SHUFFLED physical pages for ``b``
    sequences of the given ``lengths`` (else random in [min_len,
    max_pages * page], the first min_len); table entries past a
    sequence's pages are 0 padding."""
    if lengths is None:
        lengths = rng.integers(min_len, max_pages * page + 1, size=b)
        lengths[0] = min_len
    lengths = np.asarray(lengths)
    bt = np.zeros((b, max_pages), np.int32)
    perm, k = rng.permutation(n_pages), 0
    for i in range(b):
        n = -(-int(lengths[i]) // page)
        bt[i, :n] = perm[k:k + n]
        k += n
    assert k <= n_pages, "the pool is overcommitted"
    return (_bf16(rng, (n_pages, page, hkv, hd), dev),
            _bf16(rng, (n_pages, page, hkv, hd), dev),
            torch.from_numpy(bt).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def _check_paged(q, kp, vp, bt, lens, window):
    """The paged kernel on q (B, W, H, hd) against its plain version, and
    a second launch bit for bit (the splits merge in a fixed order);
    verify at W 1 is paged decode itself."""
    before = ops.LAUNCHES["paged_verify_attention"]
    got = ops.paged_verify_attention(q, kp, vp, bt, lens, window=window)
    again = ops.paged_verify_attention(q, kp, vp, bt, lens, window=window)
    assert ops.LAUNCHES["paged_verify_attention"] == before + 2
    want = ref.paged_verify_attention_ref(q, kp, vp, bt, lens, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(got, again)
    if q.shape[1] == 1:
        assert torch.equal(got[:, 0], ops.paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, bt, lens, window=window))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
def test_paged_attention_kernels_match_plain(cuda, window):
    rng = np.random.default_rng(3)
    b, h, hkv, hd, page, max_pages = 4, 32, 4, 128, 16, 6
    kp, vp, bt, lens = _pool(rng, b, page, 40, max_pages, hkv, hd, cuda)
    q = _bf16(rng, (b, h, hd), cuda)
    got = ops.paged_decode_attention(q, kp, vp, bt, lens, window=window)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    for w in (1, 4, 5):
        kp, vp, bt, lens = _pool(rng, b, page, 40, max_pages, hkv, hd, cuda,
                                 min_len=w)
        qw = _bf16(rng, (b, w, h, hd), cuda)
        got = ops.paged_verify_attention(qw, kp, vp, bt, lens, window=window)
        want = ref.paged_verify_attention_ref(qw, kp, vp, bt, lens,
                                              window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        if w == 1:
            assert torch.equal(got[:, 0], ops.paged_decode_attention(
                qw[:, 0].contiguous(), kp, vp, bt, lens, window=window))


# the CPU tests' sweeps (tests/test_torch_kernels.py, from
# tests/test_kernels.py): (B, H, Hkv, hd, page_size, n_pages, max_pages)
PAGED_SWEEP = [
    (3, 4, 2, 64, 16, 24, 6),
    (2, 8, 1, 32, 8, 40, 10),      # MQA, small pages
    (1, 4, 4, 128, 32, 8, 4),      # MHA
    (4, 4, 2, 64, 16, 20, 4),      # tight pool, short sequences
]
# (B, W, H, Hkv, hd, page_size, n_pages, max_pages)
VERIFY_SWEEP = [
    (3, 3, 4, 2, 64, 16, 24, 6),
    (2, 5, 8, 1, 32, 8, 40, 10),
    (1, 2, 4, 4, 128, 32, 8, 4),
    (4, 4, 4, 2, 64, 16, 20, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("b,h,hkv,hd,page,npages,maxp", PAGED_SWEEP)
def test_paged_decode_kernel_matches_plain_sweep(cuda, b, h, hkv, hd, page,
                                                 npages, maxp, window):
    rng = np.random.default_rng(b * hd + page)
    kp, vp, bt, lens = _pool(rng, b, page, npages, maxp, hkv, hd, cuda)
    q = _bf16(rng, (b, 1, h, hd), cuda)
    _check_paged(q, kp, vp, bt, lens, window)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("b,w,h,hkv,hd,page,npages,maxp", VERIFY_SWEEP)
def test_paged_verify_kernel_matches_plain_sweep(cuda, b, w, h, hkv, hd, page,
                                                 npages, maxp, window):
    rng = np.random.default_rng(b * hd + w)
    kp, vp, bt, lens = _pool(rng, b, page, npages, maxp, hkv, hd, cuda,
                             min_len=w)
    _check_paged(_bf16(rng, (b, w, h, hd), cuda), kp, vp, bt, lens, window)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("w", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("g,hkv,hd", [(1, 4, 64), (2, 2, 32), (8, 4, 128),
                                      (16, 1, 128)])
def test_paged_kernel_over_groups_windows_and_pages(cuda, g, hkv, hd, w, page):
    """Group sizes 1-16 and windows W 1-8 (W * g from 1 to 128 query rows:
    one to eight row blocks, the last one partial), page sizes 8-32, over
    320 keys a sequence split several ways: lengths of 1 (the window rows
    before the first key see none and output 0), of W, of exactly
    max_pages * page_size and in between; no window and a 24-key one."""
    rng = np.random.default_rng(100 * g + 10 * w + page)
    b, max_pages = 5, 320 // page
    assert ops.paged_split(b, hkv, ops.paged_row_blocks(w, g), max_pages,
                           page) > 1
    lens = [1, w, max_pages * page, 133, 200]
    kp, vp, bt, lengths = _pool(rng, b, page, b * max_pages + 3, max_pages,
                                hkv, hd, cuda, lengths=lens)
    q = _bf16(rng, (b, w, g * hkv, hd), cuda)
    for window in (None, 24):
        got = _check_paged(q, kp, vp, bt, lengths, window)
        # of a 1-token sequence only the newest window row sees a key
        assert not got[0, :w - 1].any() and got[0, w - 1].any()


@pytest.mark.cuda
def test_paged_attention_unsplit_shape(cuda):
    """One 64-key tile per sequence: split 1, the kernel alone writes the
    output (no merge launch, no scratch)."""
    rng = np.random.default_rng(8)
    b, h, hkv, hd, page, max_pages = 4, 8, 1, 64, 16, 4
    assert ops.paged_split(b, hkv, 1, max_pages, page) == 1
    kp, vp, bt, lens = _pool(rng, b, page, 16, max_pages, hkv, hd, cuda,
                             lengths=[1, 17, 40, 64])
    _check_paged(_bf16(rng, (b, 1, h, hd), cuda), kp, vp, bt, lens, None)


@pytest.mark.cuda
def test_paged_verify_wide_window_matches_plain(cuda):
    """W 64 at g 8: 512 query rows a kv head in 32 row blocks; the kernel
    has no shared-memory limit on the window."""
    rng = np.random.default_rng(5)
    kp, vp, bt, lens = _pool(rng, 2, 16, 16, 8, 4, 128, cuda, min_len=64)
    _check_paged(_bf16(rng, (2, 64, 32, 128), cuda), kp, vp, bt, lens, None)


@pytest.mark.cuda
def test_paged_attention_refuses_head_dim_24(cuda):
    """hd off a multiple of 16 raises ValueError on the card, never falls
    back to the plain version."""
    rng = np.random.default_rng(9)
    kp, vp, bt, lens = _pool(rng, 2, 16, 8, 4, 2, 24, cuda)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="hd"):
        ops.paged_decode_attention(_bf16(rng, (2, 4, 24), cuda), kp, vp, bt,
                                   lens)
    with pytest.raises(ValueError, match="hd"):
        ops.paged_verify_attention(_bf16(rng, (2, 3, 4, 24), cuda), kp, vp,
                                   bt, lens)
    assert ops.LAUNCHES == before


@pytest.mark.cuda
def test_paged_attention_length_zero_outputs_zero(cuda):
    rng = np.random.default_rng(4)
    kp, vp, bt, lens = _pool(rng, 2, 16, 8, 4, 2, 64, cuda)
    lens[0] = 0
    out = ops.paged_decode_attention(_bf16(rng, (2, 4, 64), cuda), kp, vp, bt,
                                     lens)
    assert not out[0].any() and out[1].any()


@pytest.mark.cuda
def test_kernels_refuse_float32_on_the_card(cuda):
    q = torch.zeros(1, 2, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        ops.prefill_attention(q, k, k, torch.zeros(1, dtype=torch.int32,
                                                   device=cuda))


# the kernels each MoE dispatch's serve launches; the paged kernels are
# on no serve path
PATH_KERNELS = {"ragged": ("moe_gmm_ragged", "prefill_attention",
                           "decode_attention"),
                "dense": ("moe_gmm", "prefill_attention", "decode_attention")}


@pytest.mark.cuda
@pytest.mark.parametrize("moe_dispatch", ["ragged", "dense"])
def test_engine_serves_on_the_card(cuda, moe_dispatch):
    """The reduced qwen3 model in bf16 through the port's launcher on the
    card: every request completes, every kernel of the dispatch's path
    launches and no other kernel does."""
    from repro_torch.launch.serve import ServeConfig, serve_real
    ops.reset_launches()
    r = serve_real(ServeConfig(smoke=True, dtype="bfloat16", requests=3,
                               slots=8, max_len=128, quantum=32,
                               token_budget=32, moe_dispatch=moe_dispatch))
    assert r["completed"] == r["requests"] == 3
    path = PATH_KERNELS[moe_dispatch]
    assert all(ops.LAUNCHES[k] > 0 for k in path), ops.LAUNCHES
    assert all(n == 0 for k, n in ops.LAUNCHES.items() if k not in path), \
        ops.LAUNCHES


@pytest.mark.cuda
def test_engine_preempts_on_the_card(cuda):
    """A pool too small for the trace forces recompute preemption (and
    the boundary-stash regather) on the card; every request still gets
    all its tokens."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.launch.serve import ServeConfig, build_model
    from repro_torch.serving.engine import Engine
    model, params = build_model(ServeConfig(smoke=True, dtype="bfloat16"))
    sched = make_scheduler("layered", model.n_blocks, n_slots=4, quantum=8)
    # 28 four-token pages: the schedule (not the token values) decides
    # the pressure, and it evicts once for this trace
    eng = Engine(model, params, sched, n_slots=4, max_len=64, pages=28,
                 page_size=4, decode_reserve=1)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(1, 500, int(rng.integers(4, 24))).tolist(), 8)
    eng.run()
    assert eng.n_preempted > 0
    assert all(len(t) == 8 for t in eng.outputs.values())
    assert eng.alloc.pages_in_use() == 0


@pytest.mark.cuda
def test_disagg_pools_serve_on_the_card(cuda):
    """The reduced qwen3 model in bf16 as two pools over one copy of the
    weights on the card: streaming and whole-prompt handoff give the same
    token streams; the prefill pool launches K1 and K2 and no K3, the
    decode pool K1 and K3 and no K2, and neither launches anything else."""
    from repro_torch.launch.serve import (ServeConfig, build_disagg_engines,
                                          build_model, run_disagg)
    a = ServeConfig(smoke=True, dtype="bfloat16", requests=4, slots=8,
                    max_len=128, quantum=32, token_budget=32, disagg=True)
    model, params = build_model(a)
    streams = {}
    for handoff in ("stream", "whole"):
        a = dataclasses.replace(a, handoff=handoff)
        ep, ed = build_disagg_engines(a, model, params)
        per_pool = {}
        for tag, eng in (("prefill", ep), ("decode", ed)):
            counts = per_pool[tag] = collections.Counter()

            def execute_plan(plan, _execute=eng.execute_plan, _counts=counts):
                before = dict(ops.LAUNCHES)
                events = _execute(plan)
                _counts.update({k: v - before[k]
                                for k, v in ops.LAUNCHES.items()})
                return events
            eng.execute_plan = execute_plan
        r = run_disagg(ep, ed, a)
        assert r["completed"] == r["requests"] == 4
        assert r["decode_prefill_slices"] == 0 and r["n_migrations"] == 4
        assert r["pages_left"] == r["host_pages_left"] == 0
        for tag, want in (("prefill", {"moe_gmm_ragged", "prefill_attention"}),
                          ("decode", {"moe_gmm_ragged", "decode_attention"})):
            launched = {k for k, v in per_pool[tag].items() if v}
            assert launched == want, (tag, per_pool[tag])
        streams[handoff] = r["outputs"]
    assert streams["stream"] == streams["whole"]


# gpt-oss-20b's expert widths: E 32, d = F = 2880 (45 tiles of 64
# columns, not a multiple of the 128-column d-tile)
GPT_OSS_E, GPT_OSS_D = 32, 2880


@pytest.mark.cuda
@pytest.mark.parametrize("m_blk,counts", [
    (8, [3, 0, 9, 1] + [0] * 27 + [2]),
    (128, [200, 0, 31, 1, 0, 129] + [0] * 25 + [64])])
def test_moe_gmm_ragged_kernel_at_gpt_oss_widths(cuda, m_blk, counts):
    """K1 at gpt-oss-20b's widths, at a decode and a prefill tile height,
    against its plain version; no padded copy is taken."""
    e, d = GPT_OSS_E, GPT_OSS_D
    n_rows, te = _ragged_layout(e, m_blk, counts)
    rng = np.random.default_rng(11)
    args = (_bf16(rng, (n_rows, d), cuda), _bf16(rng, (e, d, d), cuda, d ** -0.5),
            _bf16(rng, (e, d, d), cuda, d ** -0.5),
            _bf16(rng, (e, d, d), cuda, d ** -0.5),
            torch.from_numpy(te).to(cuda), m_blk)
    got = ops.moe_gmm_ragged(*args)
    assert torch.equal(got, ops.moe_gmm_ragged(*args))
    sentinel = torch.from_numpy(te == e).to(cuda).repeat_interleave(m_blk)
    assert not got[sentinel].any()
    assert _rel_fro(got, ref.moe_gmm_ragged_ref(*args)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 200])
def test_moe_gmm_kernel_at_gpt_oss_widths(cuda, c):
    """K4 at gpt-oss-20b's widths (2880 % 8 == 0: no padded copy)."""
    e, d = GPT_OSS_E, GPT_OSS_D
    rng = np.random.default_rng(12)
    args = (_bf16(rng, (e, c, d), cuda), _bf16(rng, (e, d, d), cuda, d ** -0.5),
            _bf16(rng, (e, d, d), cuda, d ** -0.5),
            _bf16(rng, (e, d, d), cuda, d ** -0.5))
    padded = ops.PAD_COPIES["moe_gmm"]
    got = ops.moe_gmm(*args)
    assert ops.PAD_COPIES["moe_gmm"] == padded
    assert torch.equal(got, ops.moe_gmm(*args))
    assert _rel_fro(got, ref.moe_gmm_ref(*args)) <= 1e-2


@pytest.mark.cuda
def test_engine_swaps_on_the_card(cuda):
    """Swap preemption on the card: victims' rows go to pinned host memory
    and come back; every victim is swapped back in and every request gets
    all its tokens, with no page left in either pool."""
    from repro_torch.launch.serve import ServeConfig, serve_real
    sc = ServeConfig(smoke=True, dtype="bfloat16", requests=12, slots=4,
                     max_len=64, quantum=8, token_budget=16, pages=16,
                     page_size=4, decode_reserve=1, preemption="swap",
                     prompt_len=(4, 10), new_tokens=(12, 13))
    r = serve_real(sc)
    assert r["n_swapped_out"] == r["n_swapped_in"] > 0
    assert r["completed"] == r["requests"] == 12
    assert all(len(t) == 12 for t in r["outputs"].values())


@pytest.mark.cuda
def test_engine_prefix_hits_on_the_card(cuda):
    """Prefix caching on the card: a shared-prefix trace hits, restores
    cached rows into fresh slots, and every request completes."""
    from repro_torch.launch.serve import ServeConfig, serve_real
    from repro_torch.serving.traffic import shared_prefix_trace
    sc = ServeConfig(smoke=True, dtype="bfloat16", requests=8, slots=4,
                     max_len=128, quantum=16, token_budget=64, page_size=4,
                     open_loop=True)
    trace = shared_prefix_trace(8, n_prefixes=2, prefix_len=40,
                                suffix_len=6, output_len=4, rate=0.5,
                                vocab_size=500, seed=1)
    r = serve_real(sc, trace=trace)
    assert r["n_prefix_hits"] > 0 and r["n_prefix_restores"] > 0
    assert r["completed"] == r["requests"] == 8
    assert all(len(t) == 4 for t in r["outputs"].values())


def _serve_counting_syncs(run):
    """``run()`` with torch's sync debug mode on: (its result, the
    synchronizing calls it made, as "file:line" sites)."""
    import warnings
    from pathlib import Path
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_engine_speculates_on_the_card(cuda, spec):
    """Speculative verify-k decoding on the card, through the launcher:
    the n-gram drafter on repetitive prompts, or the smoke qwen3 drafting
    for itself (built by name, in bf16); every request completes, verify
    windows launch K2, and each iteration makes at most one host sync."""
    from repro_torch.launch.serve import (ServeConfig, build_engine,
                                          build_model)
    sc = ServeConfig(smoke=True, dtype="bfloat16", slots=4, max_len=128,
                     quantum=32, token_budget=32, spec=spec, spec_k=4,
                     draft_config="qwen3-30b-a3b", seed=1)
    model, params = build_model(sc)
    eng = build_engine(sc, model, params)
    for p in ([7, 8, 9, 10] * 6, [3, 4] * 9, [5, 6, 7, 5, 6, 7, 5, 6] * 2):
        eng.submit(p, 12)
    torch.cuda.synchronize()
    ops.reset_launches()
    _, syncs = _serve_counting_syncs(lambda: eng.run(max_iterations=1000))
    assert all(len(toks) == 12 for toks in eng.outputs.values())
    assert eng.n_verify_dispatches > 0 and eng.n_spec_proposed > 0
    assert ops.LAUNCHES["prefill_attention"] > 0
    # one .cpu() per iteration, plus at most one that torch makes once in
    # a process (its first serve under the sync debug mode)
    assert len(syncs) <= eng.iteration + 1, (syncs, eng.iteration)
    assert sum(s.startswith("engine.py") for s in syncs) <= eng.iteration, \
        syncs
    if spec == "draft":
        assert eng.draft_model.cfg.dtype == "bfloat16"
        assert eng.n_draft_dispatches > 0
        assert eng.n_spec_accepted > 0


@pytest.mark.cuda
def test_live_server_on_the_card(cuda):
    """The reduced qwen3 model in bf16 behind the port's HTTP/SSE server on
    the card, the engine on its own thread: every request is answered 200
    with all its tokens, the serve launches K1, K2 and K3 and nothing else,
    and a replay of the server's admission log plans what the live run
    planned and gives its bf16 streams bit for bit."""
    import asyncio
    from repro_torch.launch import load_gen
    from repro_torch.launch.serve import ServeConfig, build_model, build_server
    a = ServeConfig(smoke=True, dtype="bfloat16", requests=6, slots=8,
                    max_len=128, quantum=32, token_budget=32, http=":0")
    model, params = build_model(a)
    srv = build_server(a, model, params, record_plans=True)
    trace = a.engine_trace(model.cfg.vocab_size)

    async def go():
        await srv.start()
        try:
            return await load_gen.run_load(srv.host, srv.port, trace, 3)
        finally:
            await srv.stop()
    ops.reset_launches()
    report = asyncio.run(go())
    launched = {k for k, v in ops.LAUNCHES.items() if v}
    assert all(r.status == 200 for r in report.results)
    assert all(len(r.tokens) == trace[r.index].output_len
               for r in report.results)
    assert launched == set(PATH_KERNELS["ragged"]), ops.LAUNCHES
    assert srv.engine.alloc.pages_in_use() == 0
    replay = load_gen.replay_admissions(a, srv.admission_log, model, params)
    live_plans = [load_gen.plan_key(p) for p in srv.runtime.plans]
    assert load_gen.check_admission_replay(live_plans, srv.engine.outputs,
                                           replay) == 0


@pytest.mark.cuda
def test_per_slice_prefill_on_the_card(cuda):
    """``packed=False`` on the card: the same plans as the packed path,
    more launches, every request complete, K1/K2/K3 only."""
    from repro_torch.launch.load_gen import plan_key
    from repro_torch.launch.serve import (ServeConfig, build_engine,
                                          build_model, run_engine)
    a = ServeConfig(smoke=True, dtype="bfloat16", requests=4, slots=8,
                    max_len=128, quantum=32, token_budget=32)
    model, params = build_model(a)
    out = {}
    for packed in (True, False):
        eng = build_engine(dataclasses.replace(a, packed=packed), model,
                           params)
        plans, execute = [], eng.execute_plan

        def execute_plan(plan, _execute=execute, _plans=plans):
            _plans.append(plan_key(plan))
            return _execute(plan)
        eng.execute_plan = execute_plan
        ops.reset_launches()
        r = run_engine(eng, a)
        assert r["completed"] == r["requests"] == 4
        assert {k for k, v in ops.LAUNCHES.items() if v} \
            == set(PATH_KERNELS["ragged"]), ops.LAUNCHES
        out[packed] = (plans, eng.n_dispatches)
    assert out[True][0] == out[False][0]
    assert out[False][1] > out[True][1]


# ------------------------------------------------ training: the backwards
# Tolerances: bf16 inputs against the fp32 plain backward versions on the
# same inputs, relative Frobenius per gradient within 2e-2 (the kernels
# round P and dS, or H, dG and dU, to bf16 for the tensor cores, and every
# gradient to bf16) and two launches bit for bit.

BWD_TOL = 2e-2


def _attn_bwd_inputs(rng, dev, b, p, s_max, h, hkv, hd, hd_v=None):
    hd_v = hd_v or hd
    q = _bf16(rng, (b, p, h, hd), dev)
    k = _bf16(rng, (b, s_max, hkv, hd), dev)
    v = _bf16(rng, (b, s_max, hkv, hd_v), dev)
    do = _bf16(rng, (b, p, h, hd_v), dev)
    return q, k, v, do


# (B, P, S_max, H, Hkv, hd, hd_v, offsets, window, causal): every (hd,
# hd_v) pair of ops.PREFILL_HEAD_DIMS, causal without and with a window
# that binds, through a cache at offsets, and non-causal with S_max past P
# and off the kernels' 128-, 64- and 32-key tiles (1500 = 11 x 128 + 92 =
# 23 x 64 + 28, 75 = 64 + 11 = 2 x 32 + 11)
ATTN_BWD_CASES = {
    "minicpm_g1": (2, 256, 256, 4, 4, 64, 64, (0, 0), None, True),
    "qwen3_g8": (1, 256, 256, 16, 2, 128, 128, (0,), None, True),
    "tiles_off_p_g3": (1, 300, 300, 3, 1, 64, 64, (0,), None, True),
    "offsets_128": (2, 40, 100, 6, 2, 128, 128, (0, 37), None, True),
    "hd32": (2, 100, 100, 4, 2, 32, 32, (0, 0), None, True),
    "hd32_window": (2, 100, 100, 16, 1, 32, 32, (0, 0), 9, True),
    "window_64": (2, 70, 70, 4, 2, 64, 64, (0, 0), 17, True),
    "window_128_offsets": (2, 64, 200, 8, 2, 128, 128, (30, 136), 50, True),
    "mla": (2, 96, 96, 4, 4, 192, 128, (0, 0), None, True),
    "mla_offsets": (2, 40, 130, 2, 2, 192, 128, (5, 90), None, True),
    "hd256_g16_window": (2, 160, 160, 16, 1, 256, 256, (0, 0), 40, True),
    "hd256_window_offsets": (2, 64, 300, 16, 1, 256, 256, (100, 236), 90,
                             True),
    "cross_1500": (2, 37, 1500, 8, 8, 64, 64, (0, 0), None, False),
    "encoder_self": (1, 100, 100, 4, 4, 64, 64, (0,), None, False),
    "cross_hd32": (2, 40, 75, 4, 2, 32, 32, (0, 0), None, False),
    "cross_128": (1, 50, 75, 4, 1, 128, 128, (0,), None, False),
    "cross_mla": (2, 20, 75, 2, 2, 192, 128, (0, 0), None, False),
    "cross_hd256": (2, 33, 75, 4, 2, 256, 256, (0, 0), None, False),
    # the dK/dV pass's head-group split (ops.bwd_split): recurrentgemma's
    # one kv head under a window (16 groups), a qwen3-like training shape
    # (8), g 3 over offsets, (192, 128) at g 4; and a grid that fills the
    # card unsplit at g 2
    "split_hd256_g16": (2, 256, 256, 16, 1, 256, 256, (0, 0), 64, True),
    "split_qwen3_like": (2, 256, 256, 8, 4, 128, 128, (0, 0), None, True),
    "split_g3_offsets": (2, 130, 300, 6, 2, 64, 64, (0, 100), None, True),
    "split_mla_g4": (1, 100, 100, 8, 2, 192, 128, (0,), None, True),
    "unsplit_g2": (3, 2048, 2048, 6, 3, 64, 64, (0, 0, 0), None, True),
}


def _bwd_into(q, k, v, out, lse, do, off, window, causal, pad):
    """The backward through the C entry point with dK and dV written into
    buffers of ``pad`` rows past the last (b, S_max) row, filled with a
    sentinel: returns (dq, dk, dv, whether the tails are untouched)."""
    b, p, h, dk_w = q.shape
    s_max, hkv, dv_w = k.shape[1], k.shape[2], v.shape[3]
    fill = dict(dtype=torch.bfloat16, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.full((b * s_max + pad, hkv, dk_w), 7.0, **fill)
    dv = torch.full((b * s_max + pad, hkv, dv_w), 7.0, **fill)
    ops.launch_prefill_bwd(q, k, v, out, lse, do, off, dq, dk, dv,
                           window=window, causal=causal)
    n = b * s_max
    kept = bool((dk[n:] == 7.0).all()) and bool((dv[n:] == 7.0).all())
    return dq, dk[:n].reshape(k.shape), dv[:n].reshape(v.shape), kept


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ATTN_BWD_CASES))
def test_prefill_attention_bwd_kernel_matches_plain(cuda, case):
    """The forward's log-sum-exp and the backward against the
    plain versions at every contract the forward takes; keys no query
    sees get zero gradients; nothing is written at or past S_max; two
    calls give the same bits."""
    b, p, s_max, h, hkv, hd, hd_v, offsets, window, causal = \
        ATTN_BWD_CASES[case]
    rng = np.random.default_rng(p + h + hd)
    q, k, v, do = _attn_bwd_inputs(rng, cuda, b, p, s_max, h, hkv, hd, hd_v)
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    kw = dict(window=window, causal=causal)
    out, lse = ops._prefill_forward(q, k, v, off, window, causal, True)
    assert torch.equal(out, ops.prefill_attention(q, k, v, off, **kw))
    want_lse = ref.prefill_attention_lse_ref(q, k, v, off, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    before = ops.LAUNCHES["prefill_attention_bwd"]
    got = ops.prefill_attention_bwd(q, k, v, out, lse, do, off, **kw)
    again = ops.prefill_attention_bwd(q, k, v, out, lse, do, off, **kw)
    assert ops.LAUNCHES["prefill_attention_bwd"] == before + 2
    # the grid the C entry reports launching: the host's split, and one
    # wave of dK/dV CTAs wherever the query heads allow it
    grid = ops.GRIDS["prefill_attention_bwd"]
    split = ops.bwd_split(b, hkv, h // hkv, s_max, hd)
    assert grid["split"] == split and (grid["reduce"] > 0) == (split > 1)
    assert grid["dkdv"] >= min(132, grid["dkdv"] // split * (h // hkv))
    assert grid["dq"] == -(-p // 128) * h * b
    want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, off, **kw)
    for name, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, want):
        assert g_.dtype == torch.bfloat16 and torch.equal(g_, a_), name
        assert torch.isfinite(g_.float()).all(), name
        assert _rel_fro(g_, w_) <= BWD_TOL, (name, _rel_fro(g_, w_))
    seen = ref._prefill_visible(q, k, off, window, causal).any(dim=1)
    assert (got[1][~seen] == 0).all() and (got[2][~seen] == 0).all()
    *into, tails_kept = _bwd_into(q, k, v, out, lse, do, off, window,
                                  causal, pad=64)
    assert tails_kept, "a dK/dV row at or past S_max was written"
    for g_, i_ in zip(got, into):
        assert torch.equal(g_, i_)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hd_v,kw", [(64, 64, dict(window=16)),
                                        (64, 64, dict(causal=False)),
                                        (32, 32, {}), (192, 128, {})],
                         ids=["window", "non_causal", "hd32", "mla"])
def test_prefill_attention_under_grad_runs_its_backward_kernel(cuda, hd,
                                                               hd_v, kw):
    """Under grad mode K2 at a window, ``causal=False``, hd 32 and (192,
    128) — the contracts whose backward was refused before it took them —
    launches the forward and the backward kernel and gives the gradients
    ``torch.autograd`` takes through the plain forward."""
    rng = np.random.default_rng(hd + len(kw))
    q, k, v, do = _attn_bwd_inputs(rng, cuda, 1, 40, 40, 4, 2, hd, hd_v)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    grads = torch.autograd.grad(ops.prefill_attention(*leaves, z, **kw),
                                leaves, do)
    assert ops.LAUNCHES["prefill_attention"] == 1
    assert ops.LAUNCHES["prefill_attention_bwd"] == 1
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(ref.prefill_attention_ref(*leaves, z, **kw),
                               leaves, do)
    for name, g_, w_ in zip(("dq", "dk", "dv"), grads, want):
        assert g_.shape == w_.shape and g_.dtype == torch.bfloat16, name
        assert _rel_fro(g_, w_) <= BWD_TOL, (name, _rel_fro(g_, w_))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(4, 40, 128, 64), (3, 7, 64, 192),
                                     (2, 130, 256, 96), (2, 160, 256, 128),
                                     (3, 1, 128, 64), (2, 9, 60, 20)])
def test_moe_gmm_bwd_kernel_matches_plain(cuda, e, c, d, f):
    """The four-launch backward against its plain version, at C off the
    row tiles (130 and 160: one tile of three warpgroups, 192 rows; 1: an
    8-row tile) and, last, d and F off a multiple of 8 (the padded
    operands, grads sliced back); two calls give the same bits."""
    rng = np.random.default_rng(c + d)
    args = (_bf16(rng, (e, c, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5))
    dy = _bf16(rng, (e, c, d), cuda)
    before = ops.LAUNCHES["moe_gmm_bwd"]
    padded = ops.PAD_COPIES["moe_gmm_bwd"]
    got = ops.moe_gmm_bwd(*args, dy)
    again = ops.moe_gmm_bwd(*args, dy)
    assert ops.LAUNCHES["moe_gmm_bwd"] == before + 2
    assert ops.PAD_COPIES["moe_gmm_bwd"] == padded + 2 * bool(d % 8 or f % 8)
    grid = ops.GRIDS["moe_gmm_bwd"]
    assert grid["gate_up_dh"] > 0 and grid["dx"] > 0 and grid["row_tile"] >= 8
    for w in ("dwgu", "dwd"):
        assert 0 < grid[w] <= min(grid[f"{w}_tiles"], 132), (w, grid)
    want = ref.moe_gmm_bwd_ref(*args, dy)
    for name, g_, a_, w_, x_ in zip(("dx", "dwg", "dwu", "dwd"), got, again,
                                    want, args):
        assert g_.shape == x_.shape and g_.dtype == torch.bfloat16, name
        assert torch.equal(g_, a_), name
        assert _rel_fro(g_, w_) <= BWD_TOL, (name, _rel_fro(g_, w_))


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels(cuda):
    """Through ``torch.autograd`` the wrappers' Functions launch the
    backward kernels and give their gradients."""
    rng = np.random.default_rng(5)
    q, k, v, do = _attn_bwd_inputs(rng, cuda, 1, 64, 64, 4, 2, 64)
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    out = ops.prefill_attention(*leaves, z)
    grads = torch.autograd.grad(out, leaves, do)
    assert ops.LAUNCHES["prefill_attention"] == 1
    assert ops.LAUNCHES["prefill_attention_bwd"] == 1
    _, lse = ops._prefill_forward(q, k, v, z, None, True, True)
    for g_, w_ in zip(grads, ops.prefill_attention_bwd(q, k, v, out.detach(),
                                                       lse, do, z)):
        assert torch.equal(g_, w_)
    args = [_bf16(rng, s, cuda, 0.1) for s in ((2, 16, 64), (2, 64, 32),
                                                (2, 64, 32), (2, 32, 64))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    dy = _bf16(rng, (2, 16, 64), cuda)
    grads = torch.autograd.grad(ops.moe_gmm(*leaves), leaves, dy)
    assert ops.LAUNCHES["moe_gmm"] == 1 and ops.LAUNCHES["moe_gmm_bwd"] == 1
    for g_, w_ in zip(grads, ops.moe_gmm_bwd(*args, dy)):
        assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_kernels_without_backward_refuse_inputs_that_require_grad(cuda):
    """K1, K3, K5 and K6 raise rather than return an output autograd would
    take for a constant.  Without grad mode the same calls run."""
    bf = dict(dtype=torch.bfloat16, device=cuda)
    lens = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    q3 = torch.zeros(1, 4, 64, **bf, requires_grad=True)
    kc = torch.zeros(1, 8, 2, 64, **bf)
    with pytest.raises(RuntimeError, match="decode_attention.*no backward"):
        ops.decode_attention(q3, kc, kc, lens)
    w = torch.zeros(2, 64, 64, **bf, requires_grad=True)
    rows = torch.zeros(16, 64, **bf)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="moe_gmm_ragged.*no backward"):
        ops.moe_gmm_ragged(rows, w, w, w, te, 8)
    pages = torch.zeros(4, 4, 2, 64, **bf)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="paged_decode_attention"):
        ops.paged_decode_attention(q3, pages, pages, bt, lens)
    with pytest.raises(RuntimeError, match="paged_verify_attention"):
        ops.paged_verify_attention(q3[:, None], pages, pages, bt, lens)
    with torch.no_grad():
        ops.decode_attention(q3, kc, kc, lens)
    torch.cuda.synchronize()


def _small_train_config(kind: str):
    """A small bf16 model of each attention the training path runs: GQA
    at hd 64 (dense, or MoE: 4 experts top-2, capacity-limited dense
    dispatch), MLA at its (192, 128) widths with MoE (deepseek-v2-236b's
    smoke variant), RG-LRU + local attention at recurrentgemma's 16/1
    heads of 256 with a window shorter than the sequence, and whisper's
    decoder with cross-attention over 150 frames (off K2's key tiles),
    fed seeded frames as its encoder output."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import (EncoderConfig, MLAConfig,
                                           ModelConfig, MoEConfig)
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    if kind in ("dense", "moe"):
        moe = kind == "moe"
        return ModelConfig(name="tiny", family="moe" if moe else "dense",
                           n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                           head_dim=64, d_ff=256, vocab_size=512,
                           max_seq_len=256,
                           moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64)
                           if moe else MoEConfig(), **bf).validate()
    if kind == "mla":
        cfg = get_smoke_config("deepseek-v2-236b")
        return dataclasses.replace(
            cfg, n_heads=4, n_kv_heads=4, head_dim=128,
            mla=MLAConfig(kv_lora_rank=128, q_lora_rank=64, qk_rope_dim=64,
                          qk_nope_dim=128, v_head_dim=128), **bf).validate()
    if kind == "local":
        return dataclasses.replace(
            get_smoke_config("recurrentgemma-9b"), n_heads=16, n_kv_heads=1,
            head_dim=256, local_window=24, **bf).validate()
    return dataclasses.replace(
        get_smoke_config("whisper-base"), head_dim=64,
        encoder=EncoderConfig(n_layers=2, n_frames=150), **bf).validate()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "moe", "mla", "local", "encdec"])
def test_small_model_trains_on_the_card(cuda, kind):
    """A small model (``_small_train_config``) takes three train steps in
    bf16 on the card: finite losses, K2 and its backward (and, with MoE,
    K4 and its backward) launched and nothing else, every weight matrix
    the loss reaches changed, and step 1's loss within 2e-2 relative of
    the same step in fp32 on the CPU (plain versions)."""
    from repro_torch.models.model import DecoderModel
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train import device_batch, make_train_step
    cfg = _small_train_config(kind)
    gpu = DecoderModel(cfg, device="cuda", remat=True)
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu_cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    cpu = DecoderModel(cpu_cfg, device="cpu")
    p_cpu = ops.tree_map(lambda a: a.float().cpu(), params)
    before = [x.clone() for x in topt.tree_leaves(params)]
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 64))
    host = (toks, np.roll(toks, -1, 1), np.ones((2, 64), bool))
    enc = cfg.encoder.enabled
    frames = torch.from_numpy(rng.normal(size=(
        2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)).bfloat16()

    def batch(model):
        out = device_batch(model, *host)
        if enc:
            out["enc_out"] = frames.to(model.device, out["enc_out"].dtype)
        return out
    opt = topt.adamw(lr=1e-3, total_steps=10, warmup=1)
    _, _, m_cpu = make_train_step(cpu, opt, enc)(
        p_cpu, opt.init(p_cpu), batch(cpu))
    step = make_train_step(gpu, opt, enc)
    state = opt.init(params)
    ops.reset_launches()
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch(gpu))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    assert abs(losses[0] - float(m_cpu["loss"])) <= 2e-2 * float(
        m_cpu["loss"])
    launched = {k for k, v in ops.LAUNCHES.items() if v}
    want = {"prefill_attention", "prefill_attention_bwd"}
    if cfg.moe.enabled:
        want |= {"moe_gmm", "moe_gmm_bwd"}
    assert launched == want, ops.LAUNCHES
    # every weight matrix moved (a norm's scale of 1.0 may not, stacked
    # over the blocks or not: three steps of lr 1e-3 stay within half a
    # bf16 ulp of 1.0, as they do under JAX); whisper's encoder takes no
    # step (the batch gives its output)
    from repro_torch.training.checkpoint import leaf_names
    for name, a, b in zip(leaf_names(params), topt.tree_leaves(params),
                          before):
        assert (name.endswith(("scale", "bias")) or name.startswith("encoder/")
                or not torch.equal(a, b)), name
