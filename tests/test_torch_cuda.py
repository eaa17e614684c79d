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
kernels round H to bf16 for the tensor cores)."""

from __future__ import annotations

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


@pytest.mark.cuda
@pytest.mark.parametrize("e,d,f,m_blk,counts", [
    (4, 256, 128, 8, [16, 0, 3, 1]), (8, 128, 256, 64, [64, 0, 0, 70, 0, 0, 0, 1])])
def test_moe_gmm_ragged_kernel_matches_plain(cuda, e, d, f, m_blk, counts):
    n_rows, te = _ragged_layout(e, m_blk, counts)
    rng = np.random.default_rng(0)
    args = (_bf16(rng, (n_rows, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5),
            torch.from_numpy(te).to(cuda), m_blk)
    before = ops.LAUNCHES["moe_gmm_ragged"]
    got = ops.moe_gmm_ragged(*args).float()
    assert ops.LAUNCHES["moe_gmm_ragged"] == before + 1
    want = ref.moe_gmm_ragged_ref(*args).float()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


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


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor the kernel does not take raises ValueError, never
    falls back: prefill needs hd in (32, 64, 128) and a group size that
    divides 128; decode takes at most 16 query heads per kv head."""
    z = torch.zeros(1, dtype=torch.int32, device=cuda)
    bf = dict(dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="hd"):
        ops.prefill_attention(torch.zeros(1, 4, 8, 48, **bf),
                              torch.zeros(1, 8, 2, 48, **bf),
                              torch.zeros(1, 8, 2, 48, **bf), z)
    with pytest.raises(ValueError, match="group size"):
        ops.prefill_attention(torch.zeros(1, 4, 12, 64, **bf),
                              torch.zeros(1, 8, 1, 64, **bf),
                              torch.zeros(1, 8, 1, 64, **bf), z)
    with pytest.raises(ValueError, match="16 query heads"):
        ops.decode_attention(torch.zeros(1, 32, 64, **bf),
                             torch.zeros(1, 8, 1, 64, **bf),
                             torch.zeros(1, 8, 1, 64, **bf), z)


def _rel_fro(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(4, 8, 256, 128), (3, 130, 128, 64),
                                     (2, 13, 40, 100)])
def test_moe_gmm_kernel_matches_plain(cuda, e, c, d, f):
    """The dense SwiGLU at a decode-like C, a C past one 128-row tile, and
    C, d and F off every tile size (the kernel masks the edges)."""
    rng = np.random.default_rng(2)
    args = (_bf16(rng, (e, c, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5))
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(*args)
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel_fro(got, ref.moe_gmm_ref(*args)) <= 1e-2


def _pool(rng, b, page, n_pages, max_pages, hkv, hd, dev, min_len=1):
    lengths = rng.integers(min_len, max_pages * page + 1, size=b)
    lengths[0] = min_len
    bt = np.zeros((b, max_pages), np.int32)
    perm, k = rng.permutation(n_pages), 0
    for i in range(b):
        n = -(-int(lengths[i]) // page)
        bt[i, :n] = perm[k:k + n]
        k += n
    return (_bf16(rng, (n_pages, page, hkv, hd), dev),
            _bf16(rng, (n_pages, page, hkv, hd), dev),
            torch.from_numpy(bt).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


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


@pytest.mark.cuda
def test_paged_verify_too_wide_a_window_raises(cuda):
    """W * g query rows beyond one block's shared memory fail the launch
    and raise; the kernel never caps W quietly, and the next launch runs."""
    rng = np.random.default_rng(5)
    kp, vp, bt, lens = _pool(rng, 2, 16, 16, 8, 4, 128, cuda, min_len=64)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.paged_verify_attention(_bf16(rng, (2, 64, 32, 128), cuda), kp, vp,
                                   bt, lens)
    # the refusal is not left behind for the next launch to report
    ops.paged_verify_attention(_bf16(rng, (2, 4, 32, 128), cuda), kp, vp, bt,
                               lens)
    torch.cuda.synchronize()


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
    from repro_torch.launch.serve import ServeArgs, serve_real
    ops.reset_launches()
    r = serve_real(ServeArgs(smoke=True, dtype="bfloat16", requests=3,
                             max_len=128, quantum=32, token_budget=32,
                             moe_dispatch=moe_dispatch))
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
    from repro_torch.launch.serve import ServeArgs, build_model
    from repro_torch.serving.engine import Engine
    model, params = build_model(ServeArgs(smoke=True, dtype="bfloat16"))
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
