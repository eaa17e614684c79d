"""The port's kernel layer against the JAX package, on the CPU in fp32.

For a CPU tensor each wrapper in ``repro_torch.kernels.ops`` runs its
kernel's plain PyTorch version; these tests hold those against the JAX
package's oracles (``repro.kernels.ref``), its Pallas kernels in interpret
mode and, for prefill attention with offsets, the model's own
``masked_attention`` — the same numpy inputs to both packages, over the
shape and window sweeps of tests/test_kernels.py (the dense SwiGLU, the
paged decode and the paged verify kernels included).  Tolerance: atol = rtol
= 1e-5 (summation order differs).  The hand-written kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=1e-5, rtol=1e-5)

# the JAX oracles, jitted: one compile per shape instead of one per op
flash_ref = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "window"))
decode_ref = jax.jit(jref.decode_attention_ref, static_argnames=("window",))
gmm_ref = jax.jit(jref.moe_gmm_ragged_ref, static_argnames=("m_blk",))
masked_attention = jax.jit(jattn.masked_attention,
                           static_argnames=("causal", "window"))


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K1

RAGGED_SWEEP = [
    # (E, d, f, m_blk, counts) — skewed loads, empty experts, sentinel tail
    (4, 64, 128, 8, [16, 0, 3, 1]),
    (8, 64, 256, 16, [64, 0, 0, 0, 0, 0, 0, 1]),
    (2, 64, 100, 128, [128, 128]),
    (4, 32, 64, 8, [0, 0, 0, 0]),
]


def _ragged_layout(e, m_blk, counts):
    padded = [-(-c // m_blk) * m_blk for c in counts]
    n_rows = sum(padded) + m_blk            # leave a sentinel tail tile
    te = []
    for ex, p_ in enumerate(padded):
        te += [ex] * (p_ // m_blk)
    te += [e] * ((n_rows - sum(padded)) // m_blk)
    return n_rows, np.asarray(te, np.int32)


@pytest.mark.parametrize("e,d,f,m_blk,counts", RAGGED_SWEEP)
def test_moe_gmm_ragged_plain_matches_jax(e, d, f, m_blk, counts):
    n_rows, te = _ragged_layout(e, m_blk, counts)
    rng = np.random.default_rng(e * d + m_blk)
    rows = _np(rng, (n_rows, d))
    wg = _np(rng, (e, d, f), d ** -0.5)
    wu = _np(rng, (e, d, f), d ** -0.5)
    wd = _np(rng, (e, f, d), f ** -0.5)
    got = ops.moe_gmm_ragged(_t(rows), _t(wg), _t(wu), _t(wd), _t(te), m_blk)
    want = gmm_ref(rows, wg, wu, wd, jnp.asarray(te), m_blk=m_blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.moe_gmm_ragged(rows, wg, wu, wd, jnp.asarray(te),
                                 m_blk=m_blk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    sentinel = np.repeat(te == e, m_blk)
    assert not got.numpy()[sentinel].any()          # sentinel tiles are zero


# ------------------------------------------------------------------ K2

FLASH_SWEEP = [
    # (B, S, H, Hkv, hd)
    (1, 128, 4, 4, 64),
    (2, 256, 4, 2, 64),
    (1, 384, 8, 1, 32),
    (2, 100, 4, 4, 64),
    (1, 257, 4, 2, 128),
]


@pytest.mark.parametrize("window", [None, 32, 128, 300])
@pytest.mark.parametrize("b,s,h,hkv,hd", FLASH_SWEEP)
def test_prefill_attention_at_offset_zero_matches_flash_ref(b, s, h, hkv, hd,
                                                            window):
    """Offset 0 over a cache of exactly S rows is the Pallas flash
    kernel's own contract (causal, optional sliding window)."""
    rng = np.random.default_rng(s * h + (window or 0))
    q, k, v = (_np(rng, (b, s, h, hd)), _np(rng, (b, s, hkv, hd)),
               _np(rng, (b, s, hkv, hd)))
    got = ops.prefill_attention(_t(q), _t(k), _t(v),
                                torch.zeros(b, dtype=torch.int32),
                                window=window)
    want = flash_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("p,s_max,window", [(16, 64, None), (32, 96, 24),
                                            (1024, 1536, None)])
def test_prefill_attention_with_offsets_matches_masked_attention(p, s_max,
                                                                 window):
    """Per-row offsets over the slot-row cache, with bucket padding: the
    masks ``apply_gqa`` builds (P >= 1024 takes the query-chunked path)."""
    b, h, hkv, hd = 3, 4, 2, 16
    rng = np.random.default_rng(p + s_max)
    q = _np(rng, (b, p, h, hd))
    k, v = _np(rng, (b, s_max, hkv, hd)), _np(rng, (b, s_max, hkv, hd))
    off = np.asarray([0, s_max - p - 5, s_max - p], np.int32)
    got = ops.prefill_attention(_t(q), _t(k), _t(v), _t(off), window=window)
    q_pos = off[:, None] + np.arange(p, dtype=np.int32)[None]
    kv_pos = np.arange(s_max, dtype=np.int32)
    kv_valid = kv_pos[None, :] < (off + p)[:, None]
    want = masked_attention(q, k, v, q_pos, kv_pos, kv_valid, causal=True,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_query_row_outputs_zero():
    """A row that sees no key (here: a window that excludes every cached
    key) outputs 0, not NaN, like attention.py's guard."""
    q, k, v = torch.randn(1, 4, 2, 8), torch.randn(1, 16, 1, 8), \
        torch.randn(1, 16, 1, 8)
    q_pos = torch.tensor([[20, 21, 22, 23]])
    out = ref.masked_attention(q, k, v, q_pos, torch.arange(16),
                               torch.ones(1, 16, dtype=torch.bool), window=2)
    assert torch.equal(out, torch.zeros_like(out))


def test_gqa_grouping_is_g_major():
    """Query head h reads kv head h % Hkv (attention.py:132-135).  SDPA's
    ``enable_gqa`` / ``repeat_interleave`` pair head h with kv head h // g
    — a different model, which this input tells apart."""
    rng = np.random.default_rng(0)
    b, s, h, hkv, hd = 1, 8, 4, 2, 16
    q, k, v = (_np(rng, (b, s, h, hd)), _np(rng, (b, s, hkv, hd)),
               _np(rng, (b, s, hkv, hd)))
    got = ops.prefill_attention(_t(q), _t(k), _t(v),
                                torch.zeros(b, dtype=torch.int32)).numpy()
    want = np.asarray(flash_ref(q, k, v, causal=True))
    np.testing.assert_allclose(got, want, **TOL)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2).numpy()
    assert not np.allclose(sdpa, want, atol=1e-3)
    g_major = torch.nn.functional.scaled_dot_product_attention(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2).repeat(1, h // hkv, 1, 1),
        _t(v).transpose(1, 2).repeat(1, h // hkv, 1, 1),
        is_causal=True).transpose(1, 2).numpy()
    np.testing.assert_allclose(g_major, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ K3

DECODE_SWEEP = [
    # (B, S_max, H, Hkv, hd)
    (4, 128, 4, 4, 64),
    (2, 256, 8, 2, 64),
    (3, 200, 4, 1, 32),
    (1, 512, 4, 4, 128),
]


@pytest.mark.parametrize("b,s,h,hkv,hd", DECODE_SWEEP)
def test_decode_attention_plain_matches_jax(b, s, h, hkv, hd):
    rng = np.random.default_rng(b * s)
    q = _np(rng, (b, h, hd))
    k, v = _np(rng, (b, s, hkv, hd)), _np(rng, (b, s, hkv, hd))
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    want = decode_ref(q, k, v, jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.decode_attention(q, k, v, jnp.asarray(lengths),
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_decode_attention_windowed_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, hkv, hd = 2, 256, 4, 2, 64
    q = _np(rng, (b, h, hd))
    k, v = _np(rng, (b, s, hkv, hd)), _np(rng, (b, s, hkv, hd))
    lengths = np.asarray([200, 64], np.int32)
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths), window=32)
    want = decode_ref(q, k, v, jnp.asarray(lengths), window=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.decode_attention(q, k, v, jnp.asarray(lengths), window=32,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_decode_attention_stale_length_past_cache_reads_whole_row():
    """An idle engine slot may carry offset == max_len: its length runs
    past S_max and reads the whole row (the kernel clamps it)."""
    rng = np.random.default_rng(4)
    q = _np(rng, (2, 4, 16))
    k, v = _np(rng, (2, 32, 2, 16)), _np(rng, (2, 32, 2, 16))
    over = ops.decode_attention(_t(q), _t(k), _t(v),
                                torch.tensor([33, 40], dtype=torch.int32))
    full = ops.decode_attention(_t(q), _t(k), _t(v),
                                torch.tensor([32, 32], dtype=torch.int32))
    np.testing.assert_allclose(over.numpy(), full.numpy(), **TOL)


# ------------------------------------------------------------------ K4

GMM_SWEEP = [
    # (E, C, d, F) — C and F off the Pallas kernel's 128-tiles included
    (4, 128, 64, 128),
    (8, 8, 32, 64),          # decode-like capacity
    (2, 300, 64, 100),       # ragged C and F
    (3, 13, 48, 40),
]


@pytest.mark.parametrize("b,hkv,s_max,want", [
    (8, 4, 2048, 9),      # the serve's decode step: 288 CTAs, two waves
    (8, 4, 512, 8),       # the short trace: as many splits as 64-key tiles
    (8, 4, 64, 1),        # one tile per row: no split, no merge launch
    (1, 1, 100000, 32),   # capped
    (64, 8, 2048, 1),     # the grid fills the card unsplit
    (3, 2, 128, 2),
])
def test_decode_split_count(b, hkv, s_max, want):
    """The decode kernel's key-axis split comes from host-known shapes
    only: two waves of CTAs over 132 SMs, no more splits than the row
    has 64-key tiles, at most 32."""
    split = ops.decode_split(b, hkv, s_max)
    assert split == want
    if want < min(32, -(-s_max // 64)):
        assert split * hkv * b >= 2 * 132


@pytest.mark.parametrize("b,hkv,row_blocks,max_pages,page,want", [
    (8, 4, 1, 129, 16, 9),     # K5 on the 723-2049-token pool: 288 CTAs
    (8, 4, 2, 129, 16, 5),     # K6 at W 4 (32 rows, 2 row blocks): 320 CTAs
    (8, 4, 3, 129, 16, 3),     # K6 at W 5 (40 rows, 3 row blocks)
    (8, 4, 1, 8, 16, 2),       # 128 keys: as many splits as 64-key tiles
    (8, 4, 1, 4, 16, 1),       # one tile: no split, no merge launch
    (1, 1, 1, 4096, 32, 32),   # capped
    (64, 8, 1, 129, 16, 1),    # the grid fills the card unsplit
    (2, 1, 32, 64, 8, 5),      # W 64 at g 8: row blocks fill the grid
])
def test_paged_split_count(b, hkv, row_blocks, max_pages, page, want):
    """The paged kernel's key-axis split comes from host-known shapes
    only, as the decode kernel's with S_max = max_pages * page_size and
    the row blocks counted among the CTAs: two waves over 132 SMs, no
    more splits than 64-key tiles, at most 32."""
    split = ops.paged_split(b, hkv, row_blocks, max_pages, page)
    assert split == want
    if want < min(32, -(-max_pages * page // 64)):
        assert split * hkv * row_blocks * b >= 2 * 132
    if row_blocks == 1:
        assert split == ops.decode_split(b, hkv, max_pages * page)


@pytest.mark.parametrize("w,g,want", [
    (1, 8, 1), (1, 16, 1), (2, 8, 1), (4, 8, 2), (5, 8, 3), (64, 8, 32),
    (1, 1, 1), (3, 5, 1), (9, 2, 2),
])
def test_paged_row_blocks(w, g, want):
    """The W * g query rows of one kv head go to CTAs in blocks of at most
    16 (W * g = 8, 16, 32, 40, 512 above, and ragged counts)."""
    assert ops.paged_row_blocks(w, g) == want
    assert (want - 1) * 16 < w * g <= want * 16


@pytest.mark.parametrize("e,c,d,f", GMM_SWEEP)
def test_moe_gmm_plain_matches_jax(e, c, d, f):
    rng = np.random.default_rng(e * c + f)
    x = _np(rng, (e, c, d))
    wg = _np(rng, (e, d, f), d ** -0.5)
    wu = _np(rng, (e, d, f), d ** -0.5)
    wd = _np(rng, (e, f, d), f ** -0.5)
    got = ops.moe_gmm(_t(x), _t(wg), _t(wu), _t(wd))
    assert got.shape == (e, c, d) and got.dtype == torch.float32
    want = jax.jit(jref.moe_gmm_ref)(x, wg, wu, wd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.moe_gmm(x, wg, wu, wd, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("e,c,d,f", [(2, 13, 40, 100), (3, 5, 20, 36),
                                     (2, 7, 33, 17), (1, 9, 64, 64)])
def test_moe_gmm_zero_padding_is_exact(e, c, d, f):
    """On the card ``moe_gmm`` zero-pads d and F to multiples of 8 (TMA
    rows are 16-byte multiples) and slices the output: in fp32 the padded
    plain version gives exactly the unpadded one.  Aligned widths are not
    copied."""
    rng = np.random.default_rng(c * d + f)
    args = (_t(_np(rng, (e, c, d))), _t(_np(rng, (e, d, f), d ** -0.5)),
            _t(_np(rng, (e, d, f), d ** -0.5)), _t(_np(rng, (e, f, d), f ** -0.5)))
    padded = ops.pad_widths(*args)
    want = ref.moe_gmm_ref(*args)
    if d % 8 == 0 and f % 8 == 0:
        assert all(p is a for p, a in zip(padded, args))
        return
    assert padded[0].shape == (e, c, -(-d // 8) * 8)
    assert padded[1].shape == (e, -(-d // 8) * 8, -(-f // 8) * 8)
    assert padded[3].shape == (e, -(-f // 8) * 8, -(-d // 8) * 8)
    assert torch.equal(ref.moe_gmm_ref(*padded)[..., :d], want)


# ----------------------------------------------------------------- K5, K6

PAGED_SWEEP = [
    # (B, H, Hkv, hd, page_size, n_pages, max_pages), tests/test_kernels.py
    (3, 4, 2, 64, 16, 24, 6),
    (2, 8, 1, 32, 8, 40, 10),      # MQA, small pages
    (1, 4, 4, 128, 32, 8, 4),      # MHA
    (4, 4, 2, 64, 16, 20, 4),      # tight pool, short sequences
]

VERIFY_SWEEP = [
    # (B, W, H, Hkv, hd, page_size, n_pages, max_pages)
    (3, 3, 4, 2, 64, 16, 24, 6),
    (2, 5, 8, 1, 32, 8, 40, 10),
    (1, 2, 4, 4, 128, 32, 8, 4),
    (4, 4, 4, 2, 64, 16, 20, 4),
]


def _block_tables(rng, b, min_len, page_size, n_pages, max_pages):
    """Lengths in [min_len, max_pages * page_size] and SHUFFLED physical
    pages: logical order comes only from the table; entries past a
    sequence's pages are 0 padding."""
    lengths = rng.integers(min_len, max_pages * page_size + 1, size=b)
    bt = np.zeros((b, max_pages), np.int32)
    perm = rng.permutation(n_pages)
    k = 0
    for i in range(b):
        n = -(-int(lengths[i]) // page_size)
        bt[i, :n] = perm[k:k + n]
        k += n
    assert k <= n_pages, "sweep entry overcommits the page pool"
    return lengths.astype(np.int32), bt


paged_decode_ref = jax.jit(jref.paged_decode_attention_ref,
                           static_argnames=("window",))
paged_verify_ref = jax.jit(jref.paged_verify_attention_ref,
                           static_argnames=("window",))


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("b,h,hkv,hd,page,npages,maxp", PAGED_SWEEP)
def test_paged_decode_attention_plain_matches_jax(b, h, hkv, hd, page, npages,
                                                  maxp, window):
    rng = np.random.default_rng(b * hd + page)
    q = _np(rng, (b, h, hd))
    kp, vp = _np(rng, (npages, page, hkv, hd)), _np(rng, (npages, page, hkv, hd))
    lengths, bt = _block_tables(rng, b, 1, page, npages, maxp)
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lengths), window=window)
    want = paged_decode_ref(q, kp, vp, bt, lengths, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.paged_decode_attention(q, kp, vp, bt, lengths,
                                         window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("b,w,h,hkv,hd,page,npages,maxp", VERIFY_SWEEP)
def test_paged_verify_attention_plain_matches_jax(b, w, h, hkv, hd, page,
                                                  npages, maxp, window):
    """The W-token window, lengths covering it (the engine writes the
    window's K/V before verifying)."""
    rng = np.random.default_rng(b * hd + w)
    q = _np(rng, (b, w, h, hd))
    kp, vp = _np(rng, (npages, page, hkv, hd)), _np(rng, (npages, page, hkv, hd))
    lengths, bt = _block_tables(rng, b, w, page, npages, maxp)
    got = ops.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lengths), window=window)
    want = paged_verify_ref(q, kp, vp, bt, lengths, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jops.paged_verify_attention(q, kp, vp, bt, lengths,
                                         window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_paged_decode_over_allocator_tables_equals_contiguous_decode():
    """Slot rows scattered into the pool through the port's own
    PagedKVAllocator block tables: paged decode over the pool equals
    contiguous decode over the slot rows."""
    from repro_torch.serving.kvcache import PagedKVAllocator
    b, h, hkv, hd, page, s_max = 3, 4, 2, 32, 8, 64
    kv = PagedKVAllocator(n_pages=b * s_max // page, page_size=page)
    lengths = np.array([50, 17, 8], np.int32)
    for rid, n in enumerate(lengths):
        kv.reserve(rid, int(n))
    rng = np.random.default_rng(12)
    q = _np(rng, (b, h, hd))
    k_slot, v_slot = _np(rng, (b, s_max, hkv, hd)), _np(rng, (b, s_max, hkv, hd))
    kp = np.zeros((kv.n_pages, page, hkv, hd), np.float32)
    vp = np.zeros_like(kp)
    bt = np.zeros((b, s_max // page), np.int32)
    for rid in range(b):
        table = kv.block_table(rid)
        bt[rid, :len(table)] = table
        for j, pid in enumerate(table):
            kp[pid] = k_slot[rid, j * page:(j + 1) * page]
            vp[pid] = v_slot[rid, j * page:(j + 1) * page]
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lengths))
    want = ops.decode_attention(_t(q), _t(k_slot), _t(v_slot), _t(lengths))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_paged_verify_window_one_equals_paged_decode():
    rng = np.random.default_rng(13)
    b, h, hkv, hd, page, npages, maxp = 3, 4, 2, 64, 16, 24, 6
    q = _np(rng, (b, h, hd))
    kp, vp = _np(rng, (npages, page, hkv, hd)), _np(rng, (npages, page, hkv, hd))
    lengths, bt = _block_tables(rng, b, 1, page, npages, maxp)
    args = (_t(kp), _t(vp), _t(bt), _t(lengths))
    got = ops.paged_verify_attention(_t(q)[:, None], *args)[:, 0]
    want = ops.paged_decode_attention(_t(q), *args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_paged_length_zero_outputs_zero():
    """A sequence of length 0 outputs 0, as the Pallas kernel does (it
    clamps its denominator at 1e-30); so do verify rows that see no key."""
    rng = np.random.default_rng(14)
    q = _np(rng, (2, 3, 4, 16))
    kp, vp = _np(rng, (4, 8, 2, 16)), _np(rng, (4, 8, 2, 16))
    bt = np.asarray([[0, 1], [2, 3]], np.int32)
    lengths = np.asarray([0, 2], np.int32)
    got = ops.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lengths)).numpy()
    assert not got[0].any() and not got[1, 0].any() and got[1, 1:].any()
    pallas = jops.paged_decode_attention(q[:, 0], kp, vp, bt, lengths,
                                         interpret=True)
    np.testing.assert_allclose(
        ops.paged_decode_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(bt),
                                   _t(lengths)).numpy(),
        np.asarray(pallas), **TOL)


# ------------------------------------------------ slot-row gather/scatter

def _cache_tree(rng, reps=2, n_slots=4, s=6):
    return [[{"k": _np(rng, (reps, n_slots, s, 2, 3)),
              "v": _np(rng, (reps, n_slots, s, 2, 3))}]]


def test_gather_scatter_slot_rows_match_jax_with_padding_ids():
    """Padding rows carry slot id n_slots: the gather clips them to the
    last real row, the scatter drops their writes (JAX mode clip/drop)."""
    rng = np.random.default_rng(5)
    tree = _cache_tree(rng)
    slots = np.asarray([2, 0, 4, 4], np.int32)            # 4 == n_slots
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(_t, tree)
    got = ops.gather_slot_rows(tt, slots)
    want = jops.gather_slot_rows(jt, jnp.asarray(slots))
    np.testing.assert_array_equal(got[0][0]["k"].numpy(),
                                  np.asarray(want[0][0]["k"]))
    rows = [[{"k": _np(rng, (2, 4, 6, 2, 3)), "v": _np(rng, (2, 4, 6, 2, 3))}]]
    ops.scatter_slot_rows(tt, jax.tree_util.tree_map(_t, rows), slots)
    want = jops.scatter_slot_rows(jt, jax.tree_util.tree_map(jnp.asarray, rows),
                                  jnp.asarray(slots))
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(tt[0][0][leaf].numpy(),
                                      np.asarray(want[0][0][leaf]))


def test_scatter_refuses_device_side_slot_ids():
    """Slot ids are filtered on the host so the scatter never syncs."""
    tree = [[{"k": torch.zeros(1, 2, 3)}]]
    with pytest.raises(ValueError):
        ops.scatter_slot_rows(tree, tree, torch.zeros(2, dtype=torch.int32,
                                                      device="meta"))


# ------------------------------------------------------------ no fallback

@pytest.mark.parametrize("b,s_max,hkv,g,hd,want", [
    (8, 256, 1, 16, 256, 8),     # recurrentgemma-9b's training shape
    (1, 4096, 1, 16, 256, 4),    # one 4096-token row at one kv head
    (8, 256, 4, 8, 128, 4),      # qwen3-30b-a3b's training shape
    (2, 2048, 4, 8, 128, 2),     # qwen3's heads at 2048-token rows
    (8, 256, 36, 1, 64, 1),      # minicpm-2b: the grid fills the card
    (8, 256, 128, 1, 192, 1),    # deepseek-v2-236b (64-key tiles)
    (1, 1500, 8, 1, 64, 1),      # whisper's encoder: g 1, nothing to split
    (1, 10, 2, 8, 128, 8),       # S_max under one tile: every head a group
    (2, 160, 1, 16, 256, 16),
    (1, 256, 2, 6, 64, 6),       # the divisors of 6 below it do not fill
])
def test_bwd_split_count(b, s_max, hkv, g, hd, want):
    """K2's backward splits the g query heads of its dK/dV pass into s
    groups from host-known shapes only: s divides g; no split where the
    (key tile, kv head, row) grid fills the 132 SMs; else the smallest
    split that fills them, or every head its own group where none does."""
    split = ops.bwd_split(b, hkv, g, s_max, hd)
    assert split == want and g % split == 0
    ctas = -(-s_max // ops.bwd_key_tile(hd)) * hkv * b
    if ctas >= 132:
        assert split == 1
    elif ctas * g >= 132:
        assert ctas * split >= 132
        assert all(ctas * s < 132 for s in range(1, split) if g % s == 0)
    else:
        assert split == g


def test_backward_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors the two backward wrappers give their plain versions'
    results exactly (the card's scratch and split are not taken) and
    launch nothing."""
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(_np(rng, (2, 40, 8, 32))) for _ in range(2))
    k, v = (torch.from_numpy(_np(rng, (2, 40, 1, 32))) for _ in range(2))
    off = torch.zeros(2, dtype=torch.int32)
    out = ref.prefill_attention_ref(q, k, v, off, window=16)
    lse = ref.prefill_attention_lse_ref(q, k, v, off, window=16)
    moe = [torch.from_numpy(_np(rng, s_, 0.1))
           for s_ in ((3, 7, 16), (3, 16, 24), (3, 16, 24), (3, 24, 16))]
    dy = torch.from_numpy(_np(rng, (3, 7, 16)))
    ops.reset_launches()
    got = ops.prefill_attention_bwd(q, k, v, out, lse, do, off, window=16)
    want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, off,
                                         window=16)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    for g_, w_ in zip(ops.moe_gmm_bwd(*moe, dy), ref.moe_gmm_bwd_ref(*moe, dy)):
        assert torch.equal(g_, w_)
    assert all(v_ == 0 for v_ in ops.LAUNCHES.values())
    assert all(v_ == 0 for v_ in ops.PAD_COPIES.values())


def test_wrappers_take_no_silent_fallback():
    """Only a CPU tensor takes the plain version; anything else that is
    not a CUDA tensor raises instead of quietly running elsewhere."""
    q = torch.empty(1, 2, 4, 16, device="meta")
    k = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        ops.prefill_attention(q, k, k, torch.empty(1, dtype=torch.int32,
                                                   device="meta"))
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], k, k, torch.empty(1, dtype=torch.int32,
                                                        device="meta"))
    rows = torch.empty(8, 16, device="meta")
    w = torch.empty(2, 16, 16, device="meta")
    with pytest.raises(ValueError):
        ops.moe_gmm_ragged(rows, w, w, w,
                           torch.empty(1, dtype=torch.int32, device="meta"), 8)
    with pytest.raises(ValueError):
        ops.moe_gmm(rows[None], w[:1], w[:1], w[:1])
    pages = torch.empty(4, 8, 2, 16, device="meta")
    bt = torch.empty(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q[:, 0], pages, pages, bt, bt[:, 0])
    with pytest.raises(ValueError):
        ops.paged_verify_attention(q, pages, pages, bt, bt[:, 0])


def test_cpu_path_launches_no_kernel():
    ops.reset_launches()
    ops.decode_attention(torch.randn(1, 2, 16), torch.randn(1, 8, 1, 16),
                         torch.randn(1, 8, 1, 16),
                         torch.tensor([5], dtype=torch.int32))
    assert all(v == 0 for v in ops.LAUNCHES.values())
