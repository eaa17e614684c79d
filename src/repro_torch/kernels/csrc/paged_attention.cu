// GQA decode attention over the paged KV pool, and its speculative
// verify-window variant, by hand for Hopper (sm_90a): split-K over the
// block table's pages on mma.sync.  One kernel and one C entry point;
// paged decode attention is the verify window W = 1.
//
// Replaces: src/repro/kernels/decode_attention.py,
// paged_decode_attention_pallas (body _paged_decode_kernel) and
// paged_verify_attention_pallas (body _paged_verify_kernel).  Same contract:
// q (B, W, H, hd) — the W newest tokens of each sequence, oldest first;
// k/v pages (n_pages, page_size, Hkv, hd), the global pool; block_tables
// (B, max_pages) int32 physical page ids in logical order; lengths (B,)
// valid tokens including the window's K/V.  Window query w sees keys
// < length - W + 1 + w (with a window, also >= that minus ``window``).
// Query head h reads kv head h % Hkv (g-major grouping).  Block-table
// entries past a sequence's pages are never read (only positions <
// min(length, max_pages * page_size) are), and a row that sees no key —
// length 0 — outputs 0 (the Pallas kernel clamps its denominator at 1e-30).
//
// Bound on an H100 SXM (3.35 TB/s): each sequence's valid K and V rows
// must be read once, 2 * Hkv * hd * 2 B = 2 KB per cached token at
// qwen3-30b-a3b (Hkv 4, hd 128); with g = 8 query heads per kv head the
// work is 2 W flops per byte read — far below the ~295 the tensor cores
// need — so bytes bound both kernels at any W a speculative decoder uses.
//
// Design: the contiguous decode kernel (decode_attention.cu) with a page
// walk in its loader and query-row blocks.
//  * The R = W * g query rows that read one kv head are packed w-major
//    (row r <-> window token r / g, head-in-group r % g, as the Pallas
//    wrapper packs them) and cut into row blocks of at most 16: the n = 8
//    or 16 columns of one or two mma n-tiles.  A CTA keeps its block's
//    rows in shared memory and its O^T fragments in registers (156 at 16
//    rows, three CTAs an SM), so W has no shared-memory limit.
//  * Grid (split, Hkv * row_blocks, B), the row blocks of one kv head
//    adjacent in blockIdx.y so that their re-reads of the same K/V tiles
//    come from L2.  The host picks ``split`` from the shapes it knows
//    (ops.paged_split: two waves on 132 SMs).  Lengths stay on the card:
//    each CTA reads lengths[b] and takes its share of [lo, n_keys) in
//    16-key units, lo the oldest window row's window start, n_keys =
//    min(length, max_pages * page_size).
//  * K/V stream through a two-stage ring of 64-key tiles with 16-byte
//    cp.async, zero-filled past the share.  Key position t is row
//    t % page_size of page block_tables[b][t / page_size]; each thread
//    loads the table entries of the tile after next while the current
//    tile is computed, so a table read never waits in front of a copy.
//  * Each of the 4 warps owns 16 keys of a tile and keeps its own online
//    softmax (m, l, O) per query column: S^T = K Q^T by mma.sync m16n8k16
//    with the query rows in N, P^T through movmatrix into O^T += V^T P^T,
//    exp2f with log2(e) folded into the scale.  The causal and window
//    masks are per column (each window token has its own horizon).
//  * The 4 warps' partials merge through shared memory; with split > 1
//    the CTA writes (O, m, l) to fp32 scratch and a second launch merges
//    the splits in split order: no float atomics, the same result from
//    run to run.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps, 16 keys each per tile
constexpr int kWarps = kThreads / 32;
constexpr int KT = 16 * kWarps;          // keys per tile
constexpr int STAGES = 2;
constexpr int HD_MAX = 128;
constexpr int ROWS = 16;                 // query rows (mma columns) per CTA
constexpr int KPT = KT * (HD_MAX / 8) / kThreads;   // 16-byte chunks a thread copies per tile
constexpr float kLog2e = 1.4426950408889634f;

// the K/V ring, then the block's query rows (the ring becomes the merge
// area at the end)
__host__ __device__ inline size_t smem_bytes(int hd) {
  const size_t ring = sizeof(bf16) * STAGES * 2 * KT * (hd + 8);
  const size_t merge = sizeof(float) * kWarps * ROWS * (hd + 2);
  return (ring > merge ? ring : merge) + sizeof(bf16) * ROWS * (hd + 8);
}

template <int NT>   // n-tiles of 8 query rows: a row block holds <= 8 * NT
__global__ void __launch_bounds__(kThreads, 3)
paged_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                   const bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, bf16* __restrict__ out,
                   float* __restrict__ part, int W, int H, int Hkv, int page_size,
                   int max_pages, int hd, int window, float scale_log2, int split,
                   int row_blocks) {
  const int s = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / row_blocks, rb = blockIdx.y % row_blocks;
  const int g = H / Hkv;
  const int R = W * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int hd16 = hd / 16;
  const int ld = hd + 8;   // padded rows: ldmatrix reads 8 rows without bank conflicts

  // this CTA's share of the keys any window row sees, [lo, n_keys); the
  // oldest row's horizon bounds a sliding window from below
  const int length = lengths[b];
  const int n_keys = min(length, max_pages * page_size);
  const int lo = window > 0 ? max(0, length - W + 1 - window) : 0;
  const int n = max(n_keys - lo, 0);
  const int chunk = ((n + split - 1) / split + 15) & ~15;
  const int start = lo + s * chunk;
  const int end = min(start + chunk, n_keys);
  const int n_tiles = end > start ? (end - start + KT - 1) / KT : 0;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [STAGES][KT][ld]
  bf16* vs = ks + STAGES * KT * ld;
  bf16* qs = reinterpret_cast<bf16*>(smem + smem_bytes(hd)) - ROWS * ld;   // [ROWS][ld]
  const long kv_row = static_cast<long>(Hkv) * hd;   // elements between two pool rows
  const bf16* kb = k_pages + static_cast<long>(kh) * hd;
  const bf16* vb = v_pages + static_cast<long>(kh) * hd;
  const int* bt = block_tables + static_cast<long>(b) * max_pages;
  const int chunks = hd / 8;

  // pool row of each key this thread copies in the next tile to issue;
  // entries past the share are never read
  int rows[KPT];
  auto fetch_rows = [&](int t) {
    const int t0 = start + t * KT;
#pragma unroll
    for (int it = 0; it < KPT; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int pos = t0 + i / chunks;
      rows[it] = i < KT * chunks && pos < end
                     ? bt[pos / page_size] * page_size + pos % page_size
                     : 0;
    }
  };
  auto issue_tile = [&](int t, int st) {
    const int t0 = start + t * KT;
#pragma unroll
    for (int it = 0; it < KPT; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i < KT * chunks) {
        const int j = i / chunks, c = (i - j * chunks) * 8;
        const bool ok = t0 + j < end;
        const long src = static_cast<long>(rows[it]) * kv_row + c;
        cp_async16(ks + (st * KT + j) * ld + c, kb + src, ok);
        cp_async16(vs + (st * KT + j) * ld + c, vb + src, ok);
      }
    }
  };
  fetch_rows(0);
  if (n_tiles > 0) issue_tile(0, 0);
  cp_async_commit();
  fetch_rows(1);

  // the block's query rows rb * 16 + col into shared memory (zero past R):
  // the B fragments of Q^T are read back by ldmatrix at every tile rather
  // than held in 32 registers, which keeps the 16-row kernel under 168
  // registers, three CTAs an SM rather than two
  for (int i = threadIdx.x; i < ROWS * chunks; i += kThreads) {
    const int col = i / chunks, c = (i - col * chunks) * 8;
    const int r = rb * ROWS + col;
    const int w = r / g, gi = r - w * g;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < R)
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<long>(b) * W + w) * H + gi * Hkv + kh) * hd + c);
    *reinterpret_cast<uint4*>(qs + col * ld + c) = v;
  }
  // each column's visible keys [c_lo, c_hi)
  int c_lo[NT][2], c_hi[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rb * ROWS + nt * 8 + tig * 2 + j;
      const int row_len = length - W + 1 + r / g;
      c_hi[nt][j] = r < R ? min(end, row_len) : 0;
      c_lo[nt][j] = window > 0 ? max(start, row_len - window) : start;
    }
  }

  // per warp: O^T (hd x rows) fragments, running max and sum per column
  float o[NT][HD_MAX / 16][4];
  float m_run[NT][2], l_run[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < HD_MAX / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][mt][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[nt][j] = -INFINITY;
      l_run[nt][j] = 0.0f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t visible to all; tile t - 1's stage free
    if (t + 1 < n_tiles) issue_tile(t + 1, (t + 1) % STAGES);
    cp_async_commit();
    fetch_rows(t + 2);

    const int st = t % STAGES;
    const bf16* kt = ks + (st * KT + warp * 16) * ld;
    const bf16* vt = vs + (st * KT + warp * 16) * ld;
    const int key0 = start + t * KT + warp * 16;

    // S^T (16 keys x 8 rows) = K (16 x hd) Q^T (hd x 8)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD_MAX / 16; ++kk) {
      if (kk < hd16) {
        uint32_t a[4], qb[4];
        ldmatrix_x4(a, kt + ((lane % 8) + ((lane / 8) & 1) * 8) * ld + kk * 16 + (lane / 16) * 8);
        // B fragments of Q^T: matrix m = lane / 8 is n-tile m / 2, hd
        // half m % 2; lane holds row nt * 8 + gid, hd pairs tig * 2 (+8)
        ldmatrix_x4(qb, qs + ((lane / 16) * 8 + lane % 8) * ld + kk * 16 + ((lane / 8) & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_m16n8k16(sc[nt], a, qb[2 * nt], qb[2 * nt + 1]);
      }
    }

    // online softmax per query column; lanes of one tig share a column
    const int p0 = key0 + gid, p1 = key0 + gid + 8;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok0 = p0 >= c_lo[nt][j] && p0 < c_hi[nt][j];
        const bool ok1 = p1 >= c_lo[nt][j] && p1 < c_hi[nt][j];
        const float x0 = ok0 ? sc[nt][j] * scale_log2 : -INFINITY;
        const float x1 = ok1 ? sc[nt][2 + j] * scale_log2 : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[nt][j], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m_run[nt][j] - m_use);
        const float e0 = exp2f(x0 - m_use), e1 = exp2f(x1 - m_use);
        l_run[nt][j] = l_run[nt][j] * alpha + e0 + e1;
        m_run[nt][j] = m_new;
        sc[nt][j] = e0;
        sc[nt][2 + j] = e1;
#pragma unroll
        for (int mt = 0; mt < HD_MAX / 16; ++mt) {
          o[nt][mt][j] *= alpha;
          o[nt][mt][2 + j] *= alpha;
        }
      }
      // P^T (keys x rows) -> B fragment (k = key, n = row)
      pb[nt][0] = movmatrix_trans(pack_bf16(sc[nt][0], sc[nt][1]));
      pb[nt][1] = movmatrix_trans(pack_bf16(sc[nt][2], sc[nt][3]));
    }

    // O^T (hd x rows) += V^T (hd x 16 keys) P^T (16 keys x rows)
#pragma unroll
    for (int mt = 0; mt < HD_MAX / 16; ++mt) {
      if (mt < hd16) {
        const int mat = lane / 8;
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + ((mat >> 1) * 8 + lane % 8) * ld + mt * 16 + (mat & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_m16n8k16(o[nt][mt], a, pb[nt][0], pb[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring becomes the merge area

  // merge the 4 warps' partials through shared memory
  float* wm = reinterpret_cast<float*>(smem);   // [kWarps][ROWS]
  float* wl = wm + kWarps * ROWS;
  float* wo = wl + kWarps * ROWS;               // [kWarps][ROWS][hd]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float l = l_run[nt][j];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      const int col = nt * 8 + tig * 2 + j;
      if (gid == 0) {
        wm[warp * ROWS + col] = m_run[nt][j];
        wl[warp * ROWS + col] = l;
      }
      float* row = wo + (warp * ROWS + col) * hd;
#pragma unroll
      for (int mt = 0; mt < HD_MAX / 16; ++mt) {
        if (mt < hd16) {
          row[mt * 16 + gid] = o[nt][mt][j];
          row[mt * 16 + gid + 8] = o[nt][mt][2 + j];
        }
      }
    }
  }
  __syncthreads();
  const int n_cols = min(8 * NT, R - rb * ROWS);
  for (int i = threadIdx.x; i < n_cols * hd; i += kThreads) {
    const int col = i / hd, c = i - col * hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * ROWS + col]);
    const float m_use = mx == -INFINITY ? 0.0f : mx;
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * ROWS + col] - m_use);
      l += wl[w * ROWS + col] * f;
      acc += wo[(w * ROWS + col) * hd + c] * f;
    }
    const int r = rb * ROWS + col;
    const int w = r / g, gi = r - w * g;
    const long orow = (static_cast<long>(b) * W + w) * H + gi * Hkv + kh;
    if (split == 1) {
      out[orow * hd + c] = __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
    } else {
      const long ps = orow * split + s;
      part[ps * hd + c] = acc;
      if (c == 0) {
        float* ml = part + static_cast<long>(gridDim.z) * W * H * split * hd;
        ml[ps * 2] = mx;
        ml[ps * 2 + 1] = l;
      }
    }
  }
}

// One CTA per output row (b, w, h), one thread per hd column: merge the
// splits' (O, m, l) in split order.
__global__ void paged_merge_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                   long n_rows, int hd, int split) {
  const long r = blockIdx.x;
  const int c = threadIdx.x;
  const float* po = part + r * split * hd;
  const float* ml = part + n_rows * split * hd + r * split * 2;
  float mx = -INFINITY;
  for (int s = 0; s < split; ++s) mx = fmaxf(mx, ml[s * 2]);
  const float m_use = mx == -INFINITY ? 0.0f : mx;
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < split; ++s) {
    const float f = exp2f(ml[s * 2] - m_use);
    l += ml[s * 2 + 1] * f;
    acc += po[s * hd + c] * f;
  }
  out[r * hd + c] = __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
}

template <int NT>
cudaError_t launch(const bf16* q, const bf16* kp, const bf16* vp, const int* bt,
                   const int* lengths, bf16* out, float* part, int B, int W, int H, int Hkv,
                   int page_size, int max_pages, int hd, int window, float scale, int split,
                   int row_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = allow_smem(paged_split_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  paged_split_kernel<NT><<<dim3(split, Hkv * row_blocks, B), kThreads, smem, stream>>>(
      q, kp, vp, bt, lengths, out, part, W, H, Hkv, page_size, max_pages, hd, window,
      scale * kLog2e, split, row_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long n_rows = static_cast<long>(B) * W * H;
  paged_merge_kernel<<<static_cast<unsigned>(n_rows), hd, 0, stream>>>(part, out, n_rows,
                                                                       hd, split);
  return cudaGetLastError();
}

}  // namespace

// ``scratch``: split > 1 needs B * W * H * split * (hd + 2) fp32 (unused,
// and may be null, at split 1).  Two CUDA launches when split > 1.
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* lengths, void* out, void* scratch, int B,
                                    int W, int H, int Hkv, int page_size, int max_pages,
                                    int hd, int window, float scale, int split,
                                    void* stream) {
  if (B == 0 || W == 0) return 0;
  const int R = Hkv > 0 ? W * (H / Hkv) : 0;
  const int row_blocks = (R + ROWS - 1) / ROWS;
  if (Hkv <= 0 || H % Hkv != 0 || hd % 16 != 0 || hd > HD_MAX || page_size <= 0 ||
      split < 1 || split > 65535 || B > 65535 ||
      static_cast<long>(Hkv) * row_blocks > 65535 ||
      static_cast<long>(B) * W * H > 2147483647L || (split > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k_pages);
  auto vv = static_cast<const bf16*>(v_pages);
  auto bt = static_cast<const int*>(block_tables);
  auto ln = static_cast<const int*>(lengths);
  auto oo = static_cast<bf16*>(out);
  auto part = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      R <= 8 ? launch<1>(qq, kk, vv, bt, ln, oo, part, B, W, H, Hkv, page_size, max_pages, hd,
                         window, scale, split, row_blocks, st)
             : launch<2>(qq, kk, vv, bt, ln, oo, part, B, W, H, Hkv, page_size, max_pages, hd,
                         window, scale, split, row_blocks, st);
  return static_cast<int>(err);
}
