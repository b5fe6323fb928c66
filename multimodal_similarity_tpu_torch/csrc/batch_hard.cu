// Fused pairwise squared distance + batch-hard reduction for Hopper (sm_90a).
//
// Replaces the TPU kernels of multimodal_similarity_tpu/ops/pallas/:
//   batch_hard_stats_tc (bf16) / batch_hard_stats_kernel (f32) (K1, K2),
//   the row walk:
//     WITH_IDX = true   -> batch_hard.py:110 _stats_kernel
//                          (via _stats_pallas :250)
//     WITH_IDX = false  -> batch_hard.py:151 _stats_kernel_noidx
//                          (via _stats_pallas_noidx :222)
//   batch_hard_tri_tc (bf16) / batch_hard_tri_kernel (f32), each with
//   batch_hard_tri_combine (K3), the triangle walk:
//     WITH_IDX = true   -> batch_hard_tri.py:123 _tri_kernel_idx
//     WITH_IDX = false  -> batch_hard_tri.py:91 _tri_kernel_noidx
//                          (both via _stats_tri :215)
//
// Per anchor row i, over every column j of the same [N, d] embedding matrix:
//   dist  = max(sq[i] + sq_pen[j] - 2 <e_i, e_j>, 0)
//   same  = valid[j] > 0 && label[i] == label[j]
//   fp    = max_j (same && i != j ? dist : 0)        furthest positive
//   cn    = min_j (same ? 1e30 : dist)               closest negative
//   nc    = sum_j (same ? 0 : valid[j])              negative count
//   fpi / cni: the column of each winner; the LOWEST column wins a tie,
//   as on the TPU (first-in-tile argmax plus a strict compare across
//   ascending tiles).  The gradient scatters into these winners.
// Invalid columns carry a +1e30 norm penalty in sq_pen, so they never win
// the closest negative; the valid flag keeps them out of the positive set.
// Labels are 64-bit integers: no float cast, no remap.
//
// Two designs, by operand type.
//
// bf16: tensor cores (batch_hard_stats_tc, batch_hard_tri_tc, on the
// shared csrc/wgmma_tile.cuh).  The products run as wgmma.mma_async
// (m64nNk16, bf16 x bf16 summed in f32, both operands from shared memory),
// fed by TMA from a ring of four 64-deep k-slices in dynamic shared memory:
// one producer thread keeps the loads in flight, consumer warpgroups issue
// the products and run the masked (value, index) epilogue on the
// accumulator fragments in registers.  K1/K2 walk 64-row blocks (one
// consumer warpgroup, two CTAs an SM) over 128-column tiles in ascending
// order, each thread keeping running (value, column) pairs for its two
// fragment rows with a strict compare, merged over the quad of lanes that
// share a row at the end with the lowest-column tie rule.  A's k-slices
// stream through the ring beside B's (L2 holds the matrix).  What the
// epilogue needs of each column (norms, valid flag, label) is loaded before
// the tile's products are waited for, and read from shared memory; the
// epilogue has no branches (a column past n gets -inf / +inf, which never
// win).  The row walk is not split over CTAs at small N: there the gate
// (ops/kernels/batch_hard.py use_triangular) weighs it against K3.
//
// f32: FMA (batch_hard_stats_kernel, batch_hard_tri_kernel), unchanged from
// the first port: one CTA owns BM anchor rows and loops over all column
// tiles; each [BM, d] x [d, BN] tile product is built from BK-deep
// shared-memory slices with f32 FMA; every thread keeps running (value,
// column) pairs for its TM rows over the columns it owns (tx, tx+32, tx+64,
// tx+96 of every tile, ascending), merged by one warp-shuffle reduction
// with an explicit lowest-index tie break.  TF32 would break the f32
// parity with the JAX package (1e-4), so f32 stays off the tensor cores.
// No atomics, no cross-CTA combine in the row walk: deterministic.
//
// Precision.  bf16 operands are products of bf16 values summed in f32 on
// the tensor cores, as the TPU kernels' matrix unit does (bf16 in, f32
// accumulation); f32 operands are full-f32 FMA.  The distance epilogue is
// f32 in both modes (the TPU kernel ran it in bf16 to pack its vector
// registers; Hopper has no such reason).
//
// Bound on an H100 (SXM, 700 W).  2 N^2 d product flops at 989 TFLOP/s in
// bf16 (67 TFLOP/s in f32) plus about 8 f32 epilogue operations per pair:
// operations bound every shape the port runs (N=8192, d=1024: 0.147 ms for
// the row walk); the inputs (N d bf16 plus five N-vectors) take
// microseconds.  At the trainer's N=512, d=128 the work is under a
// microsecond of either, so launch latency and SM occupancy bound it.  The
// tensor-core design answers the product bound; the masked epilogue, about
// 20 instructions per pair and side on the SMs' f32 lanes, is what bounds
// the kernels in practice at d <= 512 (PERF.md), so it runs without
// branches on data staged in shared memory, and K3 overlaps it with the
// next pair's products.  The running epilogue keeps the N x N distances
// out of memory.
//
// K3 (triangular).  dist(i, j) = dist(j, i) up to the norm terms, and the
// product <e_i, e_j> has the same bits whichever side is the anchor: the
// same wgmma k16 steps in ascending k for bf16 (csrc/wgmma_tile.cuh says
// why), the same ascending-k fmaf chain for f32 (csrc/tile.cuh, the chain
// K1 runs; fmaf(x, y, c) == fmaf(y, x, c)).  So one CTA per upper-triangle
// tile pair (ti <= tj) of B x B computes the product once and runs K1's
// epilogue both ways: for anchors i over candidates j,
// max((sq[i] + sq_pen[j]) - 2 acc, 0), and (off the diagonal) for anchors j
// over candidates i, max((sq[j] + sq_pen[i]) - 2 acc, 0).  (The TPU's
// additive-penalty form, dist + pen, would round differently on invalid
// columns.)  The row side's (value, index) pairs go to partial[ti][tj], the
// column side's to partial[tj][ti] of [planes, T, T, B] buffers the wrapper
// allocates: fp, cn, nc, plus fpi and cni WITH_IDX.  Every entry is written
// exactly once, so nothing needs clearing, and no float atomics are used.
// A second pass merges partial[a][0..T-1] in ascending b with a strict
// compare; inside a tile every merge breaks ties on the lower index (on the
// column side, the lower row, as at batch_hard_tri.py:170-184).  Values,
// negative counts and winners are therefore bit-equal to K1/K2 (negative
// counts for 0/1 valid flags, whose sums are exact in any order).  Half of
// K1's products, at the cost of a second epilogue per visited pair,
// 5 T^2 B words of partials (about 5 N^2 / B * 4 bytes with winners) and a
// second launch.  bf16: B = 128 (two MMA and two column warpgroups, 209 KB
// of shared memory) once the tile pairs fill the SMs, else B = 64 (one of
// each), persistent CTAs (batch_hard_tri_tc says how the roles overlap);
// the row side folds each thread's fragment columns, then the quad
// (shuffles 1, 2); the column side walks the product tile in shared
// memory, half a column a thread.  f32: B = 32 or 64 on FMA.  The wrapper
// chooses B and allocates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>

#include "tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int BN = 128;        // columns per tile: 32 lanes x TN
constexpr int BK = msim::TILE_BK;  // depth of one shared-memory slice
constexpr int TN = 4;          // columns per thread, strided by 32
constexpr int WARPS = 8;       // each warp owns TM rows of the CTA
constexpr int THREADS = WARPS * 32;
constexpr float POS_INF = 1e30f;

using msim::tile_product;
using msim::to_f32;

template <typename T, bool WITH_IDX, int TM>
__global__ void __launch_bounds__(THREADS)
batch_hard_stats_kernel(const T* __restrict__ emb, int n, int d,
                        const float* __restrict__ sq,
                        const float* __restrict__ sq_pen,
                        const long long* __restrict__ labels,
                        const float* __restrict__ valid,
                        float* __restrict__ fp_out,
                        float* __restrict__ cn_out,
                        float* __restrict__ nc_out,
                        int* __restrict__ fpi_out,
                        int* __restrict__ cni_out) {
  constexpr int BM = WARPS * TM;
  // +1 padding: the transposed stores and the strided column reads both
  // hit 32 distinct banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * BM;

  float sqa[TM];
  long long la[TM];
  float fp[TM], cn[TM], nc[TM];
  int fpi[TM], cni[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty * TM + m;
    sqa[m] = i < n ? sq[i] : 0.f;
    la[m] = i < n ? labels[i] : 0;
    fp[m] = -INFINITY;
    cn[m] = INFINITY;
    nc[m] = 0.f;
    fpi[m] = INT_MAX;
    cni[m] = INT_MAX;
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // consecutive threads read consecutive k of one row: coalesced
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gi = row0 + r, gk = k0 + k;
        As[k][r] = (gi < n && gk < d)
                       ? to_f32(emb[(size_t)gi * d + gk]) : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int c = e / BK, k = e % BK;
        const int gj = col0 + c, gk = k0 + k;
        Bs[k][c] = (gj < n && gk < d)
                       ? to_f32(emb[(size_t)gj * d + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = As[k][ty * TM + m];
#pragma unroll
        for (int q = 0; q < TN; ++q) b[q] = Bs[k][tx + 32 * q];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
      }
      __syncthreads();
    }

    // epilogue: this thread's columns in ascending order
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int j = col0 + tx + 32 * q;
      if (j >= n) break;
      const float sqp = sq_pen[j];
      const long long lb = labels[j];
      const float vb = valid[j];
      const bool vj = vb > 0.f;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int i = row0 + ty * TM + m;
        const float dist = fmaxf((sqa[m] + sqp) - 2.f * acc[m][q], 0.f);
        const bool same = vj && la[m] == lb;
        const float pos = (same && i != j) ? dist : 0.f;
        const float neg = same ? POS_INF : dist;
        if (WITH_IDX) {
          if (pos > fp[m]) { fp[m] = pos; fpi[m] = j; }
          if (neg < cn[m]) { cn[m] = neg; cni[m] = j; }
        } else {
          fp[m] = fmaxf(fp[m], pos);
          cn[m] = fminf(cn[m], neg);
        }
        nc[m] += same ? 0.f : vb;
      }
    }
  }

  // merge the 32 column lanes of each row; ties go to the lower column
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ofp = __shfl_xor_sync(0xffffffffu, fp[m], off);
      const float ocn = __shfl_xor_sync(0xffffffffu, cn[m], off);
      nc[m] += __shfl_xor_sync(0xffffffffu, nc[m], off);
      if (WITH_IDX) {
        const int ofpi = __shfl_xor_sync(0xffffffffu, fpi[m], off);
        const int ocni = __shfl_xor_sync(0xffffffffu, cni[m], off);
        if (ofp > fp[m] || (ofp == fp[m] && ofpi < fpi[m])) {
          fp[m] = ofp; fpi[m] = ofpi;
        }
        if (ocn < cn[m] || (ocn == cn[m] && ocni < cni[m])) {
          cn[m] = ocn; cni[m] = ocni;
        }
      } else {
        fp[m] = fmaxf(fp[m], ofp);
        cn[m] = fminf(cn[m], ocn);
      }
    }
    const int i = row0 + ty * TM + m;
    if (tx == 0 && i < n) {
      fp_out[i] = fp[m];
      cn_out[i] = cn[m];
      nc_out[i] = nc[m];
      if (WITH_IDX) {
        fpi_out[i] = fpi[m];
        cni_out[i] = cni[m];
      }
    }
  }
}

template <typename T, bool WITH_IDX, int TM>
void launch(const void* emb, int n, int d, const float* sq,
            const float* sq_pen, const long long* labels, const float* valid,
            float* fp, float* cn, float* nc, int* fpi, int* cni,
            cudaStream_t stream) {
  constexpr int BM = WARPS * TM;
  const dim3 grid((n + BM - 1) / BM);
  batch_hard_stats_kernel<T, WITH_IDX, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(emb), n, d, sq, sq_pen, labels, valid, fp, cn,
      nc, fpi, cni);
}

template <typename T, bool WITH_IDX>
void launch_rows(const void* emb, int n, int d, const float* sq,
                 const float* sq_pen, const long long* labels,
                 const float* valid, float* fp, float* cn, float* nc,
                 int* fpi, int* cni, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 32-row CTAs once they alone fill every SM; 8-row CTAs below that, so
  // a small batch still spreads over the card
  if ((n + 31) / 32 >= sms)
    launch<T, WITH_IDX, 4>(emb, n, d, sq, sq_pen, labels, valid, fp, cn, nc,
                           fpi, cni, stream);
  else
    launch<T, WITH_IDX, 1>(emb, n, d, sq, sq_pen, labels, valid, fp, cn, nc,
                           fpi, cni, stream);
}

// ---------------------------------------------------------------- K3 ----

// (value, index) merge of a max (IS_MAX) or a min: the better value wins,
// a tie goes to the lower index, so the result does not depend on the
// order of the merges
template <bool IS_MAX>
__device__ __forceinline__ void merge_arg(float& v, int& i, float ov,
                                          int oi) {
  const bool better = IS_MAX ? ov > v : ov < v;
  if (better || (ov == v && oi < i)) { v = ov; i = oi; }
}

// B x B tile pair (ti <= tj) of the upper triangle; 16 x 16 threads, each
// TM x TM elements (B = 16 TM).  partial is [3][T][T][B] (fp, cn, nc) and,
// WITH_IDX, partial_idx [2][T][T][B] (fpi, cni): the row side of the pair
// fills entry [ti][tj], the column side [tj][ti].
template <typename T, bool WITH_IDX, int TM>
__global__ void __launch_bounds__(THREADS)
batch_hard_tri_kernel(const T* __restrict__ emb, int n, int d,
                      const float* __restrict__ sq,
                      const float* __restrict__ sq_pen,
                      const long long* __restrict__ labels,
                      const float* __restrict__ valid, int n_tiles,
                      float* __restrict__ partial,
                      int* __restrict__ partial_idx) {
  constexpr int R = 16, B = R * TM;
  __shared__ float As[BK][B + 1];
  __shared__ float Bs[BK][B + 1];
  __shared__ float colv[3][R][B];
  __shared__ int coli[WITH_IDX ? 2 : 1][R][B];

  // blockIdx.x -> (ti, tj), row-major over the upper triangle
  int ti = 0, rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int row0 = ti * B, col0 = tj * B;
  const bool off_diag = ti != tj;

  const int tid = threadIdx.x;
  const int tx = tid % R;
  const int ty = tid / R;

  float acc[TM][TM];
  tile_product<T, R, R, TM, TM>(emb, n, emb, n, d, row0, col0, As, Bs, acc);

  // both sides' per-entry data: rows i (anchors of the row side) and
  // columns j (anchors of the column side)
  float sq_i[TM], sp_i[TM], v_i[TM], sq_j[TM], sp_j[TM], v_j[TM];
  long long l_i[TM], l_j[TM];
  bool iin[TM], jin[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    const int i = row0 + ty * TM + t, j = col0 + tx + R * t;
    iin[t] = i < n;
    jin[t] = j < n;
    sq_i[t] = iin[t] ? sq[i] : 0.f;
    sp_i[t] = iin[t] ? sq_pen[i] : 0.f;
    v_i[t] = iin[t] ? valid[i] : 0.f;
    l_i[t] = iin[t] ? labels[i] : 0;
    sq_j[t] = jin[t] ? sq[j] : 0.f;
    sp_j[t] = jin[t] ? sq_pen[j] : 0.f;
    v_j[t] = jin[t] ? valid[j] : 0.f;
    l_j[t] = jin[t] ? labels[j] : 0;
  }
  // row side per row m, column side per column q: (max, arg), (min, arg),
  // negative count
  float rf[TM], rc[TM], rn[TM], cf[TM], cc[TM], cn[TM];
  int rfi[TM], rci[TM], cfi[TM], cci[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    rf[t] = cf[t] = -INFINITY;
    rc[t] = cc[t] = INFINITY;
    rn[t] = cn[t] = 0.f;
    rfi[t] = rci[t] = cfi[t] = cci[t] = INT_MAX;
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty * TM + m;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      if (!iin[m] || !jin[q]) continue;
      const int j = col0 + tx + R * q;
      // K1's epilogue for anchor i over candidate j, bit for bit
      const float dr = fmaxf((sq_i[m] + sp_j[q]) - 2.f * acc[m][q], 0.f);
      const bool sr = v_j[q] > 0.f && l_i[m] == l_j[q];
      const float pr = (sr && i != j) ? dr : 0.f;
      const float nr = sr ? POS_INF : dr;
      // columns ascend with q: a strict compare keeps the lowest
      if (WITH_IDX) {
        if (pr > rf[m]) { rf[m] = pr; rfi[m] = j; }
        if (nr < rc[m]) { rc[m] = nr; rci[m] = j; }
      } else {
        rf[m] = fmaxf(rf[m], pr);
        rc[m] = fminf(rc[m], nr);
      }
      rn[m] += sr ? 0.f : v_j[q];
      if (!off_diag) continue;   // the diagonal's row side covers both ways
      // ... and for anchor j over candidate i, from the same product
      const float dc = fmaxf((sq_j[q] + sp_i[m]) - 2.f * acc[m][q], 0.f);
      const bool sc = v_i[m] > 0.f && l_j[q] == l_i[m];
      const float pc = (sc && i != j) ? dc : 0.f;
      const float nq = sc ? POS_INF : dc;
      // rows ascend with m: a strict compare keeps the lowest
      if (WITH_IDX) {
        if (pc > cf[q]) { cf[q] = pc; cfi[q] = i; }
        if (nq < cc[q]) { cc[q] = nq; cci[q] = i; }
      } else {
        cf[q] = fmaxf(cf[q], pc);
        cc[q] = fminf(cc[q], nq);
      }
      cn[q] += sc ? 0.f : v_i[m];
    }
  }

  const size_t plane = (size_t)n_tiles * n_tiles * B;
  // row side: the 16 lanes of a half-warp share ty and hold its columns
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ofp = __shfl_xor_sync(0xffffffffu, rf[m], off);
      const float ocn = __shfl_xor_sync(0xffffffffu, rc[m], off);
      rn[m] += __shfl_xor_sync(0xffffffffu, rn[m], off);
      if (WITH_IDX) {
        const int ofpi = __shfl_xor_sync(0xffffffffu, rfi[m], off);
        const int ocni = __shfl_xor_sync(0xffffffffu, rci[m], off);
        merge_arg<true>(rf[m], rfi[m], ofp, ofpi);
        merge_arg<false>(rc[m], rci[m], ocn, ocni);
      } else {
        rf[m] = fmaxf(rf[m], ofp);
        rc[m] = fminf(rc[m], ocn);
      }
    }
    if (tx == 0 && iin[m]) {
      const size_t at = ((size_t)ti * n_tiles + tj) * B + ty * TM + m;
      partial[at] = rf[m];
      partial[plane + at] = rc[m];
      partial[2 * plane + at] = rn[m];
      if (WITH_IDX) {
        partial_idx[at] = rfi[m];
        partial_idx[plane + at] = rci[m];
      }
    }
  }
  if (!off_diag) return;
  // column side: merge the 16 row groups of each column
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    colv[0][ty][tx + R * q] = cf[q];
    colv[1][ty][tx + R * q] = cc[q];
    colv[2][ty][tx + R * q] = cn[q];
    if (WITH_IDX) {
      coli[0][ty][tx + R * q] = cfi[q];
      coli[1][ty][tx + R * q] = cci[q];
    }
  }
  __syncthreads();
  if (tid < B && col0 + tid < n) {
    const int c = tid;
    float f = -INFINITY, v = INFINITY, s = 0.f;
    int fi = INT_MAX, vi = INT_MAX;
#pragma unroll
    for (int y = 0; y < R; ++y) {
      s += colv[2][y][c];
      if (WITH_IDX) {
        merge_arg<true>(f, fi, colv[0][y][c], coli[0][y][c]);
        merge_arg<false>(v, vi, colv[1][y][c], coli[1][y][c]);
      } else {
        f = fmaxf(f, colv[0][y][c]);
        v = fminf(v, colv[1][y][c]);
      }
    }
    const size_t at = ((size_t)tj * n_tiles + ti) * B + c;
    partial[at] = f;
    partial[plane + at] = v;
    partial[2 * plane + at] = s;
    if (WITH_IDX) {
      partial_idx[at] = fi;
      partial_idx[plane + at] = vi;
    }
  }
}

// row i's stats from partial[.][i / B][0..T-1][i % B], in ascending tile
// order: every tile b covers higher candidates than tile b - 1, so a strict
// compare keeps K1's lowest column
template <bool WITH_IDX>
__global__ void __launch_bounds__(THREADS)
batch_hard_tri_combine(const float* __restrict__ partial,
                       const int* __restrict__ partial_idx, int n,
                       int n_tiles, int block, float* __restrict__ fp_out,
                       float* __restrict__ cn_out, float* __restrict__ nc_out,
                       int* __restrict__ fpi_out, int* __restrict__ cni_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int a = i / block, r = i % block;
  const size_t plane = (size_t)n_tiles * n_tiles * block;
  float fp = -INFINITY, cn = INFINITY, nc = 0.f;
  int fpi = INT_MAX, cni = INT_MAX;
  // unrolled so that the loads of several tiles are in flight at once
#pragma unroll 8
  for (int b = 0; b < n_tiles; ++b) {
    const size_t at = ((size_t)a * n_tiles + b) * block + r;
    const float f = partial[at], c = partial[plane + at];
    nc += partial[2 * plane + at];
    if (WITH_IDX) {
      if (f > fp) { fp = f; fpi = partial_idx[at]; }
      if (c < cn) { cn = c; cni = partial_idx[plane + at]; }
    } else {
      fp = fmaxf(fp, f);
      cn = fminf(cn, c);
    }
  }
  fp_out[i] = fp;
  cn_out[i] = cn;
  nc_out[i] = nc;
  if (WITH_IDX) {
    fpi_out[i] = fpi;
    cni_out[i] = cni;
  }
}

template <typename T, bool WITH_IDX, int TM>
void launch_tri(const void* emb, int n, int d, const float* sq,
                const float* sq_pen, const long long* labels,
                const float* valid, float* partial, int* partial_idx,
                float* fp, float* cn, float* nc, int* fpi, int* cni,
                cudaStream_t s) {
  constexpr int B = 16 * TM;
  const int n_tiles = (n + B - 1) / B;
  batch_hard_tri_kernel<T, WITH_IDX, TM>
      <<<n_tiles * (n_tiles + 1) / 2, THREADS, 0, s>>>(
          static_cast<const T*>(emb), n, d, sq, sq_pen, labels, valid,
          n_tiles, partial, partial_idx);
  batch_hard_tri_combine<WITH_IDX><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                     s>>>(partial, partial_idx, n, n_tiles, B,
                                          fp, cn, nc, fpi, cni);
}

template <typename T, bool WITH_IDX>
void launch_tri_block(int block, const void* emb, int n, int d,
                      const float* sq, const float* sq_pen,
                      const long long* labels, const float* valid,
                      float* partial, int* partial_idx, float* fp, float* cn,
                      float* nc, int* fpi, int* cni, cudaStream_t s) {
  if (block == 64)
    launch_tri<T, WITH_IDX, 4>(emb, n, d, sq, sq_pen, labels, valid, partial,
                               partial_idx, fp, cn, nc, fpi, cni, s);
  else
    launch_tri<T, WITH_IDX, 2>(emb, n, d, sq, sq_pen, labels, valid, partial,
                               partial_idx, fp, cn, nc, fpi, cni, s);
}

// ------------------------------------------- bf16 on the tensor cores ----

constexpr int TC_BN = 128;   // K1's column tile: one m64n128 per k16 step

// Row or column i's side data for the tensor-core epilogues, (sq, sq_pen,
// valid, 1) and the label, zeros past n.  Each consumer thread loads one
// entry before it waits for a tile's products, so the loads' latency hides
// behind the tensor cores; the entries then go to shared memory, where
// every thread of the epilogue reads the ones it needs.
__device__ __forceinline__ void load_side(const float* __restrict__ sq,
                                          const float* __restrict__ sq_pen,
                                          const float* __restrict__ valid,
                                          const long long* __restrict__ labels,
                                          int i, int n, float4& f,
                                          long long& lab) {
  if (i < n) {
    f = make_float4(sq[i], sq_pen[i], valid[i], 1.f);
    lab = labels[i];
  } else {
    f = make_float4(0.f, 0.f, 0.f, 0.f);
    lab = 0;
  }
}

// K1/K2: one CTA per 64-row block, one consumer warpgroup walking the
// 128-column tiles in ascending order, and the producer warp after it.
// d is a multiple of 8 (the wrapper pads), the map covers emb [n, d].  Each tile's column data sits in one
// of two shared-memory buffers (tile parity), so one barrier per tile
// keeps a buffer from being refilled while it is read.
constexpr int TC_ROWS_EXTRA = 2 * TC_BN * (16 + 8);

template <bool WITH_IDX>
__global__ void __launch_bounds__(128 + 32, 2)
batch_hard_stats_tc(const __grid_constant__ CUtensorMap map, int n, int d,
                    const float* __restrict__ sq,
                    const float* __restrict__ sq_pen,
                    const long long* __restrict__ labels,
                    const float* __restrict__ valid,
                    float* __restrict__ fp_out, float* __restrict__ cn_out,
                    float* __restrict__ nc_out, int* __restrict__ fpi_out,
                    int* __restrict__ cni_out) {
  using Ring = msim::WgRing<msim::WG_BOX, TC_BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const Ring ring{msim::smem_u32(smem)};
  float4* col_info = reinterpret_cast<float4*>(smem + Ring::BYTES);  // [2][BN]
  long long* col_lab = reinterpret_cast<long long*>(col_info + 2 * TC_BN);
  if (threadIdx.x == 0) ring.init(128);
  __syncthreads();

  const int k_slices = (d + msim::WG_BK - 1) / msim::WG_BK;
  const int n_tiles = (n + TC_BN - 1) / TC_BN;
  const int row0 = blockIdx.x * msim::WG_BOX;
  if (threadIdx.x >= 128) {   // the producer warp: one thread loads
    if (threadIdx.x == 128) {
      int it = 0;
      for (int t = 0; t < n_tiles; ++t)
        ring.load(&map, it, row0, t * TC_BN, n, k_slices);
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this thread's two fragment rows
  float sqa[2], fp[2], cn[2], nc[2];
  long long la[2];
  int ia[2], fpi[2], cni[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ia[h] = row0 + 16 * warp + (lane >> 2) + 8 * h;
    sqa[h] = ia[h] < n ? sq[ia[h]] : 0.f;
    la[h] = ia[h] < n ? labels[ia[h]] : 0;
    fp[h] = -INFINITY;
    cn[h] = INFINITY;
    nc[h] = 0.f;
    fpi[h] = cni[h] = INT_MAX;
  }

  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float4 side;
    long long side_lab;
    load_side(sq, sq_pen, valid, labels, t * TC_BN + threadIdx.x, n, side,
              side_lab);
    float acc[TC_BN / 2];
    ring.product(acc, it, k_slices);
    float4* info = col_info + (t & 1) * TC_BN;
    long long* lab = col_lab + (t & 1) * TC_BN;
    info[threadIdx.x] = side;
    lab[threadIdx.x] = side_lab;
    msim::bar_sync(1, 128);
    // epilogue: this thread's columns in ascending order, without
    // branches (a column past n gets -inf / +inf, which never win, and a
    // valid flag of 0; a row past n is computed and never stored)
#pragma unroll
    for (int g = 0; g < TC_BN / 8; ++g) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * g + 2 * (lane & 3) + c;
        const int j = t * TC_BN + col;
        const float4 side_j = info[col];
        const float sqp = side_j.y, vb = side_j.z;
        const bool jin = side_j.w > 0.f;
        const long long lb = lab[col];
        const bool vj = vb > 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // (sq[i] + sq_pen[j]) - 2 acc, one rounding: 2 acc is exact
          const float dist = fmaxf(
              __fmaf_rn(-2.f, acc[4 * g + 2 * h + c], sqa[h] + sqp), 0.f);
          const bool same = vj && la[h] == lb;
          const float pos =
              jin ? ((same && ia[h] != j) ? dist : 0.f) : -INFINITY;
          const float neg = jin ? (same ? POS_INF : dist) : INFINITY;
          if (WITH_IDX) {
            if (pos > fp[h]) { fp[h] = pos; fpi[h] = j; }
            if (neg < cn[h]) { cn[h] = neg; cni[h] = j; }
          } else {
            fp[h] = fmaxf(fp[h], pos);
            cn[h] = fminf(cn[h], neg);
          }
          nc[h] += same ? 0.f : vb;
        }
      }
    }
  }

  // merge the quad of lanes that share the rows; ties go to the lower
  // column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ofp = __shfl_xor_sync(0xffffffffu, fp[h], off);
      const float ocn = __shfl_xor_sync(0xffffffffu, cn[h], off);
      nc[h] += __shfl_xor_sync(0xffffffffu, nc[h], off);
      if (WITH_IDX) {
        const int ofpi = __shfl_xor_sync(0xffffffffu, fpi[h], off);
        const int ocni = __shfl_xor_sync(0xffffffffu, cni[h], off);
        merge_arg<true>(fp[h], fpi[h], ofp, ofpi);
        merge_arg<false>(cn[h], cni[h], ocn, ocni);
      } else {
        fp[h] = fmaxf(fp[h], ofp);
        cn[h] = fminf(cn[h], ocn);
      }
    }
    if ((lane & 3) == 0 && ia[h] < n) {
      fp_out[ia[h]] = fp[h];
      cn_out[ia[h]] = cn[h];
      nc_out[ia[h]] = nc[h];
      if (WITH_IDX) {
        fpi_out[ia[h]] = fpi[h];
        cni_out[ia[h]] = cni[h];
      }
    }
  }
}

// A walk over the T(T+1)/2 upper-triangle tile pairs in row-major order,
// from pair `first` in steps of `step`: (ti, tj) of the current pair, each
// step advancing row by row from the last.
struct PairWalk {
  int n_tiles, ti, rem;   // rem: the pair's offset in row ti

  __device__ PairWalk(int n_tiles_, int first)
      : n_tiles(n_tiles_), ti(0), rem(first) {
    settle();
  }
  __device__ void settle() {
    while (ti < n_tiles && rem >= n_tiles - ti) {
      rem -= n_tiles - ti;
      ++ti;
    }
  }
  __device__ bool done() const { return ti >= n_tiles; }
  __device__ int tj() const { return ti + rem; }
  __device__ void advance(int step) {
    rem += step;
    settle();
  }
};

// K3 on the tensor cores: B x B tile pairs, B = 64 NWG, in three roles.
// NWG MMA warpgroups (64 rows each) issue the products and run the row
// side on the accumulator fragment in registers; NWG column warpgroups run
// the column side from the product tile in shared memory, each thread
// walking half a column in ascending rows; one producer warp keeps the
// TMA loads in flight.  Persistent: CTA b takes pairs b, b + grid, ... in
// order.  Off the diagonal the MMA warpgroups store the tile once the
// column warpgroups have released the last one (mbarriers tile_full and
// tile_empty) and go on to the next pair, so the products, the row side
// and the column side of successive pairs overlap.  Side data as K1's.
// Partials as batch_hard_tri_kernel.
template <int B>
struct TriSmem {
  static constexpr int PITCH = B + 8;  // floats: conflict-free float2 stores
  static constexpr int EXTRA = B * PITCH * 4   // the product tile
                               + 3 * B * 16    // side data: MMA rows and
                               + 3 * B * 8     // columns, column-side rows
                               + 5 * B * 4     // the upper half-columns
                               + 16;           // tile_full, tile_empty
};

template <bool WITH_IDX, int NWG>
__global__ void __launch_bounds__(NWG * 256 + 32, 1)
batch_hard_tri_tc(const __grid_constant__ CUtensorMap map, int n, int d,
                  const float* __restrict__ sq,
                  const float* __restrict__ sq_pen,
                  const long long* __restrict__ labels,
                  const float* __restrict__ valid, int n_tiles,
                  float* __restrict__ partial,
                  int* __restrict__ partial_idx) {
  constexpr int B = msim::WG_BOX * NWG;
  constexpr int MT = NWG * 128;   // threads of each role's warpgroups, 2 B
  constexpr int PITCH = TriSmem<B>::PITCH;
  using Ring = msim::WgRing<B, B>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const Ring ring{msim::smem_u32(smem)};
  float* tile = reinterpret_cast<float*>(smem + Ring::BYTES);  // [B][PITCH]
  float4* m_info = reinterpret_cast<float4*>(tile + B * PITCH);  // rows, cols
  float4* c_info = m_info + 2 * B;                               // rows
  long long* m_lab = reinterpret_cast<long long*>(c_info + B);
  long long* c_lab = m_lab + 2 * B;
  float* half_v = reinterpret_cast<float*>(c_lab + B);       // [3][B]
  int* half_i = reinterpret_cast<int*>(half_v + 3 * B);      // [2][B]
  const uint32_t tile_full = msim::smem_u32(half_i + 2 * B);
  const uint32_t tile_empty = tile_full + 8;
  if (threadIdx.x == 0) {
    msim::mbar_init(tile_full, MT);
    msim::mbar_init(tile_empty, MT);
    ring.init(MT);   // ends with the barrier-init fence
  }
  __syncthreads();

  const int k_slices = (d + msim::WG_BK - 1) / msim::WG_BK;
  const size_t plane = (size_t)n_tiles * n_tiles * B;

  // two warpgroups of each role and the producer warp take 96 registers a
  // thread at launch (launch bounds); they are moved to the accumulators
  constexpr bool REBALANCE = NWG == 2;
  if (threadIdx.x >= 2 * MT) {   // the producer warp: one thread loads
    if (REBALANCE) msim::set_max_regs_dec<40>();
    if (threadIdx.x == 2 * MT) {
      int it = 0;
      for (PairWalk w(n_tiles, blockIdx.x); !w.done(); w.advance(gridDim.x))
        ring.load(&map, it, w.ti * B, w.tj() * B, n, k_slices);
    }
    return;
  }

  if (threadIdx.x >= MT) {
    // ---- column warpgroups: anchor j = col0 + c over the candidates i of
    // half `half` of the tile's rows, ascending (off the diagonal i < j)
    if (REBALANCE) msim::set_max_regs_dec<80>();
    const int t = threadIdx.x - MT;
    const int c = t % B, half = t / B;
    int od = 0;   // off-diagonal pairs done
    for (PairWalk w(n_tiles, blockIdx.x); !w.done(); w.advance(gridDim.x)) {
      const int ti = w.ti, tj = w.tj();
      if (ti == tj) continue;   // the diagonal's row side covers both ways
      const int row0 = ti * B, j = tj * B + c;
      float4 side;
      long long side_lab;
      if (t < B) load_side(sq, sq_pen, valid, labels, row0 + t, n, side,
                           side_lab);
      const float sq_j = j < n ? sq[j] : 0.f;
      const long long l_j = j < n ? labels[j] : 0;
      msim::mbar_wait(tile_full, od & 1);
      if (t < B) {
        c_info[t] = side;
        c_lab[t] = side_lab;
      }
      msim::bar_sync(2, MT);
      float cf = -INFINITY, cc = INFINITY, cs = 0.f;
      int cfi = INT_MAX, cci = INT_MAX;
#pragma unroll 8
      for (int r = half * (B / 2); r < (half + 1) * (B / 2); ++r) {
        const float4 side_i = c_info[r];
        const float sp_i = side_i.y, v_i = side_i.z;
        const bool rin = side_i.w > 0.f;   // a row past n never wins
        // K1's epilogue for anchor j over candidate i, from the same
        // product bits
        const float dc = fmaxf(
            __fmaf_rn(-2.f, tile[r * PITCH + c], sq_j + sp_i), 0.f);
        const bool sc = v_i > 0.f && l_j == c_lab[r];
        const float pc = rin ? (sc ? dc : 0.f) : -INFINITY;
        const float nq = rin ? (sc ? POS_INF : dc) : INFINITY;
        if (WITH_IDX) {
          if (pc > cf) { cf = pc; cfi = row0 + r; }
          if (nq < cc) { cc = nq; cci = row0 + r; }
        } else {
          cf = fmaxf(cf, pc);
          cc = fminf(cc, nq);
        }
        cs += sc ? 0.f : v_i;
      }
      msim::mbar_arrive(tile_empty);   // this thread is done with the tile
      if (half == 1) {
        half_v[c] = cf;
        half_v[B + c] = cc;
        half_v[2 * B + c] = cs;
        if (WITH_IDX) {
          half_i[c] = cfi;
          half_i[B + c] = cci;
        }
      }
      msim::bar_sync(2, MT);
      if (half == 0 && j < n) {
        if (WITH_IDX) {
          merge_arg<true>(cf, cfi, half_v[c], half_i[c]);
          merge_arg<false>(cc, cci, half_v[B + c], half_i[B + c]);
        } else {
          cf = fmaxf(cf, half_v[c]);
          cc = fminf(cc, half_v[B + c]);
        }
        cs += half_v[2 * B + c];
        const size_t at = ((size_t)tj * n_tiles + ti) * B + c;
        partial[at] = cf;
        partial[plane + at] = cc;
        partial[2 * plane + at] = cs;
        if (WITH_IDX) {
          partial_idx[at] = cfi;
          partial_idx[plane + at] = cci;
        }
      }
      ++od;
    }
    return;
  }

  // ---- MMA warpgroups: the products, then the row side in registers
  if (REBALANCE) msim::set_max_regs_inc<112>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // threads [0, B) carry a row's side data, [B, 2B) a column's
  const int e = threadIdx.x % B;
  const bool is_row = threadIdx.x < B;
  float4* row_info = m_info;
  float4* col_info = m_info + B;
  const long long* row_lab = m_lab;
  const long long* col_lab = m_lab + B;
  int it = 0, od = 0;
  for (PairWalk w(n_tiles, blockIdx.x); !w.done(); w.advance(gridDim.x)) {
    const int ti = w.ti, tj = w.tj();
    const int row0 = ti * B, col0 = tj * B;
    const bool off_diag = ti != tj;   // uniform over the CTA

    float4 side;
    long long side_lab;
    load_side(sq, sq_pen, valid, labels, (is_row ? row0 : col0) + e, n, side,
              side_lab);
    float acc[B / 2];
    ring.product(acc, it, k_slices);

    // the previous pair's row side is done with the side data
    msim::bar_sync(1, MT);
    m_info[threadIdx.x] = side;   // rows then columns, as row/col_info
    m_lab[threadIdx.x] = side_lab;
    if (off_diag) {
      // the column side has released the last tile (passes at once for
      // the first)
      msim::mbar_wait(tile_empty, (od & 1) ^ 1);
#pragma unroll
      for (int g = 0; g < B / 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              &tile[(16 * warp + (lane >> 2) + 8 * h) * PITCH + 8 * g +
                    2 * (lane & 3)]) =
              make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
      msim::mbar_arrive(tile_full);
      ++od;
    }
    msim::bar_sync(1, MT);

    // row side: this thread's two fragment rows over its columns, without
    // branches (as K1's: a column past n never wins, a row past n is never
    // stored)
    float sq_i[2], rf[2], rc[2], rn[2];
    long long l_i[2];
    int ia[2], rfi[2], rci[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      ia[h] = row0 + r;
      sq_i[h] = row_info[r].x;
      l_i[h] = row_lab[r];
      rf[h] = -INFINITY;
      rc[h] = INFINITY;
      rn[h] = 0.f;
      rfi[h] = rci[h] = INT_MAX;
    }
#pragma unroll
    for (int g = 0; g < B / 8; ++g) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * g + 2 * (lane & 3) + c;
        const int j = col0 + col;
        const float4 side_j = col_info[col];
        const float sp_j = side_j.y, v_j = side_j.z;
        const bool jin = side_j.w > 0.f;
        const long long l_j = col_lab[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // K1's epilogue for anchor i over candidate j, bit for bit
          const float dr = fmaxf(
              __fmaf_rn(-2.f, acc[4 * g + 2 * h + c], sq_i[h] + sp_j), 0.f);
          const bool sr = v_j > 0.f && l_i[h] == l_j;
          const float pr = jin ? ((sr && ia[h] != j) ? dr : 0.f) : -INFINITY;
          const float nr = jin ? (sr ? POS_INF : dr) : INFINITY;
          // columns ascend with (g, c): a strict compare keeps the lowest
          if (WITH_IDX) {
            if (pr > rf[h]) { rf[h] = pr; rfi[h] = j; }
            if (nr < rc[h]) { rc[h] = nr; rci[h] = j; }
          } else {
            rf[h] = fmaxf(rf[h], pr);
            rc[h] = fminf(rc[h], nr);
          }
          rn[h] += sr ? 0.f : v_j;
        }
      }
    }
    // ... merged over the quad of lanes that share the rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ofp = __shfl_xor_sync(0xffffffffu, rf[h], off);
        const float ocn = __shfl_xor_sync(0xffffffffu, rc[h], off);
        rn[h] += __shfl_xor_sync(0xffffffffu, rn[h], off);
        if (WITH_IDX) {
          const int ofpi = __shfl_xor_sync(0xffffffffu, rfi[h], off);
          const int ocni = __shfl_xor_sync(0xffffffffu, rci[h], off);
          merge_arg<true>(rf[h], rfi[h], ofp, ofpi);
          merge_arg<false>(rc[h], rci[h], ocn, ocni);
        } else {
          rf[h] = fmaxf(rf[h], ofp);
          rc[h] = fminf(rc[h], ocn);
        }
      }
      if ((lane & 3) == 0 && ia[h] < n) {
        const size_t at = ((size_t)ti * n_tiles + tj) * B + (ia[h] - row0);
        partial[at] = rf[h];
        partial[plane + at] = rc[h];
        partial[2 * plane + at] = rn[h];
        if (WITH_IDX) {
          partial_idx[at] = rfi[h];
          partial_idx[plane + at] = rci[h];
        }
      }
    }
  }
}

// dynamic shared memory of a ring plus `extra` bytes, with room to align
template <int A_ROWS, int B_ROWS>
constexpr int tc_smem(int extra) {
  return msim::WgRing<A_ROWS, B_ROWS>::BYTES + extra + 1024;
}

template <bool WITH_IDX>
int launch_rows_tc(const void* emb, int n, int d, const float* sq,
                   const float* sq_pen, const long long* labels,
                   const float* valid, float* fp, float* cn, float* nc,
                   int* fpi, int* cni, cudaStream_t s) {
  CUtensorMap map;
  const int rc = msim::make_tensor_map(&map, emb, n, d);
  if (rc != 0) return rc;
  constexpr int smem = tc_smem<msim::WG_BOX, TC_BN>(TC_ROWS_EXTRA);
  auto kernel = batch_hard_stats_tc<WITH_IDX>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<(n + msim::WG_BOX - 1) / msim::WG_BOX, 128 + 32, smem, s>>>(
      map, n, d, sq, sq_pen, labels, valid, fp, cn, nc, fpi, cni);
  return 0;
}

template <bool WITH_IDX, int NWG>
int launch_tri_tc(const void* emb, int n, int d, const float* sq,
                  const float* sq_pen, const long long* labels,
                  const float* valid, float* partial, int* partial_idx,
                  float* fp, float* cn, float* nc, int* fpi, int* cni,
                  cudaStream_t s) {
  constexpr int B = msim::WG_BOX * NWG;
  CUtensorMap map;
  const int rc = msim::make_tensor_map(&map, emb, n, d);
  if (rc != 0) return rc;
  constexpr int smem = tc_smem<B, B>(TriSmem<B>::EXTRA);
  auto kernel = batch_hard_tri_tc<WITH_IDX, NWG>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  // persistent: as many CTAs as fit on the card at once, or one per pair
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                NWG * 256 + 32, smem);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int n_tiles = (n + B - 1) / B;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  kernel<<<n_pairs < resident ? n_pairs : resident, NWG * 256 + 32, smem,
           s>>>(map, n, d, sq, sq_pen, labels, valid, n_tiles, partial,
                partial_idx);
  batch_hard_tri_combine<WITH_IDX><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                     s>>>(partial, partial_idx, n, n_tiles, B,
                                          fp, cn, nc, fpi, cni);
  return 0;
}

// TMA's rules for the bf16 operand: d > 0 a multiple of 8 (16-byte rows),
// a 16-byte aligned base
bool tma_operand_ok(const void* emb, int d) {
  return d > 0 && d % 8 == 0 &&
         reinterpret_cast<uintptr_t>(emb) % 16 == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: emb [n, d] (bf16 when emb_is_bf16, else f32), sq,
// sq_pen, valid [n] f32, labels [n] int64; outputs fp, cn, nc [n] f32 and,
// when with_idx, fpi, cni [n] int32.  A bf16 emb needs d a multiple of 8
// and a 16-byte aligned base (the tensor cores' TMA loads).  Launches on
// `stream` without synchronising and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bf16 operand TMA cannot take, or
// msim::ENCODE_ERROR (+ the CUresult of cuTensorMapEncodeTiled) when its
// tensor map cannot be built.
extern "C" int batch_hard_stats(const void* emb, int emb_is_bf16, int n,
                                int d, const float* sq, const float* sq_pen,
                                const long long* labels, const float* valid,
                                float* fp, float* cn, float* nc, int* fpi,
                                int* cni, int with_idx, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emb_is_bf16) {
    if (!tma_operand_ok(emb, d))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc =
        with_idx ? launch_rows_tc<true>(emb, n, d, sq, sq_pen, labels, valid,
                                        fp, cn, nc, fpi, cni, s)
                 : launch_rows_tc<false>(emb, n, d, sq, sq_pen, labels, valid,
                                         fp, cn, nc, fpi, cni, s);
    if (rc != 0) return rc;
  } else {
    if (with_idx)
      launch_rows<float, true>(emb, n, d, sq, sq_pen, labels, valid, fp, cn,
                               nc, fpi, cni, s);
    else
      launch_rows<float, false>(emb, n, d, sq, sq_pen, labels, valid, fp, cn,
                                nc, fpi, cni, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: the same outputs through the partials buffers, partial at least
// 3 * T * T * block floats and, when with_idx, partial_idx 2 * T * T * block
// ints, T = ceil(n / block); block is 64 or 128 for bf16 (the tensor
// cores; the operand as for batch_hard_stats), 32 or 64 for f32.  Two
// launches: the tile walk, then the ascending-order combine.
extern "C" int batch_hard_tri(const void* emb, int emb_is_bf16, int n, int d,
                              int block, const float* sq, const float* sq_pen,
                              const long long* labels, const float* valid,
                              float* partial, int* partial_idx, float* fp,
                              float* cn, float* nc, int* fpi, int* cni,
                              int with_idx, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emb_is_bf16) {
    if ((block != 64 && block != 128) || !tma_operand_ok(emb, d))
      return static_cast<int>(cudaErrorInvalidValue);
    int rc;
    if (block == 128)
      rc = with_idx ? launch_tri_tc<true, 2>(emb, n, d, sq, sq_pen, labels,
                                             valid, partial, partial_idx, fp,
                                             cn, nc, fpi, cni, s)
                    : launch_tri_tc<false, 2>(emb, n, d, sq, sq_pen, labels,
                                              valid, partial, partial_idx, fp,
                                              cn, nc, fpi, cni, s);
    else
      rc = with_idx ? launch_tri_tc<true, 1>(emb, n, d, sq, sq_pen, labels,
                                             valid, partial, partial_idx, fp,
                                             cn, nc, fpi, cni, s)
                    : launch_tri_tc<false, 1>(emb, n, d, sq, sq_pen, labels,
                                              valid, partial, partial_idx, fp,
                                              cn, nc, fpi, cni, s);
    if (rc != 0) return rc;
  } else {
    if (block != 32 && block != 64)
      return static_cast<int>(cudaErrorInvalidValue);
    if (with_idx)
      launch_tri_block<float, true>(block, emb, n, d, sq, sq_pen, labels,
                                    valid, partial, partial_idx, fp, cn, nc,
                                    fpi, cni, s);
    else
      launch_tri_block<float, false>(block, emb, n, d, sq, sq_pen, labels,
                                     valid, partial, partial_idx, fp, cn, nc,
                                     fpi, cni, s);
  }
  return static_cast<int>(cudaGetLastError());
}
