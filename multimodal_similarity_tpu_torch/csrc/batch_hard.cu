// Fused pairwise squared distance + batch-hard reduction for Hopper (sm_90a).
//
// Replaces the TPU kernels of multimodal_similarity_tpu/ops/pallas/:
//   batch_hard_stats_kernel (K1, K2), the row walk:
//     WITH_IDX = true   -> batch_hard.py:110 _stats_kernel
//                          (via _stats_pallas :250)
//     WITH_IDX = false  -> batch_hard.py:151 _stats_kernel_noidx
//                          (via _stats_pallas_noidx :222)
//   batch_hard_tri_kernel + batch_hard_tri_combine (K3), the triangle walk:
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
// Design.  The N x N matrix never reaches global memory.  One CTA owns BM
// anchor rows and loops over all column tiles (the TPU's sequential "j"
// grid axis).  Each [BM, d] x [d, BN] tile product is built from BK-deep
// shared-memory slices with f32 FMA; the mask-and-reduce epilogue runs in
// registers.  Every thread keeps running (value, column) pairs for its TM
// rows over the columns it owns (tx, tx+32, tx+64, tx+96 of every tile,
// visited in ascending order, so a strict compare keeps the lowest column);
// one warp-shuffle reduction at the end merges the 32 column lanes with an
// explicit lowest-index tie break.  No atomics, no cross-CTA combine: the
// result is deterministic.
//
// Precision.  bf16 operands are products of bf16 values summed in f32
// (exact products, f32 accumulation); f32 operands are full-f32 FMA, no
// TF32.  The distance epilogue is f32 in both modes (the TPU kernel ran it
// in bf16 to pack its vector registers; Hopper has no such reason).
//
// Bound on an H100 (SXM, 700 W).  The main path calls this at N=512,
// d=128 in bf16: 2*N*N*d = 67 MFLOP and about 130 KB of inputs and outputs,
// i.e. under 0.1 us of either tensor-core time or HBM time, so the call is
// bound by launch latency and by how many SMs it can occupy.  The design
// answers with small CTAs at small N (BM = 8 rows, 64 CTAs at N=512) and
// 32-row CTAs once the grid fills the card.  At N=8192 and d=1024 the
// operation count dominates; this first kernel uses FMA, not the tensor
// cores (wgmma/TMA are later work), so it is far from the bf16 bound there.
// Shared memory is not the constraint on Hopper (21 KB of 227 KB per CTA);
// the tile sizes were chosen for occupancy and bank-conflict-free access.
//
// K3 (triangular).  dist(i, j) = dist(j, i) up to the norm terms, and the
// product <e_i, e_j> is one ascending-k fmaf chain in csrc/tile.cuh, the
// chain K1 runs, whose bits do not depend on which side is the anchor.  So
// one CTA per upper-triangle tile pair (ti <= tj) of B x B computes the
// product once and runs K1's epilogue both ways: for anchors i over
// candidates j, max((sq[i] + sq_pen[j]) - 2 acc, 0), and (off the diagonal)
// for anchors j over candidates i, max((sq[j] + sq_pen[i]) - 2 acc, 0).
// (The TPU's additive-penalty form, dist + pen, would round differently on
// invalid columns.)  The row side's (value, index) pairs go to
// partial[ti][tj], the column side's to partial[tj][ti] of [planes, T, T, B]
// buffers the wrapper allocates: fp, cn, nc, plus fpi and cni WITH_IDX.
// Every entry is written exactly once, so nothing needs clearing, and no
// float atomics are used.  A second pass merges partial[a][0..T-1] in
// ascending b with a strict compare; inside a tile every merge breaks ties
// on the lower index (on the column side, the lower row, as at
// batch_hard_tri.py:170-184).  Values, negative counts and winners are
// therefore bit-equal to K1/K2 (negative counts for 0/1 valid flags, whose
// sums are exact in any order).  Half of K1's products, at the cost of a
// second epilogue per visited pair, 5 T^2 B words of partials (about
// 5 N^2 / B * 4 bytes with winners) and a second launch.  B is 32 or 64;
// the wrapper chooses and allocates.  Shared memory: 37 KB per CTA at
// B = 64 with winners.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>

#include "tile.cuh"

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

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: emb [n, d] (bf16 when emb_is_bf16, else f32), sq,
// sq_pen, valid [n] f32, labels [n] int64; outputs fp, cn, nc [n] f32 and,
// when with_idx, fpi, cni [n] int32.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int batch_hard_stats(const void* emb, int emb_is_bf16, int n,
                                int d, const float* sq, const float* sq_pen,
                                const long long* labels, const float* valid,
                                float* fp, float* cn, float* nc, int* fpi,
                                int* cni, int with_idx, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emb_is_bf16) {
    if (with_idx)
      launch_rows<__nv_bfloat16, true>(emb, n, d, sq, sq_pen, labels, valid,
                                       fp, cn, nc, fpi, cni, s);
    else
      launch_rows<__nv_bfloat16, false>(emb, n, d, sq, sq_pen, labels, valid,
                                        fp, cn, nc, fpi, cni, s);
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
// ints, T = ceil(n / block); block is 32 or 64.  Two launches: the tile
// walk, then the ascending-order combine.
extern "C" int batch_hard_tri(const void* emb, int emb_is_bf16, int n, int d,
                              int block, const float* sq, const float* sq_pen,
                              const long long* labels, const float* valid,
                              float* partial, int* partial_idx, float* fp,
                              float* cn, float* nc, int* fpi, int* cni,
                              int with_idx, void* stream) {
  if (n <= 0) return 0;
  if (block != 32 && block != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emb_is_bf16) {
    if (with_idx)
      launch_tri_block<__nv_bfloat16, true>(block, emb, n, d, sq, sq_pen,
                                            labels, valid, partial,
                                            partial_idx, fp, cn, nc, fpi, cni,
                                            s);
    else
      launch_tri_block<__nv_bfloat16, false>(block, emb, n, d, sq, sq_pen,
                                             labels, valid, partial,
                                             partial_idx, fp, cn, nc, fpi,
                                             cni, s);
  } else {
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
