// Fused lifted-structured statistics and their recompute backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX package's ops/pallas/:
//   lifted_fwd_kernel (K4)      -> lifted.py:85 _fwd_kernel
//                                  (via _lifted_fwd_pallas :187)
//   lifted_bwd_kernel (K5)      -> lifted.py:126 _bwd_kernel, both the
//                                  straight and the transposed pass
//                                  (via _lifted_bwd_pallas :227, called
//                                  twice at :340-345)
//   lifted_tri_kernel (K6)      -> lifted_tri.py:93 _tri_lifted_kernel
//   + lifted_tri_reduce            (via lifted_fwd_tri :120)
//
// Per pair (row i, column j) of the same [N, d] embedding matrix:
//   dist  = max(sq[i] + sq_pen[j] - 2 <e_i, e_j>, 0)    (sq_pen: +1e30 on
//                                                        invalid columns)
//   same  = valid[j] > 0 && label[i] == label[j]
//   pos   = same && i != j
//   v_pos = (pos ? dist : 0) - (1 - valid[j]) * 1e30    (the reference's
//           exp(0) quirk: valid non-positives, the self pair included,
//           contribute 1 to the positive sum)
//   v_neg = same ? -1e30 : margin - dist
//   fp_i  = logsumexp_j v_pos,  cn_i = logsumexp_j v_neg,
//   nc_i  = sum_j (same ? 0 : valid[j])
// Labels are 64-bit integers with a separate valid flag: no float cast.
//
// K4 (general row forward).  One CTA owns BM anchor rows and loops over all
// column tiles, as K1 does (csrc/batch_hard.cu); the [BM, d] x [d, 128]
// tile product is f32 FMA from shared memory.  Each thread carries, for its
// rows, the running (max, sum of exp) of both logsumexps over the columns
// it owns: per tile it takes the max of its 4 values first, so a tile costs
// 4 + 1 exponentials per row and lse, not 2 per element.  A warp-shuffle
// merge of the 32 column lanes ends the row.  The running max starts at
// -FLT_MAX, not -inf, so no merge ever forms inf - inf: a row with no valid
// negative ends at max = -1e30 and sum = its column count, hence
// cn = -1e30 + log(count) = -1e30 in f32, the TPU kernel's value.
//
// K5 (recompute backward).  With C_ij = g_fp_i softmax^pos_ij pos_ij
// - g_cn_i softmax^neg_ij neg_ij (softmaxes rebuilt from the saved fp, cn),
//   grad_i = 2 sum_j (C_ij + C_ji) (e_i - e_j).
// One CTA owns BM output rows and loops over column tiles of 128.  For each
// tile it recomputes the distance tile once and forms both C_ij (row i's
// stats: the TPU's straight pass) and C_ji (column j's stats: the TPU's
// transposed pass, which there took a second launch), stages their sum in
// shared memory, and multiplies it by the column tile of E, streamed in
// 32 x 128 slices, into a [BM, d] accumulator in shared memory.  One launch,
// no atomics, each output row written by one CTA: deterministic.
//
// K6 (bounded triangular forward, l2-normalised inputs: dist <= 4, so the
// plain sums of exp cannot overflow and need no max tracking).  One CTA per
// upper-triangle tile pair (ti <= tj) of B x B; it builds the shared tiles
//   P  = exp(same_label && i != j ? dist : 0),  Ng = same_label ? 0 :
//   exp(margin - dist),  nm = same_label ? 0 : 1   (dist unpenalised, real
//   labels on both sides, validity folded in by weighting)
// once and reduces them both ways: along rows weighted by valid[j] into
// partial[ti][tj], and (off the diagonal) along columns weighted by
// valid[i] into partial[tj][ti].  Every entry of the [3][T][T][B] partials
// buffer is written exactly once, so it needs no clearing.  A second small
// pass (lifted_tri_reduce) sums partial[a][0..T-1] in ascending order -- the
// order in which the TPU's sequential grid reached accumulator row a -- and
// takes fp = log(max(sum, 1e-30)).  No float atomics: bit-identical from
// run to run.  B = 32 while the 64-row walk would leave SMs idle (N = 512:
// 136 CTAs on 132 SMs), else B = 64; the wrapper chooses and allocates.
//
// Precision.  bf16 operands are products of bf16 values summed in f32; f32
// operands are full-f32 FMA, no TF32.  Every epilogue (distance, masks,
// exp, the coefficient matrix C and its product with E) runs in f32; the
// TPU ran the distance epilogue in bf16 and rounded C to bf16 for its MXU.
//
// Bound on an H100 (SXM, 700 W).  At the trainer's shape (N = 512, d = 128,
// f32) K4 needs 2 N^2 d = 67 MFLOP and 2 N^2 exponentials, K6 half the
// products and about N^2 / 2 exponentials, K5 4 N^2 d = 134 MFLOP and up to
// 2 N^2 exponentials; inputs and outputs are a few hundred KB.  Each is a
// few microseconds or less at the f32 FMA, SFU or HBM rate, so the calls
// are bound by latency: a serial chain of tile loads, barriers and FMA steps
// per CTA, and how many SMs the grid occupies.  The designs answer with
// 8-row CTAs for K4 and K5 at small N (64 CTAs at N = 512) and 32-row tiles
// for K6 (136 CTAs).  At N = 8192 the FMA work dominates; tensor cores
// (mma.sync / wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>

#include "tile.cuh"

namespace {

constexpr int BK = msim::TILE_BK;  // depth of one shared-memory slice
constexpr int THREADS = 256;
constexpr float POS_INF = 1e30f;
constexpr float NEG_INF = -1e30f;

using msim::tile_product;
using msim::to_f32;

// merge a (max, sum of exp) pair into another; both maxima are finite
__device__ __forceinline__ void lse_merge(float& m, float& s, float om,
                                          float os) {
  const float mx = fmaxf(m, om);
  s = s * expf(m - mx) + os * expf(om - mx);
  m = mx;
}

// ---------------------------------------------------------------- K4 ----

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
lifted_fwd_kernel(const T* __restrict__ emb, int n, int d,
                  const float* __restrict__ sq,
                  const float* __restrict__ sq_pen,
                  const long long* __restrict__ labels,
                  const float* __restrict__ valid, float margin,
                  float* __restrict__ fp_out, float* __restrict__ cn_out,
                  float* __restrict__ nc_out) {
  constexpr int RY = 8, CX = 32, TN = 4;
  constexpr int BM = RY * TM, BN = CX * TN;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
  const int row0 = blockIdx.x * BM;

  float sqa[TM];
  long long la[TM];
  float pm[TM], ps[TM], qm[TM], qs[TM], nc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty * TM + m;
    sqa[m] = i < n ? sq[i] : 0.f;
    la[m] = i < n ? labels[i] : 0;
    pm[m] = -FLT_MAX; ps[m] = 0.f;   // positive lse: running max, sum
    qm[m] = -FLT_MAX; qs[m] = 0.f;   // negative lse
    nc[m] = 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[TM][TN];
    tile_product<T, RY, CX, TM, TN>(emb, n, emb, n, d, row0, col0, As,
                                    Bs, acc);

    float sqp[TN], vb[TN];
    long long lb[TN];
    bool in[TN];
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int j = col0 + tx + CX * q;
      in[q] = j < n;
      sqp[q] = in[q] ? sq_pen[j] : 0.f;
      vb[q] = in[q] ? valid[j] : 0.f;
      lb[q] = in[q] ? labels[j] : 0;
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = row0 + ty * TM + m;
      float vp[TN], vn[TN];
      float tp = -FLT_MAX, tq = -FLT_MAX;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int j = col0 + tx + CX * q;
        const float dist = fmaxf((sqa[m] + sqp[q]) - 2.f * acc[m][q], 0.f);
        const bool same = vb[q] > 0.f && la[m] == lb[q];
        vp[q] = ((same && i != j) ? dist : 0.f) - (1.f - vb[q]) * POS_INF;
        vn[q] = same ? NEG_INF : margin - dist;
        if (in[q]) {
          tp = fmaxf(tp, vp[q]);
          tq = fmaxf(tq, vn[q]);
          nc[m] += same ? 0.f : vb[q];
        }
      }
      float sp = 0.f, sn = 0.f;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        if (in[q]) {
          sp += expf(vp[q] - tp);
          sn += expf(vn[q] - tq);
        }
      }
      lse_merge(pm[m], ps[m], tp, sp);
      lse_merge(qm[m], qs[m], tq, sn);
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float opm = __shfl_xor_sync(0xffffffffu, pm[m], off);
      const float ops = __shfl_xor_sync(0xffffffffu, ps[m], off);
      const float oqm = __shfl_xor_sync(0xffffffffu, qm[m], off);
      const float oqs = __shfl_xor_sync(0xffffffffu, qs[m], off);
      nc[m] += __shfl_xor_sync(0xffffffffu, nc[m], off);
      lse_merge(pm[m], ps[m], opm, ops);
      lse_merge(qm[m], qs[m], oqm, oqs);
    }
    const int i = row0 + ty * TM + m;
    if (tx == 0 && i < n) {
      fp_out[i] = pm[m] + logf(fmaxf(ps[m], 1e-30f));
      cn_out[i] = qm[m] + logf(fmaxf(qs[m], 1e-30f));
      nc_out[i] = nc[m];
    }
  }
}

// ---------------------------------------------------------------- K5 ----

// C of one ordered pair: conceptual row r (its stats), conceptual column c
// (its penalised norm, label and validity).  Zero outside the masks; the
// exponentials are taken only where a mask selects them.
__device__ __forceinline__ float coef(float sq_r, float sqpen_c, float s,
                                      bool same, bool self, float v_c,
                                      float fp_r, float cn_r, float gfp_r,
                                      float gcn_r, float margin) {
  const float dist = fmaxf((sq_r + sqpen_c) - 2.f * s, 0.f);
  if (same)
    return self ? 0.f
                : gfp_r * expf((dist - (1.f - v_c) * POS_INF) - fp_r);
  return -gcn_r * (expf((margin - dist) - cn_r) * v_c);
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
lifted_bwd_kernel(const T* __restrict__ emb, int n, int d, int d_pad,
                  const float* __restrict__ sq,
                  const float* __restrict__ sq_pen,
                  const long long* __restrict__ labels,
                  const float* __restrict__ valid,
                  const float* __restrict__ fp,
                  const float* __restrict__ cn,
                  const float* __restrict__ gfp,
                  const float* __restrict__ gcn, float margin,
                  float* __restrict__ grad) {
  constexpr int RY = 8, CX = 32, TN = 4;
  constexpr int BM = RY * TM, BN = CX * TN;   // BN = 128
  static_assert(BN == 4 * 32, "E slices are 128 wide: 4 per lane");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];            // also the E slices
  __shared__ float Cs[BM][BN + 1];
  extern __shared__ float G[];                // [BM][d_pad]: sum_j C e_j

  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
  const int row0 = blockIdx.x * BM;

  for (int e = tid; e < BM * d_pad; e += THREADS) G[e] = 0.f;

  float sq_i[TM], sqp_i[TM], v_i[TM], fp_i[TM], cn_i[TM], gfp_i[TM],
      gcn_i[TM], rowsum[TM];
  long long la[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty * TM + m;
    const bool in = i < n;
    sq_i[m] = in ? sq[i] : 0.f;
    sqp_i[m] = in ? sq_pen[i] : 0.f;
    v_i[m] = in ? valid[i] : 0.f;
    fp_i[m] = in ? fp[i] : 0.f;
    cn_i[m] = in ? cn[i] : 0.f;
    gfp_i[m] = in ? gfp[i] : 0.f;
    gcn_i[m] = in ? gcn[i] : 0.f;
    la[m] = in ? labels[i] : 0;
    rowsum[m] = 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[TM][TN];
    tile_product<T, RY, CX, TM, TN>(emb, n, emb, n, d, row0, col0, As,
                                    Bs, acc);

    // C_ij + C_ji for this thread's pairs, staged in Cs
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int j = col0 + tx + CX * q;
      const bool jin = j < n;
      const float sq_j = jin ? sq[j] : 0.f;
      const float sqp_j = jin ? sq_pen[j] : 0.f;
      const float v_j = jin ? valid[j] : 0.f;
      const float fp_j = jin ? fp[j] : 0.f;
      const float cn_j = jin ? cn[j] : 0.f;
      const float gfp_j = jin ? gfp[j] : 0.f;
      const float gcn_j = jin ? gcn[j] : 0.f;
      const long long lb = jin ? labels[j] : 0;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int i = row0 + ty * TM + m;
        float c = 0.f;
        if (jin && i < n) {
          const bool self = i == j;
          // straight: row i over column j
          c = coef(sq_i[m], sqp_j, acc[m][q], v_j > 0.f && la[m] == lb,
                   self, v_j, fp_i[m], cn_i[m], gfp_i[m], gcn_i[m], margin);
          // transposed: row j over column i
          c += coef(sq_j, sqp_i[m], acc[m][q], v_i[m] > 0.f && lb == la[m],
                    self, v_i[m], fp_j, cn_j, gfp_j, gcn_j, margin);
        }
        rowsum[m] += c;
        Cs[ty * TM + m][tx + CX * q] = c;
      }
    }
    __syncthreads();

    // G[rows] += Cs @ E[col0 : col0 + BN], 128 embedding columns at a time
    for (int c0 = 0; c0 < d; c0 += 128) {
      float g[TM][4];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[m][q] = 0.f;
      for (int j0 = 0; j0 < BN; j0 += BK) {
        for (int e = tid; e < BK * 128; e += THREADS) {
          const int jj = e / 128, kk = e % 128;
          const int gj = col0 + j0 + jj, gk = c0 + kk;
          Bs[jj][kk] = (gj < n && gk < d)
                           ? to_f32(emb[(size_t)gj * d + gk]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < BK; ++jj) {
          float cv[TM], ev[4];
#pragma unroll
          for (int m = 0; m < TM; ++m) cv[m] = Cs[ty * TM + m][j0 + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) ev[q] = Bs[jj][tx + 32 * q];
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[m][q] = fmaf(cv[m], ev[q], g[m][q]);
        }
        __syncthreads();
      }
      // each G element belongs to one thread for the whole kernel
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          G[(ty * TM + m) * d_pad + c0 + tx + 32 * q] += g[m][q];
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rowsum[m] += __shfl_xor_sync(0xffffffffu, rowsum[m], off);
    const int i = row0 + ty * TM + m;
    if (i >= n) continue;
    for (int k = tx; k < d; k += 32)
      grad[(size_t)i * d + k] =
          2.f * (rowsum[m] * to_f32(emb[(size_t)i * d + k])
                 - G[(ty * TM + m) * d_pad + k]);
  }
}

// ---------------------------------------------------------------- K6 ----

// B x B tile pair (ti <= tj) of the upper triangle; 16 x 16 threads, each
// TM x TM elements (B = 16 TM).  partial is [3][T][T][B]: positive sums,
// negative sums, negative counts.
template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
lifted_tri_kernel(const T* __restrict__ emb, int n, int d,
                  const float* __restrict__ sq,
                  const long long* __restrict__ labels,
                  const float* __restrict__ valid, float margin, int n_tiles,
                  float* __restrict__ partial) {
  constexpr int R = 16, B = R * TM;
  __shared__ float As[BK][B + 1];
  __shared__ float Bs[BK][B + 1];
  __shared__ float colbuf[3][R][B];

  // blockIdx.x -> (ti, tj), row-major over the upper triangle
  int ti = 0, rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int row0 = ti * B, col0 = tj * B;

  const int tid = threadIdx.x;
  const int tx = tid % R;
  const int ty = tid / R;

  float acc[TM][TM];
  tile_product<T, R, R, TM, TM>(emb, n, emb, n, d, row0, col0, As, Bs, acc);

  float sq_j[TM], v_j[TM];
  long long l_j[TM];
  bool jin[TM];
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    const int j = col0 + tx + R * q;
    jin[q] = j < n;
    sq_j[q] = jin[q] ? sq[j] : 0.f;
    v_j[q] = jin[q] ? valid[j] : 0.f;
    l_j[q] = jin[q] ? labels[j] : 0;
  }
  float rp[TM], rn[TM], rc[TM], cp[TM], cq[TM], cc[TM];
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    rp[q] = rn[q] = rc[q] = 0.f;
    cp[q] = cq[q] = cc[q] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = row0 + ty * TM + m;
    if (i >= n) continue;
    const float sq_i = sq[i], v_i = valid[i];
    const long long l_i = labels[i];
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      if (!jin[q]) continue;
      const int j = col0 + tx + R * q;
      const float dist = fmaxf((sq_i + sq_j[q]) - 2.f * acc[m][q], 0.f);
      const bool eq = l_i == l_j[q];
      const float p = (eq && i != j) ? expf(dist) : 1.f;
      const float ng = eq ? 0.f : expf(margin - dist);
      const float nm = eq ? 0.f : 1.f;
      rp[m] += p * v_j[q];
      rn[m] += ng * v_j[q];
      rc[m] += nm * v_j[q];
      cp[q] += p * v_i;
      cq[q] += ng * v_i;
      cc[q] += nm * v_i;
    }
  }

  const size_t plane = (size_t)n_tiles * n_tiles * B;
  // row side: the 16 lanes of a half-warp share ty and hold its columns
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      rp[m] += __shfl_xor_sync(0xffffffffu, rp[m], off);
      rn[m] += __shfl_xor_sync(0xffffffffu, rn[m], off);
      rc[m] += __shfl_xor_sync(0xffffffffu, rc[m], off);
    }
    if (tx == 0) {
      const size_t at = ((size_t)ti * n_tiles + tj) * B + ty * TM + m;
      partial[at] = rp[m];
      partial[plane + at] = rn[m];
      partial[2 * plane + at] = rc[m];
    }
  }
  if (ti == tj) return;   // the diagonal tile's row side covers both ways
  // column side: sum the 16 row groups of each column in a fixed order
#pragma unroll
  for (int q = 0; q < TM; ++q) {
    colbuf[0][ty][tx + R * q] = cp[q];
    colbuf[1][ty][tx + R * q] = cq[q];
    colbuf[2][ty][tx + R * q] = cc[q];
  }
  __syncthreads();
  if (tid < 3 * B) {
    const int a = tid / B, c = tid % B;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < R; ++y) s += colbuf[a][y][c];
    partial[a * plane + ((size_t)tj * n_tiles + ti) * B + c] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
lifted_tri_reduce(const float* __restrict__ partial, int n, int n_tiles,
                  int block, float* __restrict__ fp_out,
                  float* __restrict__ cn_out, float* __restrict__ nc_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int a = i / block, r = i % block;
  const size_t plane = (size_t)n_tiles * n_tiles * block;
  float s[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < n_tiles; ++b) {
    const size_t at = ((size_t)a * n_tiles + b) * block + r;
#pragma unroll
    for (int x = 0; x < 3; ++x) s[x] += partial[x * plane + at];
  }
  fp_out[i] = logf(fmaxf(s[0], 1e-30f));
  cn_out[i] = logf(fmaxf(s[1], 1e-30f));
  nc_out[i] = s[2];
}

// 32-row CTAs once they alone fill every SM; 8-row CTAs below that, so a
// small batch still spreads over the card
bool wide_rows(int n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (n + 31) / 32 >= sms;
}

template <typename T, int TM>
void launch_fwd(const void* emb, int n, int d, const float* sq,
                const float* sq_pen, const long long* labels,
                const float* valid, float margin, float* fp, float* cn,
                float* nc, cudaStream_t s) {
  constexpr int BM = 8 * TM;
  lifted_fwd_kernel<T, TM><<<(n + BM - 1) / BM, THREADS, 0, s>>>(
      static_cast<const T*>(emb), n, d, sq, sq_pen, labels, valid, margin,
      fp, cn, nc);
}

template <typename T, int TM>
int launch_bwd(const void* emb, int n, int d, const float* sq,
               const float* sq_pen, const long long* labels,
               const float* valid, const float* fp, const float* cn,
               const float* gfp, const float* gcn, float margin, float* grad,
               cudaStream_t s) {
  constexpr int BM = 8 * TM;
  const int d_pad = (d + 127) / 128 * 128;
  const size_t dyn = (size_t)BM * d_pad * sizeof(float);
  const cudaError_t rc = cudaFuncSetAttribute(
      lifted_bwd_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  lifted_bwd_kernel<T, TM><<<(n + BM - 1) / BM, THREADS, dyn, s>>>(
      static_cast<const T*>(emb), n, d, d_pad, sq, sq_pen, labels, valid,
      fp, cn, gfp, gcn, margin, grad);
  return 0;
}

template <typename T, int TM>
void launch_tri(const void* emb, int n, int d, const float* sq,
                const long long* labels, const float* valid, float margin,
                float* partial, float* fp, float* cn, float* nc,
                cudaStream_t s) {
  constexpr int B = 16 * TM;
  const int n_tiles = (n + B - 1) / B;
  lifted_tri_kernel<T, TM><<<n_tiles * (n_tiles + 1) / 2, THREADS, 0, s>>>(
      static_cast<const T*>(emb), n, d, sq, labels, valid, margin, n_tiles,
      partial);
  lifted_tri_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, n, n_tiles, B, fp, cn, nc);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: emb [n, d] (bf16 when emb_is_bf16, else f32); sq,
// sq_pen, valid and the per-row stats [n] f32; labels [n] int64.  Each
// launches on `stream` without synchronising and returns
// cudaGetLastError() (or the error of the launch set-up).

// K4: fp, cn, nc [n] f32.
extern "C" int lifted_fwd(const void* emb, int emb_is_bf16, int n, int d,
                          const float* sq, const float* sq_pen,
                          const long long* labels, const float* valid,
                          float margin, float* fp, float* cn, float* nc,
                          void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wide_rows(n);
  if (emb_is_bf16) {
    if (wide)
      launch_fwd<__nv_bfloat16, 4>(emb, n, d, sq, sq_pen, labels, valid,
                                   margin, fp, cn, nc, s);
    else
      launch_fwd<__nv_bfloat16, 1>(emb, n, d, sq, sq_pen, labels, valid,
                                   margin, fp, cn, nc, s);
  } else {
    if (wide)
      launch_fwd<float, 4>(emb, n, d, sq, sq_pen, labels, valid, margin, fp,
                           cn, nc, s);
    else
      launch_fwd<float, 1>(emb, n, d, sq, sq_pen, labels, valid, margin, fp,
                           cn, nc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: grad [n, d] f32 = the straight plus the transposed pass.  d <= 1024
// (the [rows, d] accumulator lives in shared memory).
extern "C" int lifted_bwd(const void* emb, int emb_is_bf16, int n, int d,
                          const float* sq, const float* sq_pen,
                          const long long* labels, const float* valid,
                          const float* fp, const float* cn, const float* gfp,
                          const float* gcn, float margin, float* grad,
                          void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wide_rows(n);
  int rc;
  if (emb_is_bf16)
    rc = wide ? launch_bwd<__nv_bfloat16, 4>(emb, n, d, sq, sq_pen, labels,
                                             valid, fp, cn, gfp, gcn, margin,
                                             grad, s)
              : launch_bwd<__nv_bfloat16, 1>(emb, n, d, sq, sq_pen, labels,
                                             valid, fp, cn, gfp, gcn, margin,
                                             grad, s);
  else
    rc = wide ? launch_bwd<float, 4>(emb, n, d, sq, sq_pen, labels, valid,
                                     fp, cn, gfp, gcn, margin, grad, s)
              : launch_bwd<float, 1>(emb, n, d, sq, sq_pen, labels, valid,
                                     fp, cn, gfp, gcn, margin, grad, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K6: fp, cn, nc [n] f32 through the partials buffer `partial`, at least
// 3 * T * T * block floats with T = ceil(n / block); block is 32 or 64.
extern "C" int lifted_fwd_tri(const void* emb, int emb_is_bf16, int n,
                              int d, int block, const float* sq,
                              const long long* labels, const float* valid,
                              float margin, float* partial, float* fp,
                              float* cn, float* nc, void* stream) {
  if (n <= 0) return 0;
  if (block != 32 && block != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emb_is_bf16) {
    if (block == 64)
      launch_tri<__nv_bfloat16, 4>(emb, n, d, sq, labels, valid, margin,
                                   partial, fp, cn, nc, s);
    else
      launch_tri<__nv_bfloat16, 2>(emb, n, d, sq, labels, valid, margin,
                                   partial, fp, cn, nc, s);
  } else {
    if (block == 64)
      launch_tri<float, 4>(emb, n, d, sq, labels, valid, margin, partial,
                           fp, cn, nc, s);
    else
      launch_tri<float, 2>(emb, n, d, sq, labels, valid, margin, partial,
                           fp, cn, nc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
