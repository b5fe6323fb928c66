// Fused pairwise squared distance + batch-hard reduction for Hopper (sm_90a).
//
// Replaces the TPU kernels of multimodal_similarity_tpu/ops/pallas/batch_hard.py:
//   WITH_IDX = true   -> _stats_kernel        (:110, via _stats_pallas :250)
//   WITH_IDX = false  -> _stats_kernel_noidx  (:151, via _stats_pallas_noidx :222)
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>

namespace {

constexpr int BN = 128;        // columns per tile: 32 lanes x TN
constexpr int BK = 32;         // depth of one shared-memory slice
constexpr int TN = 4;          // columns per thread, strided by 32
constexpr int WARPS = 8;       // each warp owns TM rows of the CTA
constexpr int THREADS = WARPS * 32;
constexpr float POS_INF = 1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
