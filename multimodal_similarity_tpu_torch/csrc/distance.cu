// Tiled pairwise squared euclidean distance for Hopper (sm_90a).
//
// Replaces the TPU kernel of multimodal_similarity_tpu/ops/pallas/:
//   sqdist_tc (K7) -> distance.py:23 _sqdist_kernel
//                     (via pallas_sqdist :35)
//
//   out[i][j] = max(|a_i|^2 + |b_j|^2 - 2 <a_i, b_j>, 0)
// for a [N, d] and b [M, d] in f32 (the wrapper casts, as pallas_sqdist
// does), written out as one contiguous [N, M] f32 matrix.
//
// Bound on an H100 (SXM, 700 W).  At (N, M, d) = (8192, 8192, 128) the
// products are 2 N M d = 17.2 GFLOP, 0.104 ms at the 3xTF32 rate (three
// TF32 products at 495 TFLOP/s), beside 0.080 ms to write the 268 MB
// output at 3.35 TB/s: both matter, so the design puts the products on the
// tensor cores and keeps the output stores in flight under the next
// tile's products.
//
// Design.  Persistent CTAs, two an SM, each one consumer warpgroup and one
// TMA producer warp, walk the 64 x 128 output tiles in row-major order
// (CTA b takes tiles b, b + grid, ...).  Per tile the warpgroup forms the
// products in 3xTF32 on wgmma (m64n128k8) through msim::SplitRing
// (csrc/wgmma_split.cuh): TMA brings each 32-deep k-slice of a's 64 rows
// and b's 128 rows as f32, the warpgroup splits it in shared memory into
// hi and lo (a and b each their own split) and issues hi lo + lo hi +
// hi hi.  The row norms come from the same slices: the split hands each
// thread the squares of the chunks it touched, and the eight threads that
// share a row add theirs once the tile's k-slices are done, so every
// norm is summed from the f32 operands in shared memory, with no second
// read of global memory (the TPU kernel also takes them from its tiles,
// distance.py:29-30).  The epilogue writes each accumulator pair as one
// float2 (eight threads a row cover 32 contiguous bytes: whole sectors),
// streaming past L2 (__stcs), and goes on to the next tile's products
// while the stores drain; an odd M takes scalar stores.  Ragged N, M and d
// are masked: rows past N or M and depth past d arrive as zeros (TMA's
// fill) or from a box that was never issued, and outputs past N or M are
// not written.
//
// Precision.  3xTF32 products are within about 2^-21 of |a_i| |b_j| of
// the exact ones, against about 2^-24 d for the f32 FMA chain; for unit
// rows both are far inside the 1e-4 parity and a duplicate row stays
// within 1e-5 of 0 (chip_smoke.py checks both).

#include <cuda_runtime.h>
#include <cstdint>

#include "wgmma_split.cuh"

namespace {

constexpr int BM = msim::WG_BOX;   // output rows a tile: one warpgroup
constexpr int BN = 128;            // output columns a tile
constexpr int STAGES = 2;          // k-slices in flight: two CTAs an SM
constexpr int THREADS = 128 + 32;
using Ring = msim::SplitRing<BM, BN, STAGES>;
struct SqSmem {
  float norm_a[BM], norm_b[BN];
};
constexpr int SMEM = Ring::BYTES + sizeof(SqSmem) + 1024;

__global__ void __launch_bounds__(THREADS, 2)
sqdist_tc(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b, int n, int m, int d4,
          float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const Ring ring{smem, msim::smem_u32(smem)};
  SqSmem& sh = *reinterpret_cast<SqSmem*>(smem + Ring::BYTES);
  if (threadIdx.x == 0) ring.init();   // ends with the barrier-init fence
  __syncthreads();

  const int k_slices = (d4 + msim::TF32_BK - 1) / msim::TF32_BK;
  const int m_tiles = (m + BN - 1) / BN;
  const int tiles = (n + BM - 1) / BM * m_tiles;

  if (threadIdx.x >= 128) {   // the producer warp: one thread loads
    if (threadIdx.x == 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        ring.load(&map_a, &map_b, it, tile / m_tiles * BM,
                  tile % m_tiles * BN, n, m, k_slices);
    }
    return;
  }

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, q = lane & 3;
  const bool even = (m & 1) == 0;   // float2 stores stay 8-byte aligned
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / m_tiles * BM, col0 = tile % m_tiles * BN;
    float acc[BN / 2];
    float sq_a[BM / 16], sq_b[BN / 16];
#pragma unroll
    for (int k = 0; k < BM / 16; ++k) sq_a[k] = 0.f;
#pragma unroll
    for (int k = 0; k < BN / 16; ++k) sq_b[k] = 0.f;
    ring.product(acc, it, k_slices, t, 1, sq_a, sq_b);

    // the norms: the eight threads that share a row (chunk k of thread t
    // is row 16 k + t / 8) add their squares, in a fixed order
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1)
        sq_a[k] += __shfl_xor_sync(0xffffffffu, sq_a[k], o);
#pragma unroll
    for (int k = 0; k < BN / 16; ++k)
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1)
        sq_b[k] += __shfl_xor_sync(0xffffffffu, sq_b[k], o);
    if ((t & 7) == 0) {
#pragma unroll
      for (int k = 0; k < BM / 16; ++k) sh.norm_a[16 * k + t / 8] = sq_a[k];
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) sh.norm_b[16 * k + t / 8] = sq_b[k];
    }
    msim::bar_sync(1, 128);

    // element 4 g + 2 h + c of acc: row 16 warp + lane / 4 + 8 h, column
    // 8 g + 2 q + c (wgmma's D fragment)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      const int i = row0 + r;
      if (i >= n) continue;
      const float na = sh.norm_a[r];
      float* orow = out + (size_t)i * m;
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        const int cc = 8 * g + 2 * q;
        const int j = col0 + cc;
        const float v0 = fmaxf(
            __fmaf_rn(-2.f, acc[4 * g + 2 * h], na + sh.norm_b[cc]), 0.f);
        const float v1 = fmaxf(
            __fmaf_rn(-2.f, acc[4 * g + 2 * h + 1], na + sh.norm_b[cc + 1]),
            0.f);
        if (even) {
          if (j < m)
            __stcs(reinterpret_cast<float2*>(orow + j), make_float2(v0, v1));
        } else {
          if (j < m) __stcs(orow + j, v0);
          if (j + 1 < m) __stcs(orow + j + 1, v1);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  a [n, d4] and b [m, d4] are
// device pointers of contiguous f32 tensors (d4 a multiple of 4, zero
// columns past the operands' depth, bases 16-byte aligned: TMA's rules),
// out [n, m] f32.  Launches on `stream` without synchronising and returns
// cudaGetLastError(), cudaErrorInvalidValue for operands TMA cannot take,
// or msim::ENCODE_ERROR (+ the CUresult) when a tensor map cannot be
// built.
extern "C" int sqdist(const float* a, int n, const float* b, int m, int d4,
                      float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (d4 <= 0 || d4 % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  int rc = msim::make_tensor_map_f32(&map_a, a, n, d4);
  if (rc == 0) rc = msim::make_tensor_map_f32(&map_b, b, m, d4);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(sqdist_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  // persistent: as many CTAs as fit on the card at once, or one per tile
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sqdist_tc, THREADS,
                                                SMEM);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long tiles = (long long)((n + BM - 1) / BM) * ((m + BN - 1) / BN);
  sqdist_tc<<<(unsigned)(tiles < resident ? tiles : resident), THREADS, SMEM,
              static_cast<cudaStream_t>(stream)>>>(map_a, map_b, n, m, d4,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}
