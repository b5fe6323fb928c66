// Tiled pairwise squared euclidean distance for Hopper (sm_90a).
//
// Replaces the TPU kernel of multimodal_similarity_tpu/ops/pallas/:
//   sqdist_kernel (K7) -> distance.py:23 _sqdist_kernel
//                         (via pallas_sqdist :35)
//
//   out[i][j] = max(|a_i|^2 + |b_j|^2 - 2 <a_i, b_j>, 0)
// for a [N, d] and b [M, d] in f32 (the wrapper casts, as pallas_sqdist
// does), written out as an [N, M] f32 matrix.
//
// Design.  One CTA per 64 x 64 output tile, 16 x 16 threads of 4 x 4
// outputs each.  The tile product is the shared f32 FMA product of
// csrc/tile.cuh over 32-deep shared-memory slices.  The row norms come from
// the f32 operands inside the kernel, as the TPU kernel takes them from its
// tiles (distance.py:29-31): before the product each warp sums the squares
// of 16 of the tile's 128 rows (64 of a, 64 of b) with coalesced loads and a
// shuffle reduction.  Ragged N, M and d are masked: rows past N or M and
// depth past d read as 0, and outputs past N or M are not written.
//
// Bound on an H100 (SXM, 700 W).  At (N, M, d) = (8192, 8192, 128) the
// products are 2 N M d = 17.2 GFLOP, 0.26 ms at the 67 TFLOP/s f32 rate,
// against 0.08 ms to write the 268 MB output and read the inputs at
// 3.35 TB/s: operations bound it.  This first kernel uses FMA from shared
// memory, not the tensor cores (TF32 or 3xTF32 wgmma would change the
// arithmetic; that is later work).

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int R = 16;               // threads per tile side
constexpr int TM = 4;               // outputs per thread per side
constexpr int BT = R * TM;          // tile edge
constexpr int THREADS = R * R;
constexpr int BK = msim::TILE_BK;

__global__ void __launch_bounds__(THREADS)
sqdist_kernel(const float* __restrict__ a, int n, const float* __restrict__ b,
              int m, int d, float* __restrict__ out) {
  __shared__ float As[BK][BT + 1];
  __shared__ float Bs[BK][BT + 1];
  __shared__ float sq_s[2][BT];   // |a_i|^2 and |b_j|^2 of the tile

  const int row0 = blockIdx.y * BT, col0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < 2 * BT; r += THREADS / 32) {
    const int side = r / BT;
    const int g = (side ? col0 : row0) + r % BT;
    const float* src = side ? b : a;
    float s = 0.f;
    if (g < (side ? m : n))
      for (int k = lane; k < d; k += 32) {
        const float x = src[(size_t)g * d + k];
        s = fmaf(x, x, s);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sq_s[side][r % BT] = s;
  }
  __syncthreads();

  float acc[TM][TM];
  msim::tile_product<float, R, R, TM, TM>(a, n, b, m, d, row0, col0, As, Bs,
                                          acc);
  const int tx = tid % R, ty = tid / R;
#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int i = row0 + ty * TM + p;
    if (i >= n) break;
    const float sa = sq_s[0][ty * TM + p];
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int j = col0 + tx + R * q;
      if (j < m)
        out[(size_t)i * m + j] =
            fmaxf((sa + sq_s[1][tx + R * q]) - 2.f * acc[p][q], 0.f);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  a [n, d], b [m, d] and out
// [n, m] are device pointers of contiguous f32 tensors; n <= 65535 * 64.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int sqdist(const float* a, int n, const float* b, int m, int d,
                      float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((m + BT - 1) / BT, (n + BT - 1) / BT);
  sqdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, b, m, d, out);
  return static_cast<int>(cudaGetLastError());
}
