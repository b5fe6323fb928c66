// Shared pieces of the port's tiled pairwise kernels (sm_90a): the operand
// conversion and the [rows, d] x [d, cols] tile product that K3 and K6
// (the triangular walks), K4 and K5 (the lifted row kernels) and K7 (the
// sqdist tiles) build their distances from.
//
// The product is one ascending-k fmaf chain per (row, column) from 0.f, so
// <a_i, b_j> comes out in the same bits wherever it is computed: K1's own
// loop (csrc/batch_hard.cu) runs the same chain, and fmaf(x, y, c) ==
// fmaf(y, x, c), so a tile pair's row and column sides share one product.
// Depth past d reads as 0 and leaves the chain unchanged.

#pragma once

#include <cuda_bf16.h>

namespace msim {

constexpr int TILE_BK = 32;   // depth of one shared-memory slice

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[m][q] = <a_{row0 + ty*TM + m}, b_{col0 + tx + CX*q}> for the thread
// (ty, tx) = (tid / CX, tid % CX) of an RY x CX block of threads, over d in
// TILE_BK-deep shared-memory slices (rows past n_a or n_b and depth past d
// read as 0).  a is [n_a, d] and b is [n_b, d], both row-major; they may be
// the same matrix.  Ends with a barrier, so As and Bs are free on return.
template <typename T, int RY, int CX, int TM, int TN>
__device__ __forceinline__ void tile_product(
    const T* __restrict__ a, int n_a, const T* __restrict__ b, int n_b,
    int d, int row0, int col0, float (*As)[RY * TM + 1],
    float (*Bs)[CX * TN + 1], float (&acc)[TM][TN]) {
  constexpr int BM = RY * TM;
  constexpr int BN = CX * TN;
  constexpr int NT = RY * CX;   // the block's threads, one per (ty, tx)
  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += TILE_BK) {
    // consecutive threads read consecutive k of one row: coalesced; the
    // odd row pitch keeps the transposed stores on distinct banks
    for (int e = tid; e < BM * TILE_BK; e += NT) {
      const int r = e / TILE_BK, k = e % TILE_BK;
      const int gi = row0 + r, gk = k0 + k;
      As[k][r] = (gi < n_a && gk < d) ? to_f32(a[(size_t)gi * d + gk]) : 0.f;
    }
    for (int e = tid; e < BN * TILE_BK; e += NT) {
      const int c = e / TILE_BK, k = e % TILE_BK;
      const int gj = col0 + c, gk = k0 + k;
      Bs[k][c] = (gj < n_b && gk < d) ? to_f32(b[(size_t)gj * d + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TILE_BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = As[k][ty * TM + m];
#pragma unroll
      for (int q = 0; q < TN; ++q) bv[q] = Bs[k][tx + CX * q];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(av[m], bv[q], acc[m][q]);
    }
    __syncthreads();
  }
}

}  // namespace msim
