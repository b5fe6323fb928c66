// f32 tile products on Hopper's tensor cores through 3xTF32 (sm_90a), for
// the lifted row forward (K4) of csrc/lifted.cu.  Built on the TMA, mbarrier
// and descriptor primitives of csrc/wgmma_tile.cuh, which stays bf16-only
// for the batch-hard kernels.
//
// 3xTF32.  TF32 keeps 10 mantissa bits, too few for the port's 1e-4 f32
// parity.  So each f32 operand x comes split in two by the caller
// (ops/kernels/lifted.py tf32_split): hi = x rounded to the nearest TF32
// value and lo = x - hi, exact in f32, |lo| <= 2^-11 |x|.  Every k8 step
// issues three products into one f32 accumulator, the small ones first:
// hi_a lo_b, lo_a hi_b, hi_a hi_b.  The tensor core's truncation of lo to
// TF32 and the dropped lo_a lo_b cost at most about 2^-21 of |a| |b| a
// product, against 2^-24 for an f32 FMA chain.
//
// Operands.  hi and lo are row-major [n, d] f32 matrices with d a multiple
// of 4 (a row is a multiple of 16 bytes, TMA's rule) and 16-byte aligned
// bases.  Both sides of every product are rows of them, so A and B are
// K-major, as wgmma reads TF32 (it has no transposed TF32 form).  TMA
// copies boxes of 64 rows x 32 f32 (128 bytes a row, the 128-byte swizzle
// of csrc/wgmma_tile.cuh) and fills rows past n and columns past d with
// zeros.  A box that would start past n is not issued; its rows hold stale
// shared memory, which every caller masks.  A k8 step is 32 bytes, as a
// bf16 k16 step is, so smem_desc and the 32-byte advance carry over.
//
// Pipeline.  As WgRing: a ring of STAGES k-slices, each holding the hi and
// lo tiles of A_ROWS rows of A and B_ROWS rows of B; one producer thread
// issues the TMA loads, the consumer warpgroups issue the products of their
// 64 rows and release each slice once its products are done.

#pragma once

#include "wgmma_tile.cuh"

namespace msim {

constexpr int TF32_BK = 32;   // k-slice depth: 32 f32, one 128-byte row
constexpr int TF32_BOX_BYTES = WG_BOX * TF32_BK * 4;

// d += A B^T for a 64-row A and an N-row B (TF32, both K-major, 8 deep)
__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_step(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  wgmma_tf32_m64n64(d, da, db);
}
__device__ __forceinline__ void tf32_step(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  wgmma_tf32_m64n128(d, da, db);
}

// The ring of k-slices at a 1024-aligned shared address: stage s holds the
// hi then lo tile of A (A_ROWS rows each), then of B (B_ROWS rows each),
// then the 2 x STAGES mbarriers.  Every tile starts on a 1024-byte
// boundary, as the swizzle needs.
template <int A_ROWS, int B_ROWS, int STAGES>
struct Tf32Ring {
  static constexpr int A_BYTES = A_ROWS * TF32_BK * 4;
  static constexpr int B_BYTES = B_ROWS * TF32_BK * 4;
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFFSET + 2 * STAGES * 8;

  uint32_t base;

  __device__ uint32_t a_hi(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t a_lo(int s) const { return a_hi(s) + A_BYTES; }
  __device__ uint32_t b_hi(int s) const { return a_lo(s) + A_BYTES; }
  __device__ uint32_t b_lo(int s) const { return b_hi(s) + B_BYTES; }
  __device__ uint32_t full(int s) const { return base + BAR_OFFSET + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + BAR_OFFSET + 8 * (STAGES + s);
  }

  // one thread, before a __syncthreads(); `consumers` threads arrive on
  // every empty barrier
  __device__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Producer (one thread): the k_slices slices of rows a_row0.. of A and
  // b_row0.. of B, hi and lo, continuing the ring's count `it`.
  __device__ void load(const CUtensorMap* hi, const CUtensorMap* lo, int& it,
                       int a_row0, int b_row0, int n, int k_slices) const {
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      int boxes = 0;
      for (int r = 0; r < A_ROWS; r += WG_BOX) boxes += a_row0 + r < n;
      for (int r = 0; r < B_ROWS; r += WG_BOX) boxes += b_row0 + r < n;
      mbar_expect_tx(full(s), 2 * boxes * TF32_BOX_BYTES);
      const int k = ks * TF32_BK;
      for (int r = 0; r < A_ROWS; r += WG_BOX)
        if (a_row0 + r < n) {
          tma_load(a_hi(s) + r * TF32_BK * 4, hi, k, a_row0 + r, full(s));
          tma_load(a_lo(s) + r * TF32_BK * 4, lo, k, a_row0 + r, full(s));
        }
      for (int r = 0; r < B_ROWS; r += WG_BOX)
        if (b_row0 + r < n) {
          tma_load(b_hi(s) + r * TF32_BK * 4, hi, k, b_row0 + r, full(s));
          tma_load(b_lo(s) + r * TF32_BK * 4, lo, k, b_row0 + r, full(s));
        }
    }
  }

  // Consumer (every thread of the consumer warpgroups): acc = the
  // warpgroup's 64 rows of A times the B_ROWS rows of B in 3xTF32, over
  // k_slices slices of the ring from its count `it`.  A slice is released
  // once the next one's products are issued and its own are done.
  __device__ __forceinline__ void product(float (&acc)[B_ROWS / 2], int& it,
                                          int k_slices) const {
    const uint32_t wg_rows = (threadIdx.x / 128) * TF32_BOX_BYTES;
#pragma unroll
    for (int e = 0; e < B_ROWS / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const uint32_t ah = a_hi(s) + wg_rows, al = a_lo(s) + wg_rows;
      const uint32_t bh = b_hi(s), bl = b_lo(s);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TF32_BK / 8; ++kk) {   // 32 bytes per k8 step
        const int o = 32 * kk;
        tf32_step(acc, smem_desc(ah + o), smem_desc(bl + o));
        tf32_step(acc, smem_desc(al + o), smem_desc(bh + o));
        tf32_step(acc, smem_desc(ah + o), smem_desc(bh + o));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) mbar_arrive(empty(prev));
  }
};

// Host: the TMA map of a row-major [rows, cols] f32 matrix at `base` (cols
// a multiple of 4, base 16-byte aligned) in 64-row x 32-column boxes with
// the 128-byte swizzle and zero fill.  Returns 0, or ENCODE_ERROR + the
// CUresult of cuTensorMapEncodeTiled (ENCODE_ERROR alone when the entry
// point is missing), as make_tensor_map.
inline int make_tensor_map_f32(CUtensorMap* map, const void* base, int rows,
                               int cols) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return ENCODE_ERROR;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {TF32_BK, WG_BOX};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(rc);
}

}  // namespace msim
