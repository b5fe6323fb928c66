// f32 tile products on Hopper's tensor cores through 3xTF32 (sm_90a) with
// the hi / lo split made inside the kernel, for the triangular lifted
// forward (K6, csrc/lifted.cu) and the sqdist tiles (K7, csrc/distance.cu).
// Built on the TF32 wgmma wrappers of csrc/wgmma_tf32.cuh, whose ring
// (K4, K5) takes operands the caller has split; this one takes the f32
// operand itself.
//
// Split in place.  TMA brings each k-slice of A and B as f32 tiles (64
// rows x 32 f32 boxes, 128-byte swizzle, zero fill past the rows and the
// depth).  A warpgroup then rewrites each element x of a tile as hi = x
// rounded to the nearest TF32 value (as ops/kernels/lifted.py tf32_split)
// and writes lo = x - hi, exact in f32, at the same offset of a lo tile of
// the same size and alignment.  The swizzle is a function of the address
// alone, so the lo tile has the layout wgmma expects, and no split buffer,
// wrapper pass or extra TMA load is needed.  Either the multiplying
// warpgroup splits each slice while the tensor cores work on the one
// before (K7), or a second warpgroup splits ahead of it (K6).  Products as
// csrc/wgmma_tf32.cuh: each k8 step adds hi_a lo_b, lo_a hi_b, hi_a hi_b
// into one f32 accumulator, lo read as TF32 (truncated), within about
// 2^-21 of |a| |b| a product.
//
// The split also hands each thread the sums of squares of the elements it
// touched (K7 takes its row norms from them; K6, whose norms come from the
// wrapper, drops them).  Thread t of the warpgroup splits the 16-byte
// chunks t, t + 128, ... of each tile: chunk c is row c / 8 (8 chunks a
// 128-byte row), so chunk k of thread t lies in row 16 k + t / 8, and the
// eight threads 8 (t / 8) .. 8 (t / 8) + 7 hold one row between them
// (a warp's float4 accesses cover whole rows: no bank conflicts).

#pragma once

#include "wgmma_tf32.cuh"

namespace msim {

// x rounded to the nearest TF32 value (half a TF32 step added to the
// magnitude, the low 13 mantissa bits cleared)
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// split one ROWS x 32 f32 tile at x (hi in place, lo at `lo`), adding each
// chunk's squares to sq[k] (thread t's chunk k: row 16 k + t / 8)
template <int ROWS>
__device__ __forceinline__ void split_tile(unsigned char* x, unsigned char* lo,
                                           int t, float (&sq)[ROWS / 16]) {
#pragma unroll
  for (int k = 0; k < ROWS / 16; ++k) {
    const int off = (k * 128 + t) * 16;
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float4 h = make_float4(tf32_round(v.x), tf32_round(v.y),
                                 tf32_round(v.z), tf32_round(v.w));
    *reinterpret_cast<float4*>(x + off) = h;
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    sq[k] = fmaf(v.x, v.x, sq[k]);
    sq[k] = fmaf(v.y, v.y, sq[k]);
    sq[k] = fmaf(v.z, v.z, sq[k]);
    sq[k] = fmaf(v.w, v.w, sq[k]);
  }
}

// The ring of k-slices at a 1024-aligned shared address: stage s holds the
// f32 tile of A (A_ROWS rows), its lo tile, the f32 tile of B (B_ROWS
// rows) and its lo tile, then the 3 x STAGES mbarriers (full, empty,
// split).  One consumer warpgroup (128 threads) multiplies; the same one
// splits each slice first (product), or another warpgroup splits it
// (split) and the multiplying one waits for that (product_split).  B
// comes in boxes of B_BOX rows (the B tensor map's box height).
template <int A_ROWS, int B_ROWS, int STAGES>
struct SplitRing {
  static constexpr int B_BOX = B_ROWS < WG_BOX ? B_ROWS : WG_BOX;
  static constexpr int A_BYTES = A_ROWS * TF32_BK * 4;
  static constexpr int B_BYTES = B_ROWS * TF32_BK * 4;
  static constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFFSET + 3 * STAGES * 8;
  static_assert(A_ROWS == WG_BOX, "one warpgroup: 64 rows of A");
  static_assert(B_ROWS % B_BOX == 0 && B_BYTES % 1024 == 0,
                "B in whole boxes of whole 8-row swizzle groups");

  unsigned char* ptr;   // the same address, generic (the split) and
  uint32_t base;        // shared (TMA, wgmma, mbarriers)

  __device__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t a_lo(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t b(int s) const { return a_lo(s) + A_BYTES; }
  __device__ uint32_t b_lo(int s) const { return b(s) + B_BYTES; }
  __device__ unsigned char* at(uint32_t addr) const {
    return ptr + (addr - base);
  }
  __device__ uint32_t full(int s) const { return base + BAR_OFFSET + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + BAR_OFFSET + 8 * (STAGES + s);
  }
  __device__ uint32_t split_done(int s) const {
    return base + BAR_OFFSET + 8 * (2 * STAGES + s);
  }

  // one thread, before a __syncthreads(); the 128 threads of the
  // multiplying warpgroup arrive on every empty barrier, those of the
  // splitting one on every split barrier
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
      mbar_init(split_done(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Producer (one thread): the k_slices slices of rows a_row0.. of A (n_a
  // rows) and b_row0.. of B (n_b rows), continuing the ring's count `it`.
  // A box that would start past its matrix's rows is not issued; its rows
  // hold stale shared memory, which the caller masks.
  __device__ void load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                       int& it, int a_row0, int b_row0, int n_a, int n_b,
                       int k_slices) const {
    int b_boxes = 0;
    for (int r = 0; r < B_ROWS; r += B_BOX) b_boxes += b_row0 + r < n_b;
    const uint32_t bytes = (A_BYTES + b_boxes * B_BOX * TF32_BK * 4);
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(full(s), bytes);
      const int k = ks * TF32_BK;
      tma_load(a(s), map_a, k, a_row0, full(s));
      for (int r = 0; r < B_ROWS; r += B_BOX)
        if (b_row0 + r < n_b)
          tma_load(b(s) + r * TF32_BK * 4, map_b, k, b_row0 + r, full(s));
    }
  }

  // split slice s in place (thread t of 128), gathering the squares of
  // this thread's chunks into sq_a / sq_b; then fenced for wgmma's async
  // proxy, which reads what the generic proxy wrote
  __device__ __forceinline__ void split_slice(int s, int t,
                                              float (&sq_a)[A_ROWS / 16],
                                              float (&sq_b)[B_ROWS / 16])
      const {
    split_tile<A_ROWS>(at(a(s)), at(a_lo(s)), t, sq_a);
    split_tile<B_ROWS>(at(b(s)), at(b_lo(s)), t, sq_b);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // the three TF32 products of slice s into acc
  __device__ __forceinline__ void multiply(float (&acc)[B_ROWS / 2],
                                           int s) const {
    const uint32_t ah = a(s), al = a_lo(s), bh = b(s), bl = b_lo(s);
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
  }

  // Consumer (the 128 threads of the warpgroup, t = 0..127): acc = A's 64
  // rows times B's B_ROWS rows in 3xTF32 over k_slices slices from the
  // ring's count `it`; the warpgroup splits each slice itself (joined on
  // named barrier bar_id before its products), and releases it once the
  // next one's products are issued and its own are done.  sq_a / sq_b
  // gather the squares of this thread's chunks.
  __device__ __forceinline__ void product(float (&acc)[B_ROWS / 2], int& it,
                                          int k_slices, int t, int bar_id,
                                          float (&sq_a)[A_ROWS / 16],
                                          float (&sq_b)[B_ROWS / 16]) const {
#pragma unroll
    for (int e = 0; e < B_ROWS / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      split_slice(s, t, sq_a, sq_b);
      bar_sync(bar_id, 128);
      multiply(acc, s);
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) mbar_arrive(empty(prev));
  }

  // Splitter (the 128 threads of another warpgroup): splits k_slices
  // slices from the ring's count `it` as they arrive and announces each on
  // its split barrier.
  __device__ __forceinline__ void split(int& it, int k_slices, int t) const {
    float sq_a[A_ROWS / 16] = {}, sq_b[B_ROWS / 16] = {};   // not needed
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      split_slice(s, t, sq_a, sq_b);
      mbar_arrive(split_done(s));
    }
  }

  // Multiplier (the 128 threads of the warpgroup): as product, on slices
  // another warpgroup splits (split).
  __device__ __forceinline__ void product_split(float (&acc)[B_ROWS / 2],
                                                int& it, int k_slices) const {
#pragma unroll
    for (int e = 0; e < B_ROWS / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(split_done(s), (it / STAGES) & 1);
      multiply(acc, s);
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
// a multiple of 4, base 16-byte aligned) in box_rows x 32-column boxes
// with the 128-byte swizzle and zero fill.  Returns 0, or ENCODE_ERROR +
// the CUresult of cuTensorMapEncodeTiled (ENCODE_ERROR alone when the
// entry point is missing), as make_tensor_map_f32 (whose boxes are 64
// rows).
inline int make_tensor_map_f32_rows(CUtensorMap* map, const void* base,
                                    int rows, int cols, int box_rows) {
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
  const cuuint32_t box[2] = {TF32_BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(rc);
}

}  // namespace msim
