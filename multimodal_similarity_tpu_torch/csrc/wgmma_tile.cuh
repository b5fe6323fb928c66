// bf16 tile product on Hopper's tensor cores (sm_90a), shared by the
// batch-hard row walk (K1/K2) and triangular walk (K3) of csrc/batch_hard.cu.
// f32 operands keep the FMA chain of csrc/tile.cuh; this header is bf16 only.
//
// Operands.  Both sides of every product are rows of one row-major [n, d]
// bf16 matrix: A and B are both K-major, the layout wgmma reads without a
// transpose.  TMA's rules: d is a multiple of 8 (a row is a multiple of
// 16 bytes) and the base is 16-byte aligned; the Python wrappers pad and
// copy to meet them.  TMA copies boxes of 64 rows x 64 columns (128 bytes
// a row, 128-byte swizzle) and fills rows past n and columns past d with
// zeros, whose products add nothing.  A box that would start past n is not
// issued; the rows it would have held are masked by every caller.
//
// Pipeline.  A ring of WG_STAGES k-slices in dynamic shared memory, each
// holding A_ROWS rows of A and B_ROWS rows of B, 64 columns deep.  One
// producer thread waits on a stage's `empty` mbarrier, announces its bytes
// on the stage's `full` mbarrier and issues the TMA loads; the consumer
// warpgroups wait on `full`, issue wgmma.mma_async (m64nNk16, f32 += bf16 x
// bf16, both operands from shared memory) for their 64 rows, and arrive on
// `empty` once the slice's products are done.  The producer runs ahead
// across tiles, so the next tile's loads overlap this tile's epilogue.
//
// Bit-equality.  Every <e_i, e_j> is formed from a zero accumulator by the
// same four k16 steps per 64-deep slice, slices in ascending k.  The
// per-k products of bf16 values are exact in f32 and enter the same k
// positions of the same instruction whichever row is the anchor, so the
// tile of (e_i, e_j) and the tile of (e_j, e_i) hold the same bits: K3's
// column side may reuse its row side's product, and equals K1.
//
// Accumulator fragment (PTX ISA, wgmma D for m64nNk16 f32): thread `lane`
// of warp w (0-3) of a warpgroup holds element e of its N/2 registers at
//   row 16 w + lane / 4 + 8 ((e / 2) % 2),  column 8 (e / 4) + 2 (lane % 4) + e % 2.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace msim {

constexpr int WG_BK = 64;       // k-slice depth: 64 bf16, one 128-byte row
constexpr int WG_BOX = 64;      // rows per TMA box, rows per warpgroup
constexpr int WG_STAGES = 4;    // k-slices in flight
constexpr int WG_BOX_BYTES = WG_BOX * WG_BK * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 128-byte swizzle repeats every 8 rows x 128 bytes: tiles start on a
// 1024-byte boundary (the caller reserves 1024 bytes for this)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of more
// than about ten seconds means a lost load or arrival, and traps (the
// launch then fails) rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box (k, row) of `map` into shared memory at dst, completion on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused by this layout), stride
// 1024 bytes between 8-row groups, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B^T for a 64-row A and an N-row B (both K-major, 16 deep)
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
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

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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

// pins the accumulator registers at this point of the program: the
// compiler sees no tie between wgmma_wait and the registers an earlier
// wgmma writes, and could otherwise move their reads (or writes) across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  wgmma_m64n64(d, da, db);
}
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  wgmma_m64n128(d, da, db);
}

// a warpgroup's register budget per thread, lowered (the roles that need
// few) or raised (the ones that hold accumulators) for the rest of the
// kernel; every warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier `id` (1-15; 0 is __syncthreads') over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The ring of k-slices at a 1024-aligned shared address: stage s holds
// A_ROWS rows of A then B_ROWS rows of B, then the 2 x WG_STAGES mbarriers.
template <int A_ROWS, int B_ROWS>
struct WgRing {
  static constexpr int A_BYTES = A_ROWS * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_ROWS * WG_BK * 2;
  static constexpr int BAR_OFFSET = WG_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFFSET + 2 * WG_STAGES * 8;

  uint32_t base;

  __device__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const { return base + BAR_OFFSET + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + BAR_OFFSET + 8 * (WG_STAGES + s);
  }

  // one thread, before a __syncthreads(); `consumers` threads arrive on
  // every empty barrier
  __device__ void init(int consumers) const {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Producer (one thread): the k_slices slices of rows a_row0.. of A and
  // b_row0.. of B, continuing the ring's count `it`.
  __device__ void load(const CUtensorMap* map, int& it, int a_row0,
                       int b_row0, int n, int k_slices) const {
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % WG_STAGES;
      mbar_wait(empty(s), ((it / WG_STAGES) & 1) ^ 1);
      int boxes = 0;
      for (int r = 0; r < A_ROWS; r += WG_BOX) boxes += a_row0 + r < n;
      for (int r = 0; r < B_ROWS; r += WG_BOX) boxes += b_row0 + r < n;
      mbar_expect_tx(full(s), boxes * WG_BOX_BYTES);
      for (int r = 0; r < A_ROWS; r += WG_BOX)
        if (a_row0 + r < n)
          tma_load(a(s) + r * WG_BK * 2, map, ks * WG_BK, a_row0 + r,
                   full(s));
      for (int r = 0; r < B_ROWS; r += WG_BOX)
        if (b_row0 + r < n)
          tma_load(b(s) + r * WG_BK * 2, map, ks * WG_BK, b_row0 + r,
                   full(s));
    }
  }

  // Consumer (every thread of the consumer warpgroups): acc = the
  // warpgroup's 64 rows of A times the B_ROWS rows of B, over k_slices
  // slices of the ring from its count `it`.  A slice is released once the
  // next one's products are issued and its own are done.
  __device__ void product(float (&acc)[B_ROWS / 2], int& it,
                          int k_slices) const {
    const uint32_t wg_rows = (threadIdx.x / 128) * WG_BOX_BYTES;
#pragma unroll
    for (int e = 0; e < B_ROWS / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int ks = 0; ks < k_slices; ++ks, ++it) {
      const int s = it % WG_STAGES;
      mbar_wait(full(s), (it / WG_STAGES) & 1);
      const uint32_t sa = a(s) + wg_rows, sb = b(s);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)   // 32 bytes per k16 step
        wgmma_step(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk));
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

// Host: the TMA map of a row-major [rows, cols] bf16 matrix at `base`
// (cols a multiple of 8, base 16-byte aligned) in 64 x 64 boxes with the
// 128-byte swizzle and zero fill.  cuTensorMapEncodeTiled is looked up
// with cudaGetDriverEntryPoint(ByVersion), so the library needs no
// -lcuda.  Returns 0, or ENCODE_ERROR + its CUresult (ENCODE_ERROR alone
// when the entry point is missing).
constexpr int ENCODE_ERROR = 1000;

inline int make_tensor_map(CUtensorMap* map, const void* base, int rows,
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {WG_BK, WG_BOX};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(rc);
}

}  // namespace msim
