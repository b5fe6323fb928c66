// Exact top-k retrieval for Hopper (sm_90a): the distances of f32 queries
// to f32 gallery rows with each query's k nearest kept in the epilogue, so
// that neither the [Q, N] distance matrix nor a sort of it reaches device
// memory.
//
// Replaces no TPU kernel.  The JAX package's ops/chunked_topk.py (and the
// port's walk in ops/chunked_topk.py) form a [Q, C] distance block a chunk
// and select from it with a top-k over [Q, k + C]; on an H100 the walk
// spent 30 of a 1,024-query call's 37 ms over 400,000 rows of width 128
// writing, widening and radix-sorting those blocks, where the product
// itself took 0.4 ms.
//
//   d(i, j) = max(|q_i|^2 + |g_j|^2 - 2 <q_i, g_j>, 0) + 0.0  (never -0.0)
//   euclidean: sqrt(d(i, j) + 1e-12)
// as ops/distances.py pairwise_distance forms them, and for each query i
// the k smallest keys (bits of d << 32) | j, ascending: the order of
// ops/chunked_topk.py smallest_k, the lowest row first among equal
// distances.  Slots past the rows that exist, and every row at a distance
// of 1e30 or more, are the walk's empty slots (1e30, row -1).
//
// Bound on an H100 (SXM, 700 W).  At (Q, N, d) = (1024, 400000, 128) the
// products are 2 Q N d = 104.9 GFLOP, 0.636 ms at the 3xTF32 rate (three
// TF32 products at 495 TFLOP/s); reading the gallery once is 204.8 MB,
// 0.061 ms at 3.35 TB/s, and the output (Q x slices x k keys) is a few MB.
// The products bound it.
//
// Design.  sqdist_topk_tc: the grid is query blocks of 64 rows (x) times
// gallery slices (y) of whole 128-row tiles, sized by the host so that one
// wave fills the card (two CTAs an SM where the lists fit); the CTAs of one
// slice are launched together, so L2 serves a tile to every query block
// and HBM sees the gallery about once.  Each CTA is K7's (csrc/distance.cu):
// one consumer warpgroup that forms the 64 x 128 tile's products in 3xTF32
// on wgmma through msim::SplitRing, the split made in shared memory, both
// norms summed from the same slices, and one TMA producer warp.  The
// epilogue never stores a distance.  Row r of the block belongs to warp
// r / 16 alone (wgmma's D fragment): its four threads compare each of the
// row's 128 distances with the row's k-th key, held in shared memory,
// which costs one compare an element once the list has filled; the rare
// survivors go to the row's buffer behind its sorted list (on a CTA's
// first tile only those under a bound from the tile itself,
// first_bound).  The owning warp merges a buffer into the list (each
// key's rank by counting, no sort) once it holds MERGE_AT keys at the end
// of a tile, or at once when it is full; the survivors that found it full
// are offered again against the new k-th key.  Nothing but the tile's
// norms is shared between warps, so the merges need no block barrier.
// After its last tile a CTA merges what is left and writes its k keys
// ([Q, slices, k] int64).
//
// topk_merge: one warp a query takes the smallest k of its slices x k keys
// (k rounds of a warp minimum over the keys above the last one taken) and
// splits them into distances (f32) and rows (int64).  Every real key is
// distinct, so the result does not depend on the order in which the CTAs
// ran: it is deterministic and equals the exact top-k of the kernel's own
// distances.
//
// Precision.  3xTF32 products are within about 2^-21 of |q_i| |g_j| of
// the exact ones (csrc/wgmma_split.cuh), against about 2^-24 d for the f32
// FMA chain of the walk's product; for unit rows both are far inside the
// 2e-5 the retrieval benchmark allows.

#include <cuda_runtime.h>
#include <cstdint>

#include "wgmma_split.cuh"

namespace {

constexpr int BM = msim::WG_BOX;   // query rows a CTA: one warpgroup
constexpr int BN = 128;            // gallery rows a tile
constexpr int STAGES = 2;          // k-slices in flight
constexpr int THREADS = 128 + 32;
constexpr int MAX_K = 64;
// keys a row holds: its k best, then its buffer.  28 leaves a buffer of 16
// or more up to k = 12 and lets two CTAs share an SM; 80 takes k up to 64
// at one CTA an SM.
constexpr int ROW_SMALL = 28, ROW_LARGE = 80, K_SMALL = 12;
static_assert(4 * 3 >= K_SMALL, "first_bound's three a thread cover k");
// a row's buffer is merged at the end of a tile once it holds this many
// keys: a staler k-th key lets more distances through, a fresher one costs
// more merges (4, 8 and a full buffer measured at 1.98, 1.96 and 2.08 ms
// at the retrieval cell's shape on an H100)
constexpr int MERGE_AT = 8;
using Ring = msim::SplitRing<BM, BN, STAGES>;

// the walk's empty slot, (bits of 1e30f) << 32: no row at 1e30 or beyond
// enters a list, as none beats the walk's initial slots
constexpr unsigned long long SENTINEL = 0x7149F2CAull << 32;

template <int ROW>
struct TopkSmem {
  float norm_a[BM], norm_b[BN];
  int count[BM];                   // keys in each row's buffer (may pass
                                   // its capacity: the rest were refused)
  unsigned long long keys[BM][ROW];   // each row's k best ascending, then
                                      // its buffer
};

template <int ROW>
constexpr int smem_bytes() {
  return Ring::BYTES + static_cast<int>(sizeof(TopkSmem<ROW>)) + 1024;
}

// clamped at zero as torch.clamp does (a NaN stays NaN and never enters a
// list, as it never beats the walk's empty slots), -0.0 made +0.0
template <bool EUCLIDEAN>
__device__ __forceinline__ float distance(float dot, float norms) {
  const float s = __fmaf_rn(-2.f, dot, norms);
  const float sq = __fadd_rn(s < 0.f ? 0.f : s, 0.f);
  return EUCLIDEAN ? __fsqrt_rn(__fadd_rn(sq, 1e-12f)) : sq;
}

__device__ __forceinline__ unsigned long long make_key(float d, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(row);
}

// element 4 (b / 2) + 2 h + b % 2 of acc for a b known only at run time,
// by a tree of selects on b's bits: indexing acc with b would move acc to
// local memory
__device__ __forceinline__ float pick(const float (&acc)[BN / 2], int h,
                                      int b) {
  float x0[16], x1[8], x2[4], x3[2];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x0[i] = (b & 1) ? acc[4 * i + 2 * h + 1] : acc[4 * i + 2 * h];
#pragma unroll
  for (int i = 0; i < 8; ++i) x1[i] = (b & 2) ? x0[2 * i + 1] : x0[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) x2[i] = (b & 4) ? x1[2 * i + 1] : x1[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) x3[i] = (b & 8) ? x2[2 * i + 1] : x2[2 * i];
  return (b & 16) ? x3[1] : x3[0];
}

// A CTA's first tile meets empty lists, where every distance would be a
// survivor.  Each of the four threads of a row keeps its three smallest
// distances of the tile; the largest third-smallest of the four bounds the
// row's k-th smallest from above for k <= 12 (12 distances lie at or below
// it), so nothing above it can enter the list.  Infinity where a thread
// holds fewer than three (past the gallery's rows).
template <bool EUCLIDEAN>
__device__ __forceinline__ float first_bound(const TopkSmem<ROW_SMALL>& sh,
                                             const float (&acc)[BN / 2],
                                             int h, int r, int q, int cols) {
  const float inf = __int_as_float(0x7f800000);
  const float na = sh.norm_a[r];
  float m0 = inf, m1 = inf, m2 = inf;
#pragma unroll
  for (int g = 0; g < BN / 8; ++g)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * g + 2 * q + c;
      float x = distance<EUCLIDEAN>(acc[4 * g + 2 * h + c],
                                    na + sh.norm_b[col]);
      x = col < cols && x == x ? x : inf;   // a NaN counts as no distance
      const float t0 = fminf(m0, x);
      x = fmaxf(m0, x);
      m0 = t0;
      const float t1 = fminf(m1, x);
      x = fmaxf(m1, x);
      m1 = t1;
      m2 = fminf(m2, x);
    }
  m2 = fmaxf(m2, __shfl_xor_sync(0xffffffffu, m2, 1));
  return fmaxf(m2, __shfl_xor_sync(0xffffffffu, m2, 2));
}

// Offer the elements `consider` (bit 2 g + c: column 8 g + 2 q + c of the
// tile) of accumulator row h, which is block row r, to that row's list:
// those under the row's k-th key (and at or under `bound`) go to its
// buffer.  Returns the bits of
// those that found the buffer full.  The common case, no element under
// the k-th distance, costs one compare an element; the survivors are
// visited one at a time in a small loop, which keeps the code that every
// tile runs short.
template <int ROW, bool EUCLIDEAN>
__device__ __forceinline__ unsigned int offer(TopkSmem<ROW>& sh,
                                              const float (&acc)[BN / 2],
                                              int h, int r, int q, int col0,
                                              int cols, int k, float bound,
                                              unsigned int consider) {
  unsigned long long* keys = sh.keys[r];
  const unsigned long long kth = keys[k - 1];
  const float kth_d = fminf(
      __uint_as_float(static_cast<unsigned int>(kth >> 32)), bound);
  const float na = sh.norm_a[r];
  unsigned int pass = 0;
#pragma unroll
  for (int g = 0; g < BN / 8; ++g)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * g + 2 * q + c;
      const float v = distance<EUCLIDEAN>(acc[4 * g + 2 * h + c],
                                          na + sh.norm_b[col]);
      pass |= (v <= kth_d && col < cols ? 1u : 0u) << (2 * g + c);
    }
  pass &= consider;
  unsigned int full = 0;
  while (pass) {
    const int b = __ffs(pass) - 1;
    pass &= pass - 1;
    const int col = 8 * (b >> 1) + 2 * q + (b & 1);
    const unsigned long long key = make_key(
        distance<EUCLIDEAN>(pick(acc, h, b), na + sh.norm_b[col]),
        col0 + col);
    if (key < kth) {
      const int pos = atomicAdd(&sh.count[r], 1);
      if (pos < ROW - k)
        keys[k + pos] = key;
      else
        full |= 1u << b;
    }
  }
  return full;
}

// Merge row r's buffer into its sorted list (the whole warp; r's owner).
// A key's new place is the number of the row's keys below it: the keys are
// distinct but for the empty slots, which sit behind every real key, so a
// place that two empty slots share, or that no key takes, already holds one.
template <int ROW>
__device__ __forceinline__ void merge_row(TopkSmem<ROW>& sh, int r, int k,
                                          int lane) {
  constexpr int E = (ROW + 31) / 32;
  unsigned long long* keys = sh.keys[r];
  const int m = k + min(sh.count[r], ROW - k);
  unsigned long long mine[E];
  int rank[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + 32 * e;
    mine[e] = i < m ? keys[i] : ~0ull;
    rank[e] = 0;
  }
  for (int j = 0; j < m; ++j) {
    const unsigned long long x = keys[j];
#pragma unroll
    for (int e = 0; e < E; ++e) rank[e] += x < mine[e];
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < m && rank[e] < k) keys[rank[e]] = mine[e];
  __syncwarp();
  if (lane == 0) sh.count[r] = 0;
  __syncwarp();
}

// the warp's rows (16 w .. 16 w + 15) whose buffer holds `least` keys or
// more, merged
template <int ROW>
__device__ __forceinline__ void merge_rows(TopkSmem<ROW>& sh, int warp,
                                           int k, int lane, int least) {
  __syncwarp();
  unsigned int due = __ballot_sync(
      0xffffffffu, lane < 16 && sh.count[16 * warp + lane] >= least);
  while (due) {
    const int i = __ffs(due) - 1;
    due &= due - 1;
    merge_row(sh, 16 * warp + i, k, lane);
  }
}

template <int ROW, bool EUCLIDEAN>
__global__ void __launch_bounds__(THREADS, ROW <= ROW_SMALL ? 2 : 1)
sqdist_topk_tc(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_g, int nq, int n,
               int d4, int k, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const Ring ring{smem, msim::smem_u32(smem)};
  TopkSmem<ROW>& sh = *reinterpret_cast<TopkSmem<ROW>*>(smem + Ring::BYTES);
  if (threadIdx.x == 0) ring.init();   // ends with the barrier-init fence
  __syncthreads();

  const int k_slices = (d4 + msim::TF32_BK - 1) / msim::TF32_BK;
  const int tiles = (n + BN - 1) / BN;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int tile0 = static_cast<int>((long long)tiles * slice / slices);
  const int tile1 = static_cast<int>((long long)tiles * (slice + 1) / slices);
  const int row0 = blockIdx.x * BM;

  if (threadIdx.x >= 128) {   // the producer warp: one thread loads
    if (threadIdx.x == 128) {
      int it = 0;
      for (int tile = tile0; tile < tile1; ++tile)
        ring.load(&map_q, &map_g, it, row0, tile * BN, nq, n, k_slices);
    }
    return;
  }

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, q = lane & 3;
  for (int e = lane; e < 16 * ROW; e += 32)
    (&sh.keys[16 * warp][0])[e] = SENTINEL;
  if (lane < 16) sh.count[16 * warp + lane] = 0;
  __syncwarp();

  int it = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int col0 = tile * BN;
    float acc[BN / 2];
    float sq_a[BM / 16], sq_b[BN / 16];
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) sq_a[j] = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) sq_b[j] = 0.f;
    ring.product(acc, it, k_slices, t, 1, sq_a, sq_b);

    // the norms, as K7: the eight threads that share a row (chunk j of
    // thread t is row 16 j + t / 8) add their squares in a fixed order
#pragma unroll
    for (int j = 0; j < BM / 16; ++j)
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1)
        sq_a[j] += __shfl_xor_sync(0xffffffffu, sq_a[j], o);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int o = 1; o <= 4; o <<= 1)
        sq_b[j] += __shfl_xor_sync(0xffffffffu, sq_b[j], o);
    if ((t & 7) == 0) {
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) sh.norm_a[16 * j + t / 8] = sq_a[j];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) sh.norm_b[16 * j + t / 8] = sq_b[j];
    }
    msim::bar_sync(1, 128);

    // element 4 g + 2 h + c of acc: block row 16 warp + lane / 4 + 8 h,
    // tile column 8 g + 2 q + c (wgmma's D fragment)
    const int cols = n - col0;
    float bound[2];
    unsigned int full[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      if constexpr (ROW == ROW_SMALL)
        bound[h] = tile == tile0
                       ? first_bound<EUCLIDEAN>(sh, acc, h, r, q, cols)
                       : __int_as_float(0x7f800000);
      else
        bound[h] = __int_as_float(0x7f800000);
      full[h] = offer<ROW, EUCLIDEAN>(sh, acc, h, r, q, col0, cols, k,
                                      bound[h],
                                      row0 + r < nq ? 0xffffffffu : 0u);
    }
    while (__any_sync(0xffffffffu, (full[0] | full[1]) != 0)) {
      merge_rows(sh, warp, k, lane, ROW - k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
        full[h] = offer<ROW, EUCLIDEAN>(sh, acc, h, r, q, col0, cols, k,
                                        bound[h], full[h]);
      }
    }
    merge_rows(sh, warp, k, lane, MERGE_AT);
  }

  merge_rows(sh, warp, k, lane, 1);
  __syncwarp();
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * warp + i;
    if (row0 + r >= nq) break;
    unsigned long long* dst =
        out + ((size_t)(row0 + r) * slices + slice) * k;
    for (int j = lane; j < k; j += 32) dst[j] = sh.keys[r][j];
  }
}

// one warp a query: the smallest k of its m = slices x k keys, split into
// distances and rows (the empty slot as 1e30 and -1)
__global__ void __launch_bounds__(128)
topk_merge_kernel(const unsigned long long* __restrict__ keys, int nq, int m,
                  int k, float* __restrict__ dist,
                  long long* __restrict__ idx) {
  const int i = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (i >= nq) return;
  const unsigned long long* row = keys + (size_t)i * m;
  unsigned long long low = 0;   // every key at or above it is left
  for (int j = 0; j < k; ++j) {
    unsigned long long best = ~0ull;
    for (int e = lane; e < m; e += 32) {
      const unsigned long long x = row[e];
      if (x >= low && x < best) best = x;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
      best = other < best ? other : best;
    }
    if (best >= SENTINEL) {   // no real key left: the rest are empty
      for (int jj = j + lane; jj < k; jj += 32) {
        dist[(size_t)i * k + jj] = 1e30f;
        idx[(size_t)i * k + jj] = -1;
      }
      return;
    }
    if (lane == 0) {
      dist[(size_t)i * k + j] =
          __uint_as_float(static_cast<unsigned int>(best >> 32));
      idx[(size_t)i * k + j] = static_cast<long long>(best & 0xFFFFFFFFull);
    }
    low = best + 1;
  }
}

template <int ROW, bool EUCLIDEAN>
void prepare() {
  cudaFuncSetAttribute(sqdist_topk_tc<ROW, EUCLIDEAN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes<ROW>());
  cudaFuncSetAttribute(sqdist_topk_tc<ROW, EUCLIDEAN>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
}

// gallery slices for nq queries over n rows: as many as fill one wave of
// the card with the nq / 64 query blocks, at least one and at most one a
// tile (the metric does not change the kernel's resources)
template <int ROW>
int slices_for(int nq, int n) {
  prepare<ROW, false>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sqdist_topk_tc<ROW, false>, THREADS, smem_bytes<ROW>());
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = nq > 0 ? (nq + BM - 1) / BM : 1;
  const long long tiles = n > 0 ? (n + BN - 1) / BN : 1;
  long long s = resident / blocks;
  if (s > tiles) s = tiles;
  return static_cast<int>(s < 1 ? 1 : s);
}

template <int ROW, bool EUCLIDEAN>
int launch(const CUtensorMap& map_q, const CUtensorMap& map_g, int nq, int n,
           int d4, int k, int slices, unsigned long long* out,
           cudaStream_t stream) {
  prepare<ROW, EUCLIDEAN>();
  const dim3 grid((nq + BM - 1) / BM, slices);
  sqdist_topk_tc<ROW, EUCLIDEAN>
      <<<grid, THREADS, smem_bytes<ROW>(), stream>>>(map_q, map_g, nq, n, d4,
                                                     k, out);
  return static_cast<int>(cudaGetLastError());
}

template <int ROW>
int launch_metric(const CUtensorMap& map_q, const CUtensorMap& map_g, int nq,
                  int n, int d4, int k, int slices, int euclidean,
                  unsigned long long* out, cudaStream_t stream) {
  return euclidean ? launch<ROW, true>(map_q, map_g, nq, n, d4, k, slices,
                                       out, stream)
                   : launch<ROW, false>(map_q, map_g, nq, n, d4, k, slices,
                                        out, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes.

// The slices sqdist_topk takes for nq queries, n gallery rows and k: the
// second dimension of its output.
extern "C" int sqdist_topk_slices(int nq, int n, int k) {
  return k <= K_SMALL ? slices_for<ROW_SMALL>(nq, n)
                      : slices_for<ROW_LARGE>(nq, n);
}

// q [nq, d4] and g [n, d4] are device pointers of contiguous f32 tensors
// (d4 a multiple of 4, zero columns past the operands' depth, bases 16-byte
// aligned: TMA's rules), out [nq, slices, k] int64 keys, slices as
// sqdist_topk_slices gives them (at most 65535), 1 <= k <= 64, n >= 1.
// Launches on `stream` without synchronising and returns
// cudaGetLastError(), cudaErrorInvalidValue for arguments the kernel does
// not take, or msim::ENCODE_ERROR (+ the CUresult) when a tensor map
// cannot be built.
extern "C" int sqdist_topk(const float* q, int nq, const float* g, int n,
                           int d4, int k, int slices, int euclidean,
                           unsigned long long* out, void* stream) {
  if (nq <= 0) return 0;
  if (n <= 0 || d4 <= 0 || d4 % 4 != 0 || k < 1 || k > MAX_K ||
      slices < 1 || slices > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_g;
  int rc = msim::make_tensor_map_f32(&map_q, q, nq, d4);
  if (rc == 0) rc = msim::make_tensor_map_f32(&map_g, g, n, d4);
  if (rc != 0) return rc;
  const auto s = static_cast<cudaStream_t>(stream);
  return k <= K_SMALL
             ? launch_metric<ROW_SMALL>(map_q, map_g, nq, n, d4, k, slices,
                                        euclidean, out, s)
             : launch_metric<ROW_LARGE>(map_q, map_g, nq, n, d4, k, slices,
                                        euclidean, out, s);
}

// keys [nq, slices, k] as sqdist_topk wrote them -> dist [nq, k] f32 and
// idx [nq, k] int64, ascending.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int topk_merge(const unsigned long long* keys, int nq, int slices,
                          int k, float* dist, long long* idx, void* stream) {
  if (nq <= 0) return 0;
  if (slices < 1 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  topk_merge_kernel<<<(nq + 3) / 4, 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      keys, nq, slices * k, k, dist, idx);
  return static_cast<int>(cudaGetLastError());
}
