// Fused lifted-structured statistics and their recompute backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX package's ops/pallas/:
//   lifted_fwd_tc (K4, f32)     -> lifted.py:85 _fwd_kernel
//   + lifted_fwd_combine           (via _lifted_fwd_pallas :187)
//   lifted_fwd_kernel (K4, bf16)
//   lifted_bwd_tc (K5, f32)     -> lifted.py:126 _bwd_kernel, both the
//   + lifted_bwd_combine           straight and the transposed pass
//   lifted_bwd_kernel (K5, bf16)   (via _lifted_bwd_pallas :227, called
//                                  twice at :340-345)
//   lifted_tri_tc (K6, f32)     -> lifted_tri.py:93 _tri_lifted_kernel
//   + lifted_tri_combine           (via lifted_fwd_tri :120)
//   lifted_tri_kernel (K6, bf16)
//   + lifted_tri_reduce
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
// K4, f32 (lifted_fwd_tc + lifted_fwd_combine): the products on the tensor
// cores through 3xTF32 (csrc/wgmma_tf32.cuh says how): the caller splits
// the operand into hi = tf32(x) and lo = x - hi, and every k8 step adds
// hi lo + lo hi + hi hi into one f32 accumulator.  The dropped lo lo term
// and the truncation of lo cost at most about 2^-21 of |e_i| |e_j| a
// product, so the distances keep the 1e-4 parity with the JAX package
// (plain TF32, about 2^-11, would not); the JAX kernel also runs this
// product on its matrix unit (ops/pallas/lifted.py:62-63).  A CTA owns 64
// rows and walks the 64-column tiles of one column range in ascending
// order, in three roles (warp-specialised, as K3's tensor-core kernel): a
// producer warp keeps TMA loads of the hi and lo tiles in flight; an MMA
// warpgroup issues each tile's products and stores the tile to one of two
// shared-memory buffers; two epilogue warpgroups, four threads a row and
// 16 columns each, run the online logsumexp on it while the next tile's
// products run.  Per tile each epilogue thread takes the max of its
// columns' v_pos (and v_neg) first, then the sum of exp, and folds both
// into a running (max, sum); a row's four threads merge at the end, in
// ascending order.  Each column's norm, flag, penalty and label are loaded
// a tile ahead and read from shared memory, and the epilogue has no
// branches: a column past n enters at -inf, whose exp is 0 against a tile
// max that starts at -FLT_MAX.  The running max starts at -FLT_MAX, not
// -inf, so no merge forms inf - inf: a row with no valid negative ends at
// max = -1e30 and sum = its column count, hence cn = -1e30 + log(count) =
// -1e30 in f32, the TPU kernel's value.  The exponentials are the SFU's
// (__expf, a few 1e-7 relative), exact at 0 and -inf.
//   Column split.  The row walk alone gives few CTAs at small N (8 at
// N = 512), so the columns are cut into S ranges: grid (row block, range).
// Each CTA writes its rows' (pos max, pos sum, neg max, neg sum, count) to
// partial[S][5][N], every entry exactly once (no clearing), and a second
// launch merges ranges 0..S-1 in ascending order with lse_merge and takes
// fp = m + log(max(s, 1e-30)).  No float atomics, no clusters: bit-identical
// from run to run.  The wrapper picks S (ops/kernels/lifted.py fwd_split).
//   Bound on an H100 (SXM, 700 W).  2 N^2 d products, three TF32 products
// each at 495 TFLOP/s, plus about 14 f32 operations (67 TFLOP/s) and 2
// exponentials (the SFU rate) a pair: N = 8192, d = 128 needs 0.104 ms of
// products, 0.014 of epilogue and 0.016 of exp, 0.134 ms; N = 512 about
// 0.5 us, where launch and load latency bound it.  On the card neither the
// tensor cores nor the SFU bound it: the epilogue side alone takes about
// twice the bound and the products with their loads (32 bytes of hi and lo
// a pair from L2 at 64 x 64 tiles) about 1.7 times; the roles overlap the
// two.  Simpler geometries measured slower (PERF.md, K4 findings).
//
// K4, bf16 (lifted_fwd_kernel): the first port's design.  One CTA owns BM
// anchor rows and loops over all column tiles, as the f32 FMA batch-hard
// kernel does; the [BM, d] x [d, 128] tile product is FMA from shared
// memory; each thread carries, for its rows, the running (max, sum of exp)
// of both logsumexps over its columns (4 a tile), merged over the 32 column
// lanes by warp shuffles.
//
// K5 (recompute backward).  With C_ij = g_fp_i softmax^pos_ij pos_ij
// - g_cn_i softmax^neg_ij neg_ij (softmaxes rebuilt from the saved fp, cn),
//   grad_i = 2 (rowsum_i(C + C^T) e_i - sum_j (C_ij + C_ji) e_j).
// Each tile forms both C_ij (row i's stats: the TPU's straight pass) and
// C_ji (column j's stats and the penalty on i: the TPU's transposed pass,
// which there took a second launch) from one distance tile, so a backward
// is one tile walk.
//   K5, f32 (lifted_bwd_tc + lifted_bwd_combine): both products on the
// tensor cores through 3xTF32, as K4.  Its work is 4 N^2 d products (the
// distance tile, then C E) and two exponentials a pair: at N = 8192, d =
// 128 a bound of 0.258 ms, all but a few percent of it the products, so the
// design puts both on wgmma.  A CTA owns 64 rows, a range of 64-column
// tiles and a chunk of 128 gradient columns, in two consumer warpgroups
// and a TMA producer warp (lifted_bwd_tc's note below); per tile the
// warpgroups form S = <e_i, e_j> (each its 32 columns, m64n32 over the
// depth), turn S into C in registers (the masks, self pairs and -1e30
// sentinels as the TPU kernel; columns past n and rows past n give 0),
// write C split into hi and lo to shared memory in the swizzled K-major
// layout wgmma reads, and add C E (m64n64, each warpgroup 64 of the chunk's
// columns) from E^T's hi and lo tiles: TF32 wgmma has no transposed form,
// so B must be E^T, which the wrapper splits and zero-pads to whole tiles
// (no box reads stale shared memory, whose NaN times a zero C would be
// NaN).  The C E products stay in flight under the next tile's distance
// products.  A depth past 128 takes one CTA per chunk, each recomputing
// S and C over the whole depth: (d / 128 + 1) 2 N^2 d products in all, the
// price of a 64-register accumulator (a 2-warpgroup CTA is capped at 168
// registers; it uses 166, no spill).  Small N splits the columns into
// ranges as K4 does (bwd_grid): each range writes its G and row sums to
// partials, every entry once, and lifted_bwd_combine adds the ranges in
// ascending order and forms 2 (rowsum e - G); with one range the tile walk
// writes the gradient itself.  No float atomics: bit-identical from run to
// run.  On the card (an H100 at 700 W, scripts/k5_probe.py) neither the
// tensor cores nor the epilogue alone bound it: at N = 8192 the kernel takes
// about twice the bound, its products with their loads (epilogue skipped)
// 82% of its time and its loads and epilogue (products skipped) 65%; the
// serial chain of TMA loads, products and epilogue per tile does.
//   K5, bf16 (lifted_bwd_kernel): the first port's FMA design.  One CTA
// owns BM output rows and loops over column tiles of 128, recomputes the
// distance tile, stages C in shared memory and multiplies it by the column
// tile of E into a [BM, d] accumulator in shared memory; a depth beyond 1024
// is walked in chunks of 1024 columns, each recomputing the tiles and C.
//
// K6 (bounded triangular forward, l2-normalised inputs: dist <= 4, so the
// plain sums of exp cannot overflow and need no max tracking).
//   K6, f32 (lifted_tri_tc + lifted_tri_combine): the products on the
// tensor cores through 3xTF32, the operand split into hi and lo by the
// kernel itself (csrc/wgmma_split.cuh: each TMA-loaded f32 k-slice is
// split in shared memory, so the wrapper makes no split buffers and runs
// no split launch).  Persistent CTAs walk work items of 64 rows by BN = 64
// columns (32 while 64 x 64 items would not fill the SMs: N = 512 gives
// 72 items of 32 columns) over the upper triangle, in three roles (MMA
// warpgroup with the row side, column warpgroup, producer warp;
// lifted_tri_tc's note).  Each pair takes one exponential,
//   e = exp(eq ? dist : margin - dist),  P = eq && i != j ? e : 1,
//   Ng = eq ? 0 : e,
// where the FMA kernel below takes two.  Partials are [3][ceil(N / BN)][N]:
// slot cb of row i holds i's sums over column block cb (the row side of
// item (ti, cb)), slot ti R of column j its sums over row block ti (the
// column side, R = 64 / BN), each entry written once; lifted_tri_combine
// adds a row's slots in ascending column order.  Bound on an H100 (SXM,
// 700 W): N^2 d products at the 3xTF32 rate, about 13 f32 operations and
// one exponential a visited pair: 0.067 ms at N = 8192, d = 128, nearly
// all products; the split's shared-memory passes and the per-item chain
// of loads, products and epilogue are what the design has to hide
// (scripts/k6_probe.py times them apart).
//   K6, bf16 (lifted_tri_kernel + lifted_tri_reduce): the first port's FMA
// design.  One CTA per
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
// Precision.  f32 K4, K5 and K6 are 3xTF32 (above; K5 splits C into hi
// and lo too, K6 splits its operand in the kernel); bf16 K4/K5/K6 form
// products of the operand's values with f32 FMA (bf16 values are exact in
// f32).  Every epilogue (distance, masks, exp,
// the coefficient matrix C) runs in f32; the TPU ran the distance epilogue
// in bf16 and rounded C to bf16 for its MXU.
//
// K6 at the trainer's shape (N = 512, d = 128, f32) needs half of K4's
// products and about N^2 / 2 exponentials; inputs and outputs are a few
// hundred KB: well under a microsecond at the 3xTF32, SFU or HBM rate, so
// latency bounds it (one item's chain of loads, split, products and
// epilogue, then the combine launch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "tile.cuh"
#include "wgmma_split.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int BK = msim::TILE_BK;  // depth of one shared-memory slice
constexpr int THREADS = 256;
constexpr float POS_INF = 1e30f;
constexpr float NEG_INF = -1e30f;
// K5's widest shared-memory accumulator, in embedding columns: 128 KB at
// 32 rows
constexpr int BWD_CHUNK = 1024;

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

// ------------------------------------------- K4, f32 on the tensor cores ----

// CTA roles of lifted_fwd_tc, warp-specialised: one MMA warpgroup issues
// the products of the CTA's 64 rows by each 64-column tile and stores the
// tile to shared memory; two epilogue warpgroups run the logsumexps on it
// (four threads a row, 16 columns each), so the products of a tile run
// beside the epilogue of the one before; one producer warp (a thread of
// it) keeps the TMA loads in flight.  Shared memory after the ring: two
// product tiles (pitch 68 floats: the epilogue's float4 row reads are
// conflict-free), each tile's column data (float4 and label) in two
// buffers, the states of a row's threads merged at the end, and the tiles'
// full / empty mbarriers.
constexpr int FWD_BN = 64;
constexpr int FWD_EPI = 256;   // epilogue threads
constexpr int FWD_THREADS = 128 + FWD_EPI + 32;
constexpr int FWD_PITCH = FWD_BN + 4;
constexpr int FWD_PER_ROW = FWD_EPI / msim::WG_BOX;   // threads a row
constexpr int FWD_COLS = FWD_BN / FWD_PER_ROW;        // columns a thread
using FwdRing = msim::Tf32Ring<msim::WG_BOX, FWD_BN, 4>;
struct FwdSmem {
  float tile[2][msim::WG_BOX][FWD_PITCH];
  float4 info[2][FWD_BN];
  long long lab[2][FWD_BN];
  float part[FWD_PER_ROW - 1][5][msim::WG_BOX];
  uint64_t tile_full[2], tile_empty[2];
};
constexpr int FWD_SMEM = FwdRing::BYTES + sizeof(FwdSmem) + 1024;
static_assert(FWD_COLS % 4 == 0, "float4 reads of a thread's columns");

// Column j's epilogue data, loaded by one epilogue thread before it waits
// for the tile's products: (sq_pen, valid, (1 - valid) 1e30, 1) and the
// label; zeros past n, where the last field marks the column out.
__device__ __forceinline__ void load_fwd_col(
    const float* __restrict__ sq_pen, const float* __restrict__ valid,
    const long long* __restrict__ labels, int j, int n, float4& f,
    long long& lab) {
  if (j < n) {
    const float v = valid[j];
    f = make_float4(sq_pen[j], v, (1.f - v) * POS_INF, 1.f);
    lab = labels[j];
  } else {
    f = make_float4(0.f, 0.f, 0.f, 0.f);
    lab = 0;
  }
}

// The running (max, sum) of both logsumexps of one row over one epilogue
// thread's columns, and its negative count.
struct FwdRow {
  float pm = -FLT_MAX, ps = 0.f, qm = -FLT_MAX, qs = 0.f, nc = 0.f;

  // one tile's FWD_COLS columns from c: the values and their maxima
  // first, then the sums of exp, then one merge per logsumexp.  No
  // branches: a column past n enters at -inf, whose exp is 0 against a
  // max that starts at -FLT_MAX; a row past n is computed, never stored.
  __device__ __forceinline__ void tile(const float (&prod)[FWD_COLS],
                                       const float4* info,
                                       const long long* lab, int c, int i,
                                       int j0, float sqa, long long la,
                                       float margin) {
    float vp[FWD_COLS], vn[FWD_COLS];
    float tp = -FLT_MAX, tq = -FLT_MAX;
#pragma unroll
    for (int e = 0; e < FWD_COLS; ++e) {
      const float4 s = info[c + e];
      const bool same = s.y > 0.f && la == lab[c + e];
      // (sq[i] + sq_pen[j]) - 2 acc, one rounding: 2 acc is exact
      const float dist = fmaxf(__fmaf_rn(-2.f, prod[e], sqa + s.x), 0.f);
      const float p = ((same && i != j0 + e) ? dist : 0.f) - s.z;
      const float q = same ? NEG_INF : margin - dist;
      const bool jin = s.w > 0.f;
      vp[e] = jin ? p : -INFINITY;
      vn[e] = jin ? q : -INFINITY;
      tp = fmaxf(tp, vp[e]);
      tq = fmaxf(tq, vn[e]);
      nc += same ? 0.f : s.y;
    }
    // exp(v - t) <= 1 by the SFU's ex2 (__expf): its error, a few 1e-7
    // relative where a term counts, is far inside the 1e-4 parity; exp(0)
    // is exactly 1 and exp(-inf) exactly 0, as the sentinels need
    float sp = 0.f, sn = 0.f;
#pragma unroll
    for (int e = 0; e < FWD_COLS; ++e) {
      sp += __expf(vp[e] - tp);
      sn += __expf(vn[e] - tq);
    }
    lse_merge(pm, ps, tp, sp);
    lse_merge(qm, qs, tq, sn);
  }
};

__global__ void __launch_bounds__(FWD_THREADS, 1)
lifted_fwd_tc(const __grid_constant__ CUtensorMap map_hi,
              const __grid_constant__ CUtensorMap map_lo, int n, int d,
              int tiles_per_range, const float* __restrict__ sq,
              const float* __restrict__ sq_pen,
              const long long* __restrict__ labels,
              const float* __restrict__ valid, float margin,
              float* __restrict__ partial) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const FwdRing ring{msim::smem_u32(smem)};
  FwdSmem& sh = *reinterpret_cast<FwdSmem*>(smem + FwdRing::BYTES);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      msim::mbar_init(msim::smem_u32(&sh.tile_full[b]), 128);
      msim::mbar_init(msim::smem_u32(&sh.tile_empty[b]), FWD_EPI);
    }
    ring.init(128);   // ends with the barrier-init fence
  }
  __syncthreads();

  const int k_slices = (d + msim::TF32_BK - 1) / msim::TF32_BK;
  const int n_tiles = (n + FWD_BN - 1) / FWD_BN;
  const int t_begin = blockIdx.y * tiles_per_range;
  const int t_end = min(n_tiles, t_begin + tiles_per_range);
  const int row0 = blockIdx.x * msim::WG_BOX;

  if (threadIdx.x >= 128 + FWD_EPI) {   // the producer warp: one thread
    if (threadIdx.x == 128 + FWD_EPI) {
      int it = 0;
      for (int t = t_begin; t < t_end; ++t)
        ring.load(&map_hi, &map_lo, it, row0, t * FWD_BN, n, k_slices);
    }
    return;
  }

  if (threadIdx.x < 128) {
    // ---- MMA warpgroup: each tile's products, stored to its buffer once
    // the epilogue has released it (passes at once for the first two)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int it = 0;
    for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
      float acc[FWD_BN / 2];
      ring.product(acc, it, k_slices);
      const int b = k & 1;
      msim::mbar_wait(msim::smem_u32(&sh.tile_empty[b]), ((k >> 1) & 1) ^ 1);
#pragma unroll
      for (int g = 0; g < FWD_BN / 8; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              &sh.tile[b][16 * warp + (lane >> 2) + 8 * h]
                      [8 * g + 2 * (lane & 3)]) =
              make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
      msim::mbar_arrive(msim::smem_u32(&sh.tile_full[b]));
    }
    return;
  }

  // ---- epilogue warpgroups: row r over columns c.. c + 15 of every tile
  const int e = threadIdx.x - 128;
  const int r = e % msim::WG_BOX, c = (e / msim::WG_BOX) * FWD_COLS;
  const int i = row0 + r;
  const float sqa = i < n ? sq[i] : 0.f;
  const long long la = i < n ? labels[i] : 0;
  FwdRow row;
  // column data one tile ahead, so its load latency hides behind a tile
  float4 side;
  long long side_lab;
  if (e < FWD_BN)
    load_fwd_col(sq_pen, valid, labels, t_begin * FWD_BN + e, n, side,
                 side_lab);
  for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
    const int b = k & 1;
    if (e < FWD_BN) {
      sh.info[b][e] = side;
      sh.lab[b][e] = side_lab;
      if (t + 1 < t_end)
        load_fwd_col(sq_pen, valid, labels, (t + 1) * FWD_BN + e, n, side,
                     side_lab);
    }
    msim::mbar_wait(msim::smem_u32(&sh.tile_full[b]), (k >> 1) & 1);
    float prod[FWD_COLS];
#pragma unroll
    for (int v = 0; v < FWD_COLS; v += 4)
      *reinterpret_cast<float4*>(&prod[v]) =
          *reinterpret_cast<const float4*>(&sh.tile[b][r][c + v]);
    msim::mbar_arrive(msim::smem_u32(&sh.tile_empty[b]));
    msim::bar_sync(1, FWD_EPI);   // this tile's column data is in place
    row.tile(prod, sh.info[b], sh.lab[b], c, i, t * FWD_BN + c, sqa, la,
             margin);
  }

  // merge each row's parts in ascending order; part 0 writes the range's
  // entry
  const int part = e / msim::WG_BOX;
  if (part > 0) {
    float* qv = &sh.part[part - 1][0][r];
    qv[0] = row.pm;
    qv[msim::WG_BOX] = row.ps;
    qv[2 * msim::WG_BOX] = row.qm;
    qv[3 * msim::WG_BOX] = row.qs;
    qv[4 * msim::WG_BOX] = row.nc;
  }
  msim::bar_sync(1, FWD_EPI);
  if (part > 0 || i >= n) return;
  for (int pp = 0; pp < FWD_PER_ROW - 1; ++pp) {
    const float* qv = &sh.part[pp][0][r];
    lse_merge(row.pm, row.ps, qv[0], qv[msim::WG_BOX]);
    lse_merge(row.qm, row.qs, qv[2 * msim::WG_BOX], qv[3 * msim::WG_BOX]);
    row.nc += qv[4 * msim::WG_BOX];
  }
  float* p = partial + (size_t)blockIdx.y * 5 * n + i;
  p[0] = row.pm;
  p[n] = row.ps;
  p[2 * (size_t)n] = row.qm;
  p[3 * (size_t)n] = row.qs;
  p[4 * (size_t)n] = row.nc;
}

// row i's stats from partial[0..S-1][.][i], ranges in ascending order
__global__ void __launch_bounds__(THREADS)
lifted_fwd_combine(const float* __restrict__ partial, int n, int ranges,
                   float* __restrict__ fp_out, float* __restrict__ cn_out,
                   float* __restrict__ nc_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float pm = partial[i], ps = partial[n + i];
  float qm = partial[2 * (size_t)n + i], qs = partial[3 * (size_t)n + i];
  float nc = partial[4 * (size_t)n + i];
  for (int r = 1; r < ranges; ++r) {
    const float* p = partial + (size_t)r * 5 * n + i;
    lse_merge(pm, ps, p[0], p[n]);
    lse_merge(qm, qs, p[2 * (size_t)n], p[3 * (size_t)n]);
    nc += p[4 * (size_t)n];
  }
  fp_out[i] = pm + logf(fmaxf(ps, 1e-30f));
  cn_out[i] = qm + logf(fmaxf(qs, 1e-30f));
  nc_out[i] = nc;
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
lifted_bwd_kernel(const T* __restrict__ emb, int n, int d, int kc,
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
  extern __shared__ float G[];                // [BM][kc]: sum_j C e_j

  const int tid = threadIdx.x;
  const int tx = tid % CX;
  const int ty = tid / CX;
  const int row0 = blockIdx.x * BM;

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

  // the embedding columns [k0, k0 + kc) of the gradient per pass: one pass
  // when d fits the accumulator (kc is d rounded up to 128, at most 1024)
  for (int k0 = 0; k0 < d; k0 += kc) {
    const int k1 = min(d, k0 + kc);
    if (k0 > 0) __syncthreads();   // the last chunk's G is read out
    for (int e = tid; e < BM * kc; e += THREADS) G[e] = 0.f;

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
                     self, v_j, fp_i[m], cn_i[m], gfp_i[m], gcn_i[m],
                     margin);
            // transposed: row j over column i
            c += coef(sq_j, sqp_i[m], acc[m][q],
                      v_i[m] > 0.f && lb == la[m], self, v_i[m], fp_j, cn_j,
                      gfp_j, gcn_j, margin);
          }
          if (k0 == 0) rowsum[m] += c;
          Cs[ty * TM + m][tx + CX * q] = c;
        }
      }
      __syncthreads();

      // G[rows] += Cs @ E[col0 : col0 + BN], 128 embedding columns at a
      // time
      for (int c0 = k0; c0 < k1; c0 += 128) {
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
              for (int q = 0; q < 4; ++q)
                g[m][q] = fmaf(cv[m], ev[q], g[m][q]);
          }
          __syncthreads();
        }
        // each G element belongs to one thread for the whole pass
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            G[(ty * TM + m) * kc + c0 - k0 + tx + 32 * q] += g[m][q];
      }
    }

    if (k0 == 0) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rowsum[m] += __shfl_xor_sync(0xffffffffu, rowsum[m], off);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = row0 + ty * TM + m;
      if (i >= n) continue;
      for (int k = k0 + tx; k < k1; k += 32)
        grad[(size_t)i * d + k] =
            2.f * (rowsum[m] * to_f32(emb[(size_t)i * d + k])
                   - G[(ty * TM + m) * kc + k - k0]);
    }
  }
}

// ------------------------------------------- K5, f32 on the tensor cores ----

// lifted_bwd_tc: a CTA owns 64 output rows, one range of 64-column tiles
// and one chunk of BWD_DC gradient columns, in two consumer warpgroups and a
// producer warp.  Per tile, warpgroup w forms the distance products of the
// 64 rows by the tile's columns 32 w .. 32 w + 31 (m64n32, over the whole
// depth), turns them into C_ij + C_ji in registers, and writes its half of
// C, split into hi and lo, to shared memory in the 128-byte-swizzled K-major
// layout TMA gives a box (its 32 columns are one k-slice); both then add
// C times the tile's rows of E to their gradient accumulators (m64n64,
// warpgroup w owning chunk columns 64 w .. 64 w + 63), B being E^T's hi and
// lo tiles.  The per-tile chain of loads, products and epilogue bounds it
// (scripts/k5_probe.py), so shared memory goes to the loads: a ring of
// three stages of rows and columns, in place of a second C buffer.  Then
// the E^T tiles of one column tile (hi, lo x 2 k-slices x 2
// warpgroups' 64 rows), the C tile (hi, lo x 2 k-slices) and BwdSmem, all
// 1024-aligned.
constexpr int BWD_BN = 64;                    // columns a tile
constexpr int BWD_DC = 128;                   // gradient columns a CTA
constexpr int BWD_CONSUMERS = 256;
constexpr int BWD_THREADS = BWD_CONSUMERS + 32;
constexpr int BWD_BOX = msim::TF32_BOX_BYTES;  // 64 rows x 32 f32: 8 KB
using BwdRing = msim::Tf32Ring<msim::WG_BOX, BWD_BN, 3>;
constexpr int BWD_RING = (BwdRing::BYTES + 1023) / 1024 * 1024;
constexpr int BWD_E = BWD_RING;                // [hi, lo][k-slice][wg]
constexpr int BWD_E_BYTES = 8 * BWD_BOX;
constexpr int BWD_C = BWD_E + BWD_E_BYTES;     // [hi, lo][k-slice]
constexpr int BWD_C_BYTES = 4 * BWD_BOX;
struct BwdSmem {
  float4 col[2][BWD_BN][2];   // (sq, sq_pen, valid, in), (fp, cn, g_fp, g_cn)
  long long lab[2][BWD_BN];
  float rowsum[2][msim::WG_BOX];
  uint64_t e_full, e_empty;
};
constexpr int BWD_SMEM = BWD_C + BWD_C_BYTES + sizeof(BwdSmem) + 1024;
static_assert(BWD_DC == 2 * msim::WG_BOX, "two warpgroups of 64 columns");

// Column j's data for the coefficient tile; all zero past n, where `in`
// (the last field of the first float4) marks the column out.
__device__ __forceinline__ void load_bwd_col(
    const float* __restrict__ sq, const float* __restrict__ sq_pen,
    const float* __restrict__ valid, const float* __restrict__ fp,
    const float* __restrict__ cn, const float* __restrict__ gfp,
    const float* __restrict__ gcn, const long long* __restrict__ labels,
    int j, int n, float4 (&f)[2], long long& lab) {
  if (j < n) {
    f[0] = make_float4(sq[j], sq_pen[j], valid[j], 1.f);
    f[1] = make_float4(fp[j], cn[j], gfp[j], gcn[j]);
    lab = labels[j];
  } else {
    f[0] = f[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    lab = 0;
  }
}

// x rounded to the nearest TF32 value, as ops/kernels/lifted.py tf32_split
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
lifted_bwd_tc(const __grid_constant__ CUtensorMap map_hi,
              const __grid_constant__ CUtensorMap map_lo,
              const __grid_constant__ CUtensorMap map_hi_t,
              const __grid_constant__ CUtensorMap map_lo_t,
              const float* __restrict__ emb, int n, int d, int d4,
              int tiles_per_range, const float* __restrict__ sq,
              const float* __restrict__ sq_pen,
              const long long* __restrict__ labels,
              const float* __restrict__ valid, const float* __restrict__ fp,
              const float* __restrict__ cn, const float* __restrict__ gfp,
              const float* __restrict__ gcn, float margin,
              float* __restrict__ partial, float* __restrict__ rowsum_part,
              float* __restrict__ grad) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const BwdRing ring{msim::smem_u32(smem)};
  const uint32_t e_base = msim::smem_u32(smem + BWD_E);
  const uint32_t c_base = msim::smem_u32(smem + BWD_C);
  BwdSmem& sh = *reinterpret_cast<BwdSmem*>(smem + BWD_C + BWD_C_BYTES);
  if (threadIdx.x == 0) {
    msim::mbar_init(msim::smem_u32(&sh.e_full), 1);
    msim::mbar_init(msim::smem_u32(&sh.e_empty), BWD_CONSUMERS);
    ring.init(BWD_CONSUMERS);   // ends with the barrier-init fence
  }
  __syncthreads();

  const int k_slices = (d4 + msim::TF32_BK - 1) / msim::TF32_BK;
  const int n_tiles = (n + BWD_BN - 1) / BWD_BN;
  const int t_begin = blockIdx.y * tiles_per_range;
  const int t_end = min(n_tiles, t_begin + tiles_per_range);
  const int row0 = blockIdx.x * msim::WG_BOX;
  const int k0 = blockIdx.z * BWD_DC;   // this CTA's gradient columns

  if (threadIdx.x >= BWD_CONSUMERS) {   // the producer warp: one thread
    if (threadIdx.x == BWD_CONSUMERS) {
      int it = 0;
      for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
        ring.load(&map_hi, &map_lo, it, row0, t * BWD_BN, n, k_slices);
        // E^T rows k0.. k0 + 127, columns of tile t: every box lies inside
        // the zero-padded E^T, so none holds stale shared memory
        msim::mbar_wait(msim::smem_u32(&sh.e_empty), (k & 1) ^ 1);
        msim::mbar_expect_tx(msim::smem_u32(&sh.e_full), BWD_E_BYTES);
        for (int b = 0; b < 8; ++b)
          msim::tma_load(e_base + b * BWD_BOX, (b & 4) ? &map_lo_t : &map_hi_t,
                         t * BWD_BN + ((b >> 1) & 1) * msim::TF32_BK,
                         k0 + (b & 1) * msim::WG_BOX,
                         msim::smem_u32(&sh.e_full));
      }
    }
    return;
  }

  const int w = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int q = lane & 3;
  // this thread's two rows of both accumulators (wgmma's D fragment)
  int rr[2];
  float sq_i[2], sqp_i[2], v_i[2], fp_i[2], cn_i[2], gfp_i[2], gcn_i[2];
  long long la[2];
  bool iin[2];
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2) + 8 * h;
    const int i = row0 + rr[h];
    iin[h] = i < n;
    sq_i[h] = iin[h] ? sq[i] : 0.f;
    sqp_i[h] = iin[h] ? sq_pen[i] : 0.f;
    v_i[h] = iin[h] ? valid[i] : 0.f;
    fp_i[h] = iin[h] ? fp[i] : 0.f;
    cn_i[h] = iin[h] ? cn[i] : 0.f;
    gfp_i[h] = iin[h] ? gfp[i] : 0.f;
    gcn_i[h] = iin[h] ? gcn[i] : 0.f;
    la[h] = iin[h] ? labels[i] : 0;
  }
  // column data a tile ahead: thread e < 64 owns column e of each tile
  const int e = threadIdx.x;
  float4 side[2];
  long long side_lab;
  if (e < BWD_BN) {
    load_bwd_col(sq, sq_pen, valid, fp, cn, gfp, gcn, labels,
                 t_begin * BWD_BN + e, n, side, side_lab);
    sh.col[0][e][0] = side[0];
    sh.col[0][e][1] = side[1];
    sh.lab[0][e] = side_lab;
    if (t_begin + 1 < t_end)
      load_bwd_col(sq, sq_pen, valid, fp, cn, gfp, gcn, labels,
                   (t_begin + 1) * BWD_BN + e, n, side, side_lab);
  }
  msim::bar_sync(1, BWD_CONSUMERS);

  float g[BWD_DC / 4];   // 64 rows x this warpgroup's 64 gradient columns
#pragma unroll
  for (int x = 0; x < BWD_DC / 4; ++x) g[x] = 0.f;
  msim::fence_regs(g);
  int it = 0;
  for (int t = t_begin, k = 0; t < t_end; ++t, ++k) {
    const int b = k & 1;
    // <e_i, e_j> for the 64 rows and this warpgroup's 32 columns; it ends
    // with every product done, the last tile's C E product included
    float s[16];
    ring.product_part(s, it, k_slices, 0, w * 32 * msim::TF32_BK * 4);
    if (k > 0) msim::mbar_arrive(msim::smem_u32(&sh.e_empty));
    // C is free once both warpgroups' products of the last tile are done
    msim::bar_sync(1, BWD_CONSUMERS);

    // C_ij + C_ji of element x: row rr[(x / 2) % 2], tile column
    // 32 w + 8 (x / 4) + 2 q + x % 2
    float c[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = (x >> 1) & 1;
      const int jj = 32 * w + 8 * (x >> 2) + 2 * q + (x & 1);
      const float4 ca = sh.col[b][jj][0], cb = sh.col[b][jj][1];
      const long long lb = sh.lab[b][jj];
      const bool self = row0 + rr[h] == t * BWD_BN + jj;
      // row i over column j (i's stats), and row j over column i (j's)
      const float d1 = fmaxf(__fmaf_rn(-2.f, s[x], sq_i[h] + ca.y), 0.f);
      const float d2 = fmaxf(__fmaf_rn(-2.f, s[x], ca.x + sqp_i[h]), 0.f);
      const bool same1 = ca.z > 0.f && la[h] == lb;
      const bool same2 = v_i[h] > 0.f && la[h] == lb;
      const float x1 = __expf(same1
          ? (d1 - (1.f - ca.z) * POS_INF) - fp_i[h]
          : (margin - d1) - cn_i[h]);
      const float x2 = __expf(same2
          ? (d2 - (1.f - v_i[h]) * POS_INF) - cb.x
          : (margin - d2) - cb.y);
      const float c1 = same1 ? (self ? 0.f : gfp_i[h] * x1)
                             : -(gcn_i[h] * (x1 * ca.z));
      const float c2 = same2 ? (self ? 0.f : cb.z * x2)
                             : -(cb.w * (x2 * v_i[h]));
      c[x] = (ca.w > 0.f && iin[h]) ? c1 + c2 : 0.f;
      rowsum[h] += c[x];
    }
    // C into k-slice w, hi then lo: element (r, jj) of a slice
    // at r * 128 + ((jj / 4) ^ (r % 8)) * 16 + (jj % 4) * 4, TMA's swizzle
    unsigned char* cb_hi = smem + BWD_C + w * BWD_BOX;
#pragma unroll
    for (int x = 0; x < 16; x += 2) {
      const int r = rr[(x >> 1) & 1];
      const int chunk = 2 * (x >> 2) + (q >> 1);
      const int at = r * 128 + ((chunk ^ (r & 7)) << 4) + (q & 1) * 8;
      const float h0 = tf32_hi(c[x]), h1 = tf32_hi(c[x + 1]);
      *reinterpret_cast<float2*>(cb_hi + at) = make_float2(h0, h1);
      *reinterpret_cast<float2*>(cb_hi + 2 * BWD_BOX + at) =
          make_float2(c[x] - h0, c[x + 1] - h1);
    }
    // the next tile's column data into the other buffer (its last reader,
    // tile k - 1, is past the barrier below)
    if (e < BWD_BN && t + 1 < t_end) {
      sh.col[b ^ 1][e][0] = side[0];
      sh.col[b ^ 1][e][1] = side[1];
      sh.lab[b ^ 1][e] = side_lab;
      if (t + 2 < t_end)
        load_bwd_col(sq, sq_pen, valid, fp, cn, gfp, gcn, labels,
                     (t + 2) * BWD_BN + e, n, side, side_lab);
    }
    // C, written by the generic proxy, is read by wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    msim::bar_sync(1, BWD_CONSUMERS);

    // g += C E_tile in 3xTF32, left in flight under the next tile's
    // distance products
    msim::mbar_wait(msim::smem_u32(&sh.e_full), k & 1);
    const uint32_t c_hi = c_base, c_lo = c_hi + 2 * BWD_BOX;
    const uint32_t e_hi = e_base + w * BWD_BOX, e_lo = e_hi + 4 * BWD_BOX;
    msim::fence_regs(g);
    msim::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int kk = 0; kk < msim::TF32_BK / 8; ++kk) {
        const uint32_t a = ks * BWD_BOX + 32 * kk;
        const uint32_t bo = ks * 2 * BWD_BOX + 32 * kk;
        msim::tf32_step(g, msim::smem_desc(c_hi + a),
                        msim::smem_desc(e_lo + bo));
        msim::tf32_step(g, msim::smem_desc(c_lo + a),
                        msim::smem_desc(e_hi + bo));
        msim::tf32_step(g, msim::smem_desc(c_hi + a),
                        msim::smem_desc(e_hi + bo));
      }
    msim::wgmma_commit();
  }
  msim::wgmma_wait<0>();
  msim::fence_regs(g);

  // row sums: the four threads of a row, then the two warpgroups, in a
  // fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 1);
    rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 2);
    if (q == 0) sh.rowsum[w][rr[h]] = rowsum[h];
  }
  msim::bar_sync(1, BWD_CONSUMERS);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rowsum[h] = sh.rowsum[0][rr[h]] + sh.rowsum[1][rr[h]];

  // element x of g: row rr[(x / 2) % 2], column k0 + 64 w + 8 (x / 4) +
  // 2 q + x % 2; one range writes the gradient, several their partials
  const bool direct = gridDim.y == 1;
  float* out = direct ? grad : partial + (size_t)blockIdx.y * n * d;
#pragma unroll
  for (int x = 0; x < BWD_DC / 4; ++x) {
    const int h = (x >> 1) & 1;
    const int i = row0 + rr[h];
    const int kc = k0 + 64 * w + 8 * (x >> 2) + 2 * q + (x & 1);
    if (!iin[h] || kc >= d) continue;
    const size_t at = (size_t)i * d + kc;
    out[at] = direct ? 2.f * (rowsum[h] * emb[at] - g[x]) : g[x];
  }
  if (!direct && blockIdx.z == 0 && w == 0 && q == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (iin[h]) rowsum_part[(size_t)blockIdx.y * n + row0 + rr[h]] =
          rowsum[h];
}

// grad = 2 (rowsum e - G), rowsum and G summed over ranges 0..S-1 in
// ascending order
__global__ void __launch_bounds__(THREADS)
lifted_bwd_combine(const float* __restrict__ partial,
                   const float* __restrict__ rowsum_part,
                   const float* __restrict__ emb, int n, int d, int ranges,
                   float* __restrict__ grad) {
  const size_t at = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t total = (size_t)n * d;
  if (at >= total) return;
  const int i = static_cast<int>(at / d);
  float g = partial[at], rs = rowsum_part[i];
  for (int r = 1; r < ranges; ++r) {
    g += partial[r * total + at];
    rs += rowsum_part[(size_t)r * n + i];
  }
  grad[at] = 2.f * (rs * emb[at] - g);
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

// ------------------------------------------- K6, f32 on the tensor cores ----

// lifted_tri_tc: persistent CTAs over work items of TRI_ROWS = 64 rows by
// BN = 64 or 32 columns of the upper triangle (TriWalk), in three roles,
// as K3's batch_hard_tri_tc.  The column warpgroup splits each k-slice of
// the f32 operand in place (msim::SplitRing::split); one MMA warpgroup
// issues the 3xTF32 products of the split slices, then runs the row side
// on the accumulator fragment: one exponential a
// pair, e = exp(eq ? dist : margin - dist), P = eq && i != j ? e : 1, Ng =
// eq ? 0 : e, summed over the columns weighted by valid[j]; off the
// diagonal it also stores s = eq ? P : -e (the sign bit marks a negative,
// -0 included) to one of two shared tiles.  The column warpgroup, once it
// has split the next item's slices, reduces that tile along its columns,
// weighted by valid[i] (128 / BN threads a column, each over a run of
// rows, merged in ascending order), while the MMA warpgroup goes on to the
// next item's products: the split and the column side run beside the
// MMA warpgroup's products and row side.  One producer warp
// keeps the TMA loads in flight.  Each item's side data (norm, valid,
// label of its rows and columns) is loaded an item ahead.
constexpr int TRI_ROWS = msim::WG_BOX;
constexpr int TRI_THREADS = 256 + 32;
constexpr int TRI_STAGES = 4;

template <int BN>
struct TriTcSmem {
  static constexpr int PITCH = BN + 8;   // floats: conflict-free float2 stores
  static constexpr int TPC = 128 / BN;   // column-side threads a column
  float tile[2][TRI_ROWS][PITCH];        // s of the off-diagonal items
  float vrow[2][TRI_ROWS];               // valid[i] of each tile's rows
  float2 row_info[TRI_ROWS];             // (sq, valid) of the item's rows
  float2 col_info[BN];                   // ... and of its columns
  long long row_lab[TRI_ROWS], col_lab[BN];
  float colpart[2][3][TPC - 1][BN];      // the column side's later parts
  uint64_t tile_full[2], tile_empty[2];
};

template <int BN>
constexpr int tri_tc_smem() {
  return msim::SplitRing<TRI_ROWS, BN, TRI_STAGES>::BYTES +
         sizeof(TriTcSmem<BN>) + 1024;
}

// The upper-triangle work items in row-major order, from item `first` in
// steps of `step`: row block ti (64 rows) takes the column blocks cb = ti
// r .. n_cb - 1 of 64 / r columns, so an item starts at or right of its
// rows' diagonal block.
struct TriWalk {
  int n_cb, r, ti, rem;   // rem: the item's offset in row block ti

  __device__ TriWalk(int n_cb_, int r_, int first)
      : n_cb(n_cb_), r(r_), ti(0), rem(first) {
    settle();
  }
  __device__ void settle() {
    while (ti * r < n_cb && rem >= n_cb - ti * r) {
      rem -= n_cb - ti * r;
      ++ti;
    }
  }
  __device__ bool done() const { return ti * r >= n_cb; }
  __device__ int cb() const { return ti * r + rem; }
  __device__ void advance(int step) {
    rem += step;
    settle();
  }
};

// entry `idx` of the side data: (sq, valid) and the label; zeros past n
__device__ __forceinline__ void load_tri_side(
    const float* __restrict__ sq, const float* __restrict__ valid,
    const long long* __restrict__ labels, int idx, int n, float2& f,
    long long& lab) {
  if (idx < n) {
    f = make_float2(sq[idx], valid[idx]);
    lab = labels[idx];
  } else {
    f = make_float2(0.f, 0.f);
    lab = 0;
  }
}

// The column side of off-diagonal item (ti, cb), the od-th of the CTA, by
// column thread t: column c of the tile over rows part RP .. part RP + RP
// - 1, ascending, the parts merged in ascending order into slot ti R of
// column cb BN + c.
template <int BN>
__device__ __forceinline__ void tri_column_side(TriTcSmem<BN>& sh, int od,
                                                int ti, int cb, int t, int n,
                                                float* __restrict__ partial) {
  constexpr int R = TRI_ROWS / BN;
  constexpr int TPC = TriTcSmem<BN>::TPC;
  constexpr int RP = TRI_ROWS / TPC;
  const int c = t % BN, part = t / BN;
  const int b = od & 1;
  msim::mbar_wait(msim::smem_u32(&sh.tile_full[b]), (od >> 1) & 1);
  float cp = 0.f, cq = 0.f, cc = 0.f;
#pragma unroll 8
  for (int r = part * RP; r < (part + 1) * RP; ++r) {
    const float s = sh.tile[b][r][c];
    const float v = sh.vrow[b][r];
    const bool neg = __float_as_uint(s) >> 31;
    cp += (neg ? 1.f : s) * v;
    cq += (neg ? -s : 0.f) * v;
    cc += neg ? v : 0.f;
  }
  msim::mbar_arrive(msim::smem_u32(&sh.tile_empty[b]));
  if (part > 0) {
    sh.colpart[b][0][part - 1][c] = cp;
    sh.colpart[b][1][part - 1][c] = cq;
    sh.colpart[b][2][part - 1][c] = cc;
  }
  msim::bar_sync(2, 128);
  const int j = cb * BN + c;
  if (part == 0 && j < n) {
#pragma unroll
    for (int p = 0; p < TPC - 1; ++p) {
      cp += sh.colpart[b][0][p][c];
      cq += sh.colpart[b][1][p][c];
      cc += sh.colpart[b][2][p][c];
    }
    const size_t plane = (size_t)((n + BN - 1) / BN) * n;
    const size_t at = (size_t)(ti * R) * n + j;
    partial[at] = cp;
    partial[plane + at] = cq;
    partial[2 * plane + at] = cc;
  }
}

template <int BN>
__global__ void __launch_bounds__(TRI_THREADS, 1)
lifted_tri_tc(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, int n, int d4,
              const float* __restrict__ sq,
              const long long* __restrict__ labels,
              const float* __restrict__ valid, float margin,
              float* __restrict__ partial) {
  constexpr int R = TRI_ROWS / BN;
  using Ring = msim::SplitRing<TRI_ROWS, BN, TRI_STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = msim::align_1024(smem_raw);
  const Ring ring{smem, msim::smem_u32(smem)};
  TriTcSmem<BN>& sh = *reinterpret_cast<TriTcSmem<BN>*>(smem + Ring::BYTES);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      msim::mbar_init(msim::smem_u32(&sh.tile_full[b]), 128);
      msim::mbar_init(msim::smem_u32(&sh.tile_empty[b]), 128);
    }
    ring.init();   // ends with the barrier-init fence
  }
  __syncthreads();

  const int k_slices = (d4 + msim::TF32_BK - 1) / msim::TF32_BK;
  const int n_cb = (n + BN - 1) / BN;
  const size_t plane = (size_t)n_cb * n;   // partial is [3][n_cb][n]

  if (threadIdx.x >= 256) {   // the producer warp: one thread loads
    if (threadIdx.x == 256) {
      int it = 0;
      for (TriWalk w(n_cb, R, blockIdx.x); !w.done(); w.advance(gridDim.x))
        ring.load(&map_a, &map_b, it, w.ti * TRI_ROWS, w.cb() * BN, n, n,
                  k_slices);
    }
    return;
  }

  if (threadIdx.x >= 128) {
    // ---- column warpgroup: splits each item's k-slices for the MMA
    // warpgroup, then runs the column side of the item before it (whose
    // row side the MMA warpgroup runs meanwhile); the diagonal's row side
    // covers both ways
    const int t = threadIdx.x - 128;
    int it = 0, od = 0;   // ring slices split, off-diagonal items done
    int pend_ti = -1, pend_cb = 0;   // the item whose column side waits
    for (TriWalk w(n_cb, R, blockIdx.x); !w.done(); w.advance(gridDim.x)) {
      ring.split(it, k_slices, t);
      if (pend_ti >= 0) tri_column_side<BN>(sh, od++, pend_ti, pend_cb, t, n,
                                            partial);
      pend_ti = w.cb() / R != w.ti ? w.ti : -1;
      pend_cb = w.cb();
    }
    if (pend_ti >= 0) tri_column_side<BN>(sh, od, pend_ti, pend_cb, t, n,
                                          partial);
    return;
  }

  // ---- MMA warpgroup: the split and the products, then the row side
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, q = lane & 3;
  TriWalk w(n_cb, R, blockIdx.x);
  // thread t < 64 carries row t's side data, 64 <= t < 64 + BN column
  // t - 64's, an item ahead
  float2 side = make_float2(0.f, 0.f);
  long long side_lab = 0;
  if (!w.done()) {
    if (t < TRI_ROWS)
      load_tri_side(sq, valid, labels, w.ti * TRI_ROWS + t, n, side,
                    side_lab);
    else if (t < TRI_ROWS + BN)
      load_tri_side(sq, valid, labels, w.cb() * BN + t - TRI_ROWS, n, side,
                    side_lab);
  }
  int it = 0, od = 0;
  while (!w.done()) {
    const int ti = w.ti, cb = w.cb();
    const int row0 = ti * TRI_ROWS, col0 = cb * BN;
    const bool off = cb / R != ti;   // uniform over the CTA

    float acc[BN / 2];
    ring.product_split(acc, it, k_slices);

    // the last item's row side is done with the side data
    msim::bar_sync(1, 128);
    if (t < TRI_ROWS) {
      sh.row_info[t] = side;
      sh.row_lab[t] = side_lab;
    } else if (t < TRI_ROWS + BN) {
      sh.col_info[t - TRI_ROWS] = side;
      sh.col_lab[t - TRI_ROWS] = side_lab;
    }
    w.advance(gridDim.x);
    if (!w.done()) {
      if (t < TRI_ROWS)
        load_tri_side(sq, valid, labels, w.ti * TRI_ROWS + t, n, side,
                      side_lab);
      else if (t < TRI_ROWS + BN)
        load_tri_side(sq, valid, labels, w.cb() * BN + t - TRI_ROWS, n,
                      side, side_lab);
    }
    msim::bar_sync(1, 128);

    // the column side has released this buffer's last tile (passes at once
    // for the first two)
    const int b = od & 1;
    if (off)
      msim::mbar_wait(msim::smem_u32(&sh.tile_empty[b]), ((od >> 1) & 1) ^ 1);
    // row side: this thread's two fragment rows over its columns (wgmma's
    // D: element 4 g + 2 h + c at row 16 warp + lane / 4 + 8 h, column
    // 8 g + 2 q + c), without branches: a column past n weighs 0, a row
    // past n is never stored
    int rr[2], ia[2];
    float sq_i[2], v_i[2], rp[2], rn[2], rc[2];
    long long l_i[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rr[h] = 16 * warp + (lane >> 2) + 8 * h;
      ia[h] = row0 + rr[h];
      const float2 ri = sh.row_info[rr[h]];
      sq_i[h] = ri.x;
      v_i[h] = ri.y;
      l_i[h] = sh.row_lab[rr[h]];
      rp[h] = rn[h] = rc[h] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      float sv[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * g + 2 * q + c;
        const float2 cj = sh.col_info[col];
        const long long l_j = sh.col_lab[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // (sq[i] + sq[j]) - 2 acc, one rounding; symmetric in i and j
          const float dist =
              fmaxf(__fmaf_rn(-2.f, acc[4 * g + 2 * h + c], sq_i[h] + cj.x),
                    0.f);
          const bool eq = l_i[h] == l_j;
          // one exponential a pair, by the SFU (__expf, a few 1e-7
          // relative; exact at 0)
          const float e = __expf(eq ? dist : margin - dist);
          const float p = (eq && ia[h] != col0 + col) ? e : 1.f;
          rp[h] += p * cj.y;
          rn[h] += (eq ? 0.f : e) * cj.y;
          rc[h] += eq ? 0.f : cj.y;
          sv[h][c] = eq ? p : -e;
        }
      }
      if (off)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&sh.tile[b][rr[h]][8 * g + 2 * q]) =
              make_float2(sv[h][0], sv[h][1]);
    }
    if (off) {
      if (q == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) sh.vrow[b][rr[h]] = v_i[h];
      msim::mbar_arrive(msim::smem_u32(&sh.tile_full[b]));
      ++od;
    }
    // ... summed over the quad of lanes that share the rows; rows i's sums
    // over column block cb go to slot cb of row i
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        rp[h] += __shfl_xor_sync(0xffffffffu, rp[h], o);
        rn[h] += __shfl_xor_sync(0xffffffffu, rn[h], o);
        rc[h] += __shfl_xor_sync(0xffffffffu, rc[h], o);
      }
      if (q == 0 && ia[h] < n) {
        const size_t at = (size_t)cb * n + ia[h];
        partial[at] = rp[h];
        partial[plane + at] = rn[h];
        partial[2 * plane + at] = rc[h];
      }
    }
  }
}

// row i's sums from partial[.][0..n_cb - 1][i] in ascending column order:
// the column side's slots left of its diagonal block (every r-th), then
// the row side's from it on; fp = log(max(sum, 1e-30)) as the FMA K6
__global__ void __launch_bounds__(THREADS)
lifted_tri_combine(const float* __restrict__ partial, int n, int n_cb,
                   int r, float* __restrict__ fp_out,
                   float* __restrict__ cn_out, float* __restrict__ nc_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t plane = (size_t)n_cb * n;
  const int first = (i / TRI_ROWS) * r;
  float s[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < first; b += r)
#pragma unroll
    for (int x = 0; x < 3; ++x) s[x] += partial[x * plane + (size_t)b * n + i];
  for (int b = first; b < n_cb; ++b)
#pragma unroll
    for (int x = 0; x < 3; ++x) s[x] += partial[x * plane + (size_t)b * n + i];
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
  // the accumulator's width: d rounded up to 128, at most BWD_CHUNK
  const int kc = std::min((d + 127) / 128 * 128, BWD_CHUNK);
  const size_t dyn = (size_t)BM * kc * sizeof(float);
  const cudaError_t rc = cudaFuncSetAttribute(
      lifted_bwd_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  lifted_bwd_kernel<T, TM><<<(n + BM - 1) / BM, THREADS, dyn, s>>>(
      static_cast<const T*>(emb), n, d, kc, sq, sq_pen, labels, valid, fp,
      cn, gfp, gcn, margin, grad);
  return 0;
}

int launch_fwd_tc(const float* hi, const float* lo, int n, int d, int split,
                  const float* sq, const float* sq_pen,
                  const long long* labels, const float* valid, float margin,
                  float* partial, float* fp, float* cn, float* nc,
                  cudaStream_t s) {
  CUtensorMap map_hi, map_lo;
  int rc = msim::make_tensor_map_f32(&map_hi, hi, n, d);
  if (rc != 0) return rc;
  rc = msim::make_tensor_map_f32(&map_lo, lo, n, d);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(lifted_fwd_tc,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  // `split` ranges of whole tiles, none of them empty
  const int n_tiles = (n + FWD_BN - 1) / FWD_BN;
  const int per = (n_tiles + split - 1) / split;
  const int ranges = (n_tiles + per - 1) / per;
  const dim3 grid((n + msim::WG_BOX - 1) / msim::WG_BOX, ranges);
  lifted_fwd_tc<<<grid, FWD_THREADS, FWD_SMEM, s>>>(
      map_hi, map_lo, n, d, per, sq, sq_pen, labels, valid, margin, partial);
  lifted_fwd_combine<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, n, ranges, fp, cn, nc);
  return 0;
}

int launch_bwd_tc(const float* hi, const float* lo, const float* hi_t,
                  const float* lo_t, const float* emb, int n, int d, int d4,
                  int split, const float* sq, const float* sq_pen,
                  const long long* labels, const float* valid,
                  const float* fp, const float* cn, const float* gfp,
                  const float* gcn, float margin, float* partial,
                  float* rowsum_part, float* grad, cudaStream_t s) {
  const int n_tiles = (n + BWD_BN - 1) / BWD_BN;
  const int chunks = (d + BWD_DC - 1) / BWD_DC;
  CUtensorMap map_hi, map_lo, map_hi_t, map_lo_t;
  int rc = msim::make_tensor_map_f32(&map_hi, hi, n, d4);
  if (rc == 0) rc = msim::make_tensor_map_f32(&map_lo, lo, n, d4);
  if (rc == 0)
    rc = msim::make_tensor_map_f32(&map_hi_t, hi_t, chunks * BWD_DC,
                                   n_tiles * BWD_BN);
  if (rc == 0)
    rc = msim::make_tensor_map_f32(&map_lo_t, lo_t, chunks * BWD_DC,
                                   n_tiles * BWD_BN);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(lifted_bwd_tc,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  // `split` ranges of whole tiles, none of them empty
  const int per = (n_tiles + split - 1) / split;
  const int ranges = (n_tiles + per - 1) / per;
  const dim3 grid((n + msim::WG_BOX - 1) / msim::WG_BOX, ranges, chunks);
  lifted_bwd_tc<<<grid, BWD_THREADS, BWD_SMEM, s>>>(
      map_hi, map_lo, map_hi_t, map_lo_t, emb, n, d, d4, per, sq, sq_pen,
      labels, valid, fp, cn, gfp, gcn, margin, partial, rowsum_part, grad);
  if (ranges > 1) {
    const size_t total = (size_t)n * d;
    lifted_bwd_combine<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                         0, s>>>(partial, rowsum_part, emb, n, d, ranges,
                                 grad);
  }
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

template <int BN>
int launch_tri_tc(const float* emb, int n, int d4, const float* sq,
                  const long long* labels, const float* valid, float margin,
                  float* partial, float* fp, float* cn, float* nc,
                  cudaStream_t s) {
  using Ring = msim::SplitRing<TRI_ROWS, BN, TRI_STAGES>;
  CUtensorMap map_a, map_b;
  int rc = msim::make_tensor_map_f32(&map_a, emb, n, d4);
  if (rc == 0)
    rc = msim::make_tensor_map_f32_rows(&map_b, emb, n, d4, Ring::B_BOX);
  if (rc != 0) return rc;
  constexpr int smem = tri_tc_smem<BN>();
  cudaFuncSetAttribute(lifted_tri_tc<BN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // persistent: one CTA an SM, or one per work item
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int R = TRI_ROWS / BN;
  const int n_cb = (n + BN - 1) / BN;
  const int t = (n + TRI_ROWS - 1) / TRI_ROWS;
  const long long items = (long long)t * n_cb - (long long)R * t * (t - 1) / 2;
  lifted_tri_tc<BN><<<items < sms ? (int)items : sms, TRI_THREADS, smem,
                      s>>>(map_a, map_b, n, d4, sq, labels, valid, margin,
                           partial);
  lifted_tri_combine<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, n, n_cb, R, fp, cn, nc);
  return 0;
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers of
// contiguous tensors: emb [n, d] (bf16 when emb_is_bf16, else f32); sq,
// sq_pen, valid and the per-row stats [n] f32; labels [n] int64.  Each
// launches on `stream` without synchronising and returns
// cudaGetLastError() (or the error of the launch set-up).

// K4 for a bf16 emb [n, d] (an f32 one takes lifted_fwd_tf32): fp, cn, nc
// [n] f32.
extern "C" int lifted_fwd(const void* emb, int n, int d, const float* sq,
                          const float* sq_pen, const long long* labels,
                          const float* valid, float margin, float* fp,
                          float* cn, float* nc, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_rows(n))
    launch_fwd<__nv_bfloat16, 4>(emb, n, d, sq, sq_pen, labels, valid,
                                 margin, fp, cn, nc, s);
  else
    launch_fwd<__nv_bfloat16, 1>(emb, n, d, sq, sq_pen, labels, valid,
                                 margin, fp, cn, nc, s);
  return static_cast<int>(cudaGetLastError());
}

// K4 for an f32 emb on the tensor cores: hi and lo [n, d] f32, the TF32
// split of emb (d a multiple of 4, bases 16-byte aligned); the column tiles
// cut into `split` ranges through `partial`, at least split * 5 * n floats.
// Two launches: the tile walk, then the ascending-order combine.  Returns
// as lifted_fwd, or msim::ENCODE_ERROR (+ the CUresult) when a tensor map
// cannot be built.
extern "C" int lifted_fwd_tf32(const float* hi, const float* lo, int n, int d,
                               int split, const float* sq,
                               const float* sq_pen, const long long* labels,
                               const float* valid, float margin,
                               float* partial, float* fp, float* cn,
                               float* nc, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || d % 4 != 0 || split < 1 ||
      reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_fwd_tc(hi, lo, n, d, split, sq, sq_pen, labels,
                               valid, margin, partial, fp, cn, nc,
                               static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K5 for a bf16 emb [n, d] (an f32 one takes lifted_bwd_tf32): grad [n, d]
// f32 = the straight plus the transposed pass, any d (the depth is walked
// in chunks of BWD_CHUNK columns beyond that).
extern "C" int lifted_bwd(const void* emb, int n, int d, const float* sq,
                          const float* sq_pen, const long long* labels,
                          const float* valid, const float* fp,
                          const float* cn, const float* gfp, const float* gcn,
                          float margin, float* grad, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      wide_rows(n)
          ? launch_bwd<__nv_bfloat16, 4>(emb, n, d, sq, sq_pen, labels, valid,
                                         fp, cn, gfp, gcn, margin, grad, s)
          : launch_bwd<__nv_bfloat16, 1>(emb, n, d, sq, sq_pen, labels, valid,
                                         fp, cn, gfp, gcn, margin, grad, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K5 for an f32 emb [n, d] on the tensor cores: hi and lo [n, d4], the TF32
// split of emb padded to d4 (a multiple of 4, d4 >= d), and hi_t and lo_t
// [ceil(d / 128) 128, ceil(n / 64) 64], the TF32 split of emb^T zero-padded
// (all bases 16-byte aligned).  The column tiles are cut into `split`
// ranges; with more than one, the ranges go through `partial` (at least
// split * n * d floats) and `rowsum_part` (split * n) to a second launch
// that adds them in ascending order.  Returns as lifted_bwd, or
// msim::ENCODE_ERROR (+ the CUresult) when a tensor map cannot be built.
extern "C" int lifted_bwd_tf32(const float* hi, const float* lo,
                               const float* hi_t, const float* lo_t,
                               const float* emb, int n, int d, int d4,
                               int split, const float* sq,
                               const float* sq_pen, const long long* labels,
                               const float* valid, const float* fp,
                               const float* cn, const float* gfp,
                               const float* gcn, float margin,
                               float* partial, float* rowsum_part,
                               float* grad, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || d4 < d || d4 % 4 != 0 || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const float* p : {hi, lo, hi_t, lo_t})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_bwd_tc(hi, lo, hi_t, lo_t, emb, n, d, d4, split, sq,
                               sq_pen, labels, valid, fp, cn, gfp, gcn,
                               margin, partial, rowsum_part, grad,
                               static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K6 for a bf16 emb [n, d] (an f32 one takes lifted_fwd_tri_tf32): fp,
// cn, nc [n] f32 through the partials buffer `partial`, at least 3 * T * T
// * block floats with T = ceil(n / block); block is 32 or 64.
extern "C" int lifted_fwd_tri(const void* emb, int n, int d, int block,
                              const float* sq, const long long* labels,
                              const float* valid, float margin,
                              float* partial, float* fp, float* cn,
                              float* nc, void* stream) {
  if (n <= 0) return 0;
  if (block != 32 && block != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 64)
    launch_tri<__nv_bfloat16, 4>(emb, n, d, sq, labels, valid, margin,
                                 partial, fp, cn, nc, s);
  else
    launch_tri<__nv_bfloat16, 2>(emb, n, d, sq, labels, valid, margin,
                                 partial, fp, cn, nc, s);
  return static_cast<int>(cudaGetLastError());
}

// K6 for an f32 emb [n, d4] on the tensor cores (d4 a multiple of 4, base
// 16-byte aligned; the split into hi and lo happens in the kernel): work
// items of 64 rows by `cols` (64 or 32) columns, through the partials
// buffer `partial`, at least 3 * ceil(n / cols) * n floats.  Two
// launches: the tile walk, then the ascending-order combine.  Returns as
// lifted_fwd, or msim::ENCODE_ERROR (+ the CUresult) when a tensor map
// cannot be built.
extern "C" int lifted_fwd_tri_tf32(const float* emb, int n, int d4, int cols,
                                   const float* sq, const long long* labels,
                                   const float* valid, float margin,
                                   float* partial, float* fp, float* cn,
                                   float* nc, void* stream) {
  if (n <= 0) return 0;
  if (d4 <= 0 || d4 % 4 != 0 || (cols != 32 && cols != 64) ||
      reinterpret_cast<uintptr_t>(emb) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      cols == 64
          ? launch_tri_tc<64>(emb, n, d4, sq, labels, valid, margin, partial,
                              fp, cn, nc, s)
          : launch_tri_tc<32>(emb, n, d4, sq, labels, valid, margin, partial,
                              fp, cn, nc, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
