"""Triangular lifted-structured forward for l2-normalised embeddings.

Port of the JAX package's ``ops/pallas/lifted_tri.py``.  Squared distances
of l2-normalised rows lie in [0, 4], so ``exp`` cannot overflow and the
plain running sums of exponentials are the logsumexps: no max tracking.
The pairwise values are symmetric, so only the upper-triangle tile pairs
are visited, and each is reduced both ways from one pair of shared tiles

  P  = exp(same_label && i != j ? dist : 0)    positives + the exp(0) quirk
  Ng = same_label ? 0 : exp(margin - dist)     negatives

weighted by the validity of the other side (row side by valid[j], column
side by valid[i]).  Labels are real on both sides: an invalid entry may
classify either way, its weight is 0.  fp = log(max(sum, 1e-30)), so a row
with no valid negative gets cn = log(1e-30), not the row kernel's -1e30.

Kernel (CUDA C++, ``csrc/lifted.cu``): ``lifted_fwd_tri`` (K6) replaces
``_tri_lifted_kernel`` (via ``lifted_fwd_tri``).  On the TPU the grid ran in
order and each step added into resident accumulators.  On the GPU the tiles
run in no order, so each writes its sums to a partials buffer that this
wrapper allocates, every entry exactly once, and a second launch sums each
row's partials in ascending column order.  Both launches are one K6 call
(one count in ``LAUNCHES``); no float atomics, so results are
bit-identical from run to run.

* An f32 operand runs its products on the tensor cores through 3xTF32
  (``lifted_tri_tc`` on ``csrc/wgmma_split.cuh``): the kernel splits each
  TMA-loaded f32 k-slice into hi and lo in shared memory itself, so the
  wrapper only pads the depth to a multiple of 4 and copies a base that
  is not 16-byte aligned (``distance.tma_depth``; zero columns change no
  product).  Persistent CTAs walk work items of 64 rows by :func:`tri_cols`
  columns of the upper triangle; the row side is reduced on the
  accumulator fragment with one exponential a pair, the column side from a
  shared tile of the same values.  Partials are [3, ceil(N / cols), N]:
  slot ``cb`` of row i holds i's sums over column block cb.
* A bf16 operand keeps the first port's FMA walk (``lifted_tri_kernel``):
  one CTA per upper-triangle pair of :func:`tri_block`-wide tiles,
  partials [3, T, T, B].

A CPU tensor takes :func:`lifted_fwd_tri_plain`, the dense PyTorch version.
Precision as in ``ops/kernels/lifted.py``: f32 epilogue in both modes.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    Operands, check_operands, on_cpu, sm_count)
from multimodal_similarity_tpu_torch.ops.kernels.distance import tma_depth

LAUNCHES.update(lifted_fwd_tri=0)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
             + [ctypes.c_float] + [ctypes.c_void_p] * 5)
_TF32_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 5)
# rows of a work item of the f32 kernel (one wgmma warpgroup)
TC_ROWS = 64


def lifted_fwd_tri_plain(ops: Operands, margin: float):
    """Plain PyTorch version of K6: dense [N, N] row sums of the same P, Ng
    and negative indicator, f32 epilogue.  Returns (fp, cn, nc)."""
    opd = ops.opd.float()
    n = opd.shape[0]
    dist = torch.clamp((ops.sq[:, None] + ops.sq[None, :])
                       - 2.0 * (opd @ opd.T), min=0.0)
    eq = ops.labels[:, None] == ops.labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    zero = torch.zeros_like(dist)
    p = torch.exp(torch.where(eq & ~eye, dist, zero))
    ng = torch.where(eq, zero, torch.exp(margin - dist))
    nm = torch.where(eq, zero, torch.ones_like(dist))
    w = ops.valid[None, :]
    fps, cns, nc = (p * w).sum(1), (ng * w).sum(1), (nm * w).sum(1)
    return (torch.log(torch.clamp(fps, min=1e-30)),
            torch.log(torch.clamp(cns, min=1e-30)), nc)


def tri_block(n: int, sms: int) -> int:
    """Tile edge of the triangular walk: 64 once its tile pairs fill every
    SM, else 32."""
    t64 = -(-n // 64)
    return 64 if t64 * (t64 + 1) // 2 >= sms else 32


def tri_cols(n: int, sms: int) -> int:
    """Columns of a work item of the f32 K6 (64 rows each) for N rows on a
    card with ``sms`` SMs: 64 once the upper triangle's 64 x 64 tile pairs
    fill every SM, else 32 (twice the items)."""
    t = -(-n // TC_ROWS)
    return 64 if t * (t + 1) // 2 >= sms else 32


def lifted_fwd_tri_kernel(ops: Operands, margin: float):
    """Launch K6 (the tile walk and its ascending-order combine) on the
    operands' CUDA device, on the current stream: the 3xTF32 walk for an
    f32 operand, the FMA walk for a bf16 one.  Same returns as
    :func:`lifted_fwd_tri_plain`."""
    opd = ops.opd
    n, d = check_operands(ops, "lifted_fwd_tri_kernel")
    sms = sm_count(opd.device)
    fp, cn, nc = (torch.empty(n, dtype=torch.float32, device=opd.device)
                  for _ in range(3))
    side = (ops.sq.data_ptr(), ops.labels.data_ptr(), ops.valid.data_ptr(),
            float(margin))
    with torch.cuda.device(opd.device):
        stream = torch.cuda.current_stream().cuda_stream
        if opd.dtype == torch.bfloat16:
            block = tri_block(n, sms)
            n_tiles = -(-n // block)
            partial = torch.empty(3 * n_tiles * n_tiles * block,
                                  dtype=torch.float32, device=opd.device)
            fn = bind("lifted", "lifted_fwd_tri", _ARGTYPES)
            rc = fn(opd.data_ptr(), n, d, block, *side,
                    partial.data_ptr(), fp.data_ptr(), cn.data_ptr(),
                    nc.data_ptr(), stream)
        else:
            opd = tma_depth(opd)
            cols = tri_cols(n, sms)
            partial = torch.empty(3 * -(-n // cols) * n, dtype=torch.float32,
                                  device=opd.device)
            fn = bind("lifted", "lifted_fwd_tri_tf32", _TF32_ARGTYPES)
            rc = fn(opd.data_ptr(), n, opd.shape[1], cols, *side,
                    partial.data_ptr(), fp.data_ptr(), cn.data_ptr(),
                    nc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lifted_fwd_tri launch failed: CUDA error {rc}")
    LAUNCHES["lifted_fwd_tri"] += 1
    return fp, cn, nc


def lifted_fwd_tri(ops: Operands, margin: float):
    """K6 for CUDA operands, its plain version for CPU ones."""
    if on_cpu(ops, "triangular lifted forward"):
        return lifted_fwd_tri_plain(ops, margin)
    return lifted_fwd_tri_kernel(ops, margin)
