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
order and each step added into resident accumulators.  On the GPU the tile
pairs run in no order, so each writes its row-side sums to
``partial[ti][tj]`` and its column-side sums to ``partial[tj][ti]`` of a
[3, T, T, B] buffer that this wrapper allocates, and a second small pass
sums each row block's T partials in ascending order.  Both launches are one
K6 call (one count in ``LAUNCHES``); no float atomics, so results are
bit-identical from run to run.  Tiles are 32 x 32 while 64 x 64 tiles would
give fewer tile pairs than the card has SMs (N = 512: 136 pairs of 32 on
132 SMs), else 64 x 64.

A CPU tensor takes :func:`lifted_fwd_tri_plain`, the dense PyTorch version.
Precision as in ``ops/kernels/lifted.py``: f32 epilogue in both modes.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    Operands, check_operands, on_cpu)

LAUNCHES.update(lifted_fwd_tri=0)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
             + [ctypes.c_float] + [ctypes.c_void_p] * 5)


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


def lifted_fwd_tri_kernel(ops: Operands, margin: float):
    """Launch K6 (the tile walk and its ascending-order reduce) on the
    operands' CUDA device, on the current stream.  Same returns as
    :func:`lifted_fwd_tri_plain`."""
    opd = ops.opd
    n, d = check_operands(ops, "lifted_fwd_tri_kernel")
    sms = torch.cuda.get_device_properties(opd.device).multi_processor_count
    block = tri_block(n, sms)
    n_tiles = -(-n // block)
    partial = torch.empty(3 * n_tiles * n_tiles * block, dtype=torch.float32,
                          device=opd.device)
    fp, cn, nc = (torch.empty(n, dtype=torch.float32, device=opd.device)
                  for _ in range(3))
    fn = bind("lifted", "lifted_fwd_tri", _ARGTYPES)
    with torch.cuda.device(opd.device):
        rc = fn(opd.data_ptr(), int(opd.dtype == torch.bfloat16), n, d,
                block, ops.sq.data_ptr(), ops.labels.data_ptr(),
                ops.valid.data_ptr(), float(margin), partial.data_ptr(),
                fp.data_ptr(), cn.data_ptr(), nc.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lifted_fwd_tri launch failed: CUDA error {rc}")
    LAUNCHES["lifted_fwd_tri"] += 1
    return fp, cn, nc


def lifted_fwd_tri(ops: Operands, margin: float):
    """K6 for CUDA operands, its plain version for CPU ones."""
    if on_cpu(ops, "triangular lifted forward"):
        return lifted_fwd_tri_plain(ops, margin)
    return lifted_fwd_tri_kernel(ops, margin)
