"""Triangular fused distance + batch-hard reduction.

Port of the JAX package's ``ops/pallas/batch_hard_tri.py``.  The pairwise
distances are symmetric, so only the T(T+1)/2 upper-triangle tile pairs are
visited and each off-diagonal tile is reduced both ways: along rows (anchors
of tile ti over the candidates of tile tj) and along columns (anchors of tj
over the candidates of ti).  That halves the products of the row walk (K1/K2,
``ops/kernels/batch_hard.py``) for the same statistics.

Kernel (CUDA C++, ``csrc/batch_hard.cu``, templated on ``WITH_IDX``):

* ``batch_hard_tri_idx`` (K3) replaces ``_tri_kernel_idx``: the stats plus
  the winner columns, launched by the differentiable wrapper's forward when
  the embeddings need a gradient;
* ``batch_hard_tri`` (K3) replaces ``_tri_kernel_noidx``: the stats alone.

Bound on an H100: N(N+1) d product flops and both sides' masked epilogue
for every ordered pair, against N d operand values: operations bound it.
A bf16 operand runs its products on the tensor cores (``wgmma`` fed by TMA,
``csrc/wgmma_tile.cuh``) in persistent CTAs whose warpgroups overlap one
tile pair's products with the last pair's two epilogues; an f32 operand
keeps the f32 FMA tile walk (``csrc/tile.cuh``).  The tile edge is
:func:`tri_tile`'s: 128 or 64 in bf16, 64 or 32 in f32.  The bf16 operand
is prepared for TMA by :func:`batch_hard.tma_operand`.

On the TPU the grid ran in order and each step updated accumulators resident
in VMEM.  On the GPU the tile pairs run in no order, so each writes its row
side's (value, index) pairs to ``partial[ti][tj]`` and its column side's to
``partial[tj][ti]``, and a second launch merges each row block's T partials
in ascending order with K1's lowest-column tie rule.  The partials buffers
are allocated per call: [3, T, T, B] f32 and, with winners, [2, T, T, B]
int32, about 5 N^2 / B * 4 bytes (42 MB at N = 16384, B = 128).  Both
launches count as one call in ``LAUNCHES``.  No float atomics: the results
are bit-equal to K1/K2 on the same operands (``csrc/batch_hard.cu`` says
why), and K3 computes the same function.  Its plain version is therefore
:func:`batch_hard.stats_plain` itself, which a CPU tensor takes through
:func:`batch_hard.batch_hard_stats` with ``algo="tri"``.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    Operands, check_operands, sm_count, tma_operand)
from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import tri_block

LAUNCHES.update(batch_hard_tri_idx=0, batch_hard_tri=0)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
             + [ctypes.c_int, ctypes.c_void_p])


def tri_tile(n: int, sms: int, bf16: bool) -> int:
    """K3's tile edge for N rows on a card with ``sms`` SMs.  bf16 (the
    tensor cores): 128 (two consumer warpgroups) once the T(T+1)/2 tile
    pairs of 128 fill every SM, else 64 (one warpgroup; ``wgmma`` has no
    32-row tile).  f32 (FMA): K6's ``tri_block``, 64 once its pairs fill
    the SMs, else 32."""
    if not bf16:
        return tri_block(n, sms)
    t128 = -(-n // 128)
    return 128 if t128 * (t128 + 1) // 2 >= sms else 64


def tri_stats_kernel(ops: Operands, with_idx: bool):
    """Launch K3 (the tile walk and its ascending-order combine) on the
    operands' CUDA device, on the current stream.  Same returns as
    :func:`batch_hard.stats_plain`."""
    n, _ = check_operands(ops, "tri_stats_kernel")
    opd = tma_operand(ops.opd)
    d = opd.shape[1]
    block = tri_tile(n, sm_count(opd.device), opd.dtype == torch.bfloat16)
    n_tiles = -(-n // block)
    size = n_tiles * n_tiles * block
    partial = torch.empty(3 * size, dtype=torch.float32, device=opd.device)
    partial_idx = (torch.empty(2 * size, dtype=torch.int32, device=opd.device)
                   if with_idx else None)
    fp, cn, nc = (torch.empty(n, dtype=torch.float32, device=opd.device)
                  for _ in range(3))
    if with_idx:
        fpi, cni = (torch.empty(n, dtype=torch.int32, device=opd.device)
                    for _ in range(2))
    fn = bind("batch_hard", "batch_hard_tri", _ARGTYPES)
    with torch.cuda.device(opd.device):
        rc = fn(opd.data_ptr(), int(opd.dtype == torch.bfloat16), n, d,
                block, ops.sq.data_ptr(), ops.sq_pen.data_ptr(),
                ops.labels.data_ptr(), ops.valid.data_ptr(),
                partial.data_ptr(),
                partial_idx.data_ptr() if with_idx else None,
                fp.data_ptr(), cn.data_ptr(), nc.data_ptr(),
                fpi.data_ptr() if with_idx else None,
                cni.data_ptr() if with_idx else None,
                int(with_idx), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"batch_hard_tri launch failed: CUDA error {rc}")
    LAUNCHES["batch_hard_tri_idx" if with_idx else "batch_hard_tri"] += 1
    return (fp, cn, nc, fpi, cni) if with_idx else (fp, cn, nc)
