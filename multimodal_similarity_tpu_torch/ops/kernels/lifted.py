"""Fused lifted-structured statistics: per-row logsumexps over distance
tiles, with a recompute backward.

Port of the JAX package's ``ops/pallas/lifted.py``.  Per anchor row i
(reference semantics, the dense oracle ``ops.losses.lifted_loss``):

  fp_i = logsumexp_j(dist_ij * pos_mask_ij)   non-positives contribute
                                               exp(0), the self pair too
  cn_i = logsumexp_{j: negative}(margin - dist_ij)
  nc_i = the count of valid negatives

without ever materialising the N x N matrix in device memory.

Kernels (CUDA C++, ``csrc/lifted.cu``):

* ``lifted_fwd`` (K4) replaces ``_fwd_kernel`` (via ``_lifted_fwd_pallas``):
  the general row forward, online logsumexp (running max and sum of exp).
  An f32 operand runs its products on the tensor cores through 3xTF32
  (``lifted_fwd_tc`` on ``csrc/wgmma_tf32.cuh``): :func:`tf32_split` cuts
  the operand, padded to a depth that is a multiple of 4 for TMA
  (:func:`pad_depth`, zero columns change no product), into hi = x
  rounded to TF32 and lo = x - hi, two extra [N, d] f32 buffers made per
  call (fresh allocations, so 16-byte aligned as TMA needs); each product
  is hi lo + lo hi + hi hi summed in f32, within about 2^-21 of
  |e_i| |e_j| of the exact one, which keeps the 1e-4 f32 parity (plain
  TF32, about 2^-11, would not).  A CTA of 64 rows runs in three roles
  (TMA producer, MMA warpgroup, two epilogue warpgroups on the product
  tiles in shared memory).  The columns are cut into the ranges
  :func:`fwd_split` picks, each CTA writes its rows' (max, sum) pairs and
  negative count per range to a [S, 5, N] partials buffer allocated here,
  and a second launch merges the ranges in ascending order: no atomics,
  bit-identical from run to run.
  Its bound on an H100: 2 N^2 d products at three TF32 products each
  (495 TFLOP/s), 14 f32 operations and 2 exponentials a pair (0.134 ms at
  N = 8192, d = 128).  A bf16 operand keeps the first port's FMA row walk
  (``lifted_fwd_kernel``);
* ``lifted_bwd`` (K5) replaces ``_bwd_kernel``: the recompute VJP.  The TPU
  ran it twice, a straight and a transposed pass; here one tile walk forms
  both.  An f32 operand runs both products (the distance tile, then C E) on
  the tensor cores through 3xTF32 (``lifted_bwd_tc``): the same split of
  the operand as K4, C split in the kernel, and E^T split by
  :func:`tf32_split_t` (TF32 ``wgmma`` has no transposed form, so C E reads
  E^T's rows), zero-padded to whole 128-row chunks and 64-column tiles.  A
  CTA owns 64 rows, a range of column tiles and a chunk of 128 gradient
  columns (:func:`bwd_grid` picks ranges and chunks); each chunk recomputes
  the distance tile over the whole depth.  With several ranges their
  partial G and row sums go through [S, N, d] and [S, N] buffers allocated
  here to a second launch that adds them in ascending order; with one, the
  tile walk writes the gradient.  Its bound on an H100: 4 N^2 d products
  at the 3xTF32 rate, 18 f32 operations and up to 2 exponentials a pair
  (0.258 ms at N = 8192, d = 128).  A bf16 operand keeps the first port's
  FMA row walk (``lifted_bwd_kernel``, any d: chunks of 1024 columns);
* ``lifted_fwd_tri`` (K6, ``ops/kernels/lifted_tri.py``) replaces the
  bounded triangular forward, taken with ``bounded=True``.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain PyTorch version of the same function
(:func:`lifted_fwd_plain`, :func:`lifted_bwd_plain`).  ``LAUNCHES`` counts
kernel launches only: one per wrapper call, K4's two launches included.

Semantics kept from the TPU kernels, including their sentinels: an invalid
column enters v_pos at -1e30 and v_neg at margin - (|e|^2 + 1e30), so a row
with no valid negative gets cn = -1e30 + log(count) = -1e30 from K4 (and
log(1e-30) from K6, whose sums have no max).  Labels stay int64 beside a
valid flag (no float cast, no remap).

Deviation from the TPU kernels, and its tolerance.  With
``precision="bf16"`` the operands are rounded to bf16 once (exact f32 row
norms are kept) and products are summed in f32, as on the TPU; but the
epilogue (distance, masks, exp, the coefficient matrix C) runs in f32 and C
is not rounded to bf16 before its product with E, where the TPU kernels ran
the distance epilogue in bf16 and fed C to the MXU in bf16.  The port's bf16
stats therefore differ from the JAX package's by up to bf16 rounding of the
distances; the tests hold bf16 to f32 within 5e-2.  With ``precision="f32"``
(the default, and the trainer's) both are f32 throughout and agree to f32
summation-order error (1e-4 in the tests); ``chip_smoke.py`` holds K4's
and K5's 3xTF32 products on the card to their plain versions at that
tolerance (K5's scaled by its largest gradient entry and by d / 128).

The gradient, with C_ij = g_fp_i softmax^pos_ij pos_ij
- g_cn_i softmax^neg_ij neg_ij:  grad_i = 2 sum_j (C_ij + C_ji) (e_i - e_j).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    POS_INF, Operands, check_operands, on_cpu, pad_depth, prep_operands,
    sm_count)
from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
    lifted_fwd_tri)

NEG_INF = -1e30

LAUNCHES.update(lifted_fwd=0, lifted_bwd=0)
_FWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                 + [ctypes.c_void_p] * 4)
_TF32_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 5)
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                 + [ctypes.c_void_p] * 8 + [ctypes.c_float]
                 + [ctypes.c_void_p] * 2)
_BWD_TF32_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 8 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 4)
# f32 K5's geometry: 64-column tiles, 128 gradient columns a CTA
BWD_TILE, BWD_CHUNK = 64, 128
# the bits an f32 keeps in TF32: sign, exponent and the top 10 mantissa
# bits (0xFFFFE000 as an int32); half the step of the last one
_TF32_MASK = -(1 << 13)
_TF32_HALF = 1 << 12


def _dist(ops: Operands) -> torch.Tensor:
    """[N, N] squared distances of the operand, penalised on invalid
    columns: the kernels' f32 epilogue."""
    opd = ops.opd.float()
    inner = opd @ opd.T
    return torch.clamp((ops.sq[:, None] + ops.sq_pen[None, :]) - 2.0 * inner,
                       min=0.0)


def _masks(ops: Operands):
    """(same, pos): the label-equal valid columns, and those off the
    diagonal."""
    n = ops.sq.shape[0]
    same = (ops.labels[:, None] == ops.labels[None, :]) \
        & (ops.valid > 0.0)[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=same.device)
    return same, same & ~eye


def _lse(v: torch.Tensor) -> torch.Tensor:
    """Row logsumexp as the kernels finish it: max + log(max(sum, 1e-30))."""
    m = v.max(dim=1).values
    s = torch.exp(v - m[:, None]).sum(dim=1)
    return m + torch.log(torch.clamp(s, min=1e-30))


def lifted_fwd_plain(ops: Operands, margin: float):
    """Plain PyTorch version of K4: dense [N, N], the same values,
    sentinels and f32 epilogue.  Returns (fp, cn, nc)."""
    dist = _dist(ops)
    same, pos = _masks(ops)
    v_pos = torch.where(pos, dist, torch.zeros_like(dist)) \
        - (1.0 - ops.valid)[None, :] * POS_INF
    v_neg = torch.where(same, torch.full_like(dist, NEG_INF), margin - dist)
    nc = torch.where(same, torch.zeros_like(dist), ops.valid[None, :]).sum(1)
    return _lse(v_pos), _lse(v_neg), nc


def lifted_coefficients(ops: Operands, fp, cn, g_fp, g_cn,
                        margin: float) -> torch.Tensor:
    """C [N, N]: C_ij = g_fp_i exp(v_pos_ij - fp_i) pos_ij
    - g_cn_i exp(v_neg_ij - cn_i) neg_ij, zero outside the masks."""
    dist = _dist(ops)
    same, pos = _masks(ops)
    v_pos = dist - (1.0 - ops.valid)[None, :] * POS_INF
    soft_pos = torch.where(pos, torch.exp(v_pos - fp[:, None]),
                           torch.zeros_like(dist))
    soft_neg = torch.where(
        same, torch.zeros_like(dist),
        torch.exp((margin - dist) - cn[:, None]) * ops.valid[None, :])
    return g_fp[:, None] * soft_pos - g_cn[:, None] * soft_neg


def lifted_bwd_plain(ops: Operands, fp, cn, g_fp, g_cn,
                     margin: float) -> torch.Tensor:
    """Plain PyTorch version of K5: the straight plus the transposed pass,
    grad = 2 (rowsum(C + C^T) e - (C + C^T) @ E), [N, d] f32."""
    c = lifted_coefficients(ops, fp, cn, g_fp, g_cn, margin)
    c = c + c.T
    e = ops.opd.float()
    return 2.0 * (c.sum(dim=1)[:, None] * e - c @ e)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of an f32 tensor: hi = x rounded to the nearest TF32 value
    (half a TF32 step added to the magnitude, then the low 13 mantissa bits
    cleared) and lo = x - hi, exact in f32; so hi + lo == x bit for bit and
    |lo| <= 2^-11 |x|."""
    hi = ((x.view(torch.int32) + _TF32_HALF) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def tf32_split_t(x: torch.Tensor, rows: int, cols: int):
    """(hi^T, lo^T) [rows, cols] of an f32 [N, d] tensor: the TF32 split of
    x^T zero-padded past d rows and N columns, so hi^T + lo^T equals x^T bit
    for bit and every padded entry is 0 (TF32 products read it as such)."""
    xt = x.new_zeros(rows, cols)
    xt[:x.shape[1], :x.shape[0]] = x.T
    return tf32_split(xt)


def bwd_grid(n: int, d: int, sms: int):
    """(column ranges, depth chunks) of the f32 K5 for N rows of depth d on
    a card with ``sms`` SMs (one CTA an SM): a CTA per 64-row block, range
    and 128-column chunk; the ranges bring the CTAs close to the SM count
    without passing it (1 where the row blocks and chunks alone fill the
    card), reduced so that no range is empty."""
    tiles = -(-n // BWD_TILE)
    chunks = -(-d // BWD_CHUNK)
    split = max(1, min(tiles, sms // (tiles * chunks)))
    per = -(-tiles // split)
    return -(-tiles // per), chunks


def fwd_split(n: int, sms: int) -> int:
    """Column ranges of the f32 K4 for N rows on a card with ``sms`` SMs
    (one CTA an SM): its 64-row blocks times the ranges come close to the
    SM count without passing it; 1 where the row blocks alone fill the
    card; reduced so that no range is empty."""
    tiles = -(-n // 64)
    split = max(1, min(tiles, sms // tiles))
    per = -(-tiles // split)
    return -(-tiles // per)


def lifted_fwd_kernel(ops: Operands, margin: float):
    """Launch K4 on the operands' CUDA device, on the current stream: the
    3xTF32 tile walk and its combine for an f32 operand, the FMA row walk
    for a bf16 one.  Same returns as :func:`lifted_fwd_plain`."""
    opd = ops.opd
    n, d = check_operands(ops, "lifted_fwd_kernel")
    fp, cn, nc = (torch.empty(n, dtype=torch.float32, device=opd.device)
                  for _ in range(3))
    with torch.cuda.device(opd.device):
        stream = torch.cuda.current_stream().cuda_stream
        side = (ops.sq.data_ptr(), ops.sq_pen.data_ptr(),
                ops.labels.data_ptr(), ops.valid.data_ptr(), float(margin))
        if opd.dtype == torch.bfloat16:
            fn = bind("lifted", "lifted_fwd", _FWD_ARGTYPES)
            rc = fn(opd.data_ptr(), n, d, *side, fp.data_ptr(),
                    cn.data_ptr(), nc.data_ptr(), stream)
        else:
            hi, lo = tf32_split(pad_depth(opd, 4))
            split = fwd_split(n, sm_count(opd.device))
            partial = torch.empty(split * 5 * n, dtype=torch.float32,
                                  device=opd.device)
            fn = bind("lifted", "lifted_fwd_tf32", _TF32_ARGTYPES)
            rc = fn(hi.data_ptr(), lo.data_ptr(), n, hi.shape[1], split,
                    *side, partial.data_ptr(), fp.data_ptr(),
                    cn.data_ptr(), nc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lifted_fwd launch failed: CUDA error {rc}")
    LAUNCHES["lifted_fwd"] += 1
    return fp, cn, nc


def _row_stats(n: int, device, *stats):
    out = []
    for t in stats:
        t = t.reshape(-1).float().contiguous()
        if t.shape != (n,) or t.device != device:
            raise ValueError(f"row stats must be [{n}] on {device}")
        out.append(t)
    return out


def lifted_bwd_kernel(ops: Operands, fp, cn, g_fp, g_cn,
                      margin: float) -> torch.Tensor:
    """Launch K5 on the operands' CUDA device, on the current stream: the
    3xTF32 tile walk (and, with several column ranges, its combine) for an
    f32 operand, the FMA row walk for a bf16 one.  Same return as
    :func:`lifted_bwd_plain`."""
    opd = ops.opd
    n, d = check_operands(ops, "lifted_bwd_kernel")
    fp, cn, g_fp, g_cn = _row_stats(n, opd.device, fp, cn, g_fp, g_cn)
    grad = torch.empty(n, d, dtype=torch.float32, device=opd.device)
    side = (ops.sq.data_ptr(), ops.sq_pen.data_ptr(), ops.labels.data_ptr(),
            ops.valid.data_ptr(), fp.data_ptr(), cn.data_ptr(),
            g_fp.data_ptr(), g_cn.data_ptr(), float(margin))
    with torch.cuda.device(opd.device):
        stream = torch.cuda.current_stream().cuda_stream
        if opd.dtype == torch.bfloat16:
            fn = bind("lifted", "lifted_bwd", _BWD_ARGTYPES)
            rc = fn(opd.data_ptr(), n, d, *side, grad.data_ptr(), stream)
        else:
            hi, lo = tf32_split(pad_depth(opd, 4))
            ranges, chunks = bwd_grid(n, d, sm_count(opd.device))
            hi_t, lo_t = tf32_split_t(opd, chunks * BWD_CHUNK,
                                      -(-n // BWD_TILE) * BWD_TILE)
            # the ranges' partial sums, read only with more than one range
            partial = torch.empty(ranges * n * d if ranges > 1 else 0,
                                  dtype=torch.float32, device=opd.device)
            rowsum = torch.empty(ranges * n, dtype=torch.float32,
                                 device=opd.device)
            fn = bind("lifted", "lifted_bwd_tf32", _BWD_TF32_ARGTYPES)
            rc = fn(hi.data_ptr(), lo.data_ptr(), hi_t.data_ptr(),
                    lo_t.data_ptr(), opd.data_ptr(), n, d, hi.shape[1],
                    ranges, *side, partial.data_ptr(), rowsum.data_ptr(),
                    grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lifted_bwd launch failed: CUDA error {rc}")
    LAUNCHES["lifted_bwd"] += 1
    return grad


def lifted_fwd(ops: Operands, margin: float):
    """K4 for CUDA operands, its plain version for CPU ones."""
    if on_cpu(ops, "lifted forward"):
        return lifted_fwd_plain(ops, margin)
    return lifted_fwd_kernel(ops, margin)


def lifted_bwd(ops: Operands, fp, cn, g_fp, g_cn, margin: float):
    """K5 for CUDA operands, its plain version for CPU ones."""
    if on_cpu(ops, "lifted backward"):
        return lifted_bwd_plain(ops, fp, cn, g_fp, g_cn, margin)
    return lifted_bwd_kernel(ops, fp, cn, g_fp, g_cn, margin)


class _FusedLifted(torch.autograd.Function):
    """(fp, cn, nc) with the recompute gradient.  The forward launches K6
    when ``bounded`` and K4 otherwise; the backward launches K5 after
    either (it reads only the saved fp and cn)."""

    @staticmethod
    def forward(ctx, emb, labels, valid_f, margin, precision, bounded):
        ops = prep_operands(emb, labels, valid_f, precision)
        fp, cn, nc = (lifted_fwd_tri if bounded else lifted_fwd)(ops, margin)
        if ctx.needs_input_grad[0]:
            ctx.margin = margin
            ctx.emb_dtype = emb.dtype
            ctx.save_for_backward(*ops, fp, cn)
        ctx.mark_non_differentiable(nc)
        return fp, cn, nc

    @staticmethod
    def backward(ctx, g_fp, g_cn, g_nc):
        *ops, fp, cn = ctx.saved_tensors
        grad = lifted_bwd(Operands(*ops), fp, cn, g_fp, g_cn, ctx.margin)
        return grad.to(ctx.emb_dtype), None, None, None, None, None


def _valid_f(emb: torch.Tensor, valid: Optional[torch.Tensor]):
    n = emb.shape[0]
    return (torch.ones(n, dtype=torch.float32, device=emb.device)
            if valid is None else valid.reshape(-1).float())


def fused_lifted_stats(emb: torch.Tensor, labels: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       margin: float = 1.0, precision: str = "f32",
                       bounded: bool = False):
    """-> (furthest_positive_lse [N], closest_negative_lse [N],
    neg_count [N]) with the reference lifted-loss semantics.
    Differentiable with respect to ``emb``.

    ``bounded=True`` promises l2-normalised embeddings (squared distances
    <= 4, so plain sums of exp cannot overflow) and takes the triangular
    forward K6; otherwise the row forward K4.  precision: "f32" (default)
    or "bf16"."""
    return _FusedLifted.apply(emb, labels.reshape(-1), _valid_f(emb, valid),
                              margin, precision, bounded)


def lifted_loss_fused(emb: torch.Tensor, pids: torch.Tensor, margin: float,
                      weighted: bool = True,
                      valid: Optional[torch.Tensor] = None,
                      precision: str = "f32", bounded: bool = False):
    """Lifted-structured loss through the fused stats.

    Same return tuple as ``ops.losses.lifted_loss``: (loss, num_active = 1,
    diff, weights, furthest_positive, closest_negative).  ``bounded=True``
    when ``emb`` is l2-normalised (the triangular forward)."""
    pids = pids.reshape(-1)
    valid_f = _valid_f(emb, valid)
    fp, cn, neg_count = _FusedLifted.apply(emb, pids, valid_f, margin,
                                           precision, bounded)
    diff = torch.clamp(fp + cn, min=0.0)
    foreground = (pids != 0).float() * valid_f
    if weighted:
        weights = neg_count * foreground
        weights = weights / weights.sum()
    else:
        weights = valid_f / valid_f.sum()
    loss = (diff * weights).sum()
    num_active = torch.ones((), dtype=torch.float32, device=emb.device)
    return loss, num_active, diff, weights, fp, cn
