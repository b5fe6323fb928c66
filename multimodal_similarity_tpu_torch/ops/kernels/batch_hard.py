"""Fused pairwise distance + batch-hard reduction.

Port of the JAX package's ``ops/pallas/batch_hard.py``.  Per anchor row it
computes the furthest-positive and closest-negative squared euclidean
distances, the count of valid negatives, and (for the gradient) the column
of each winner, without ever materialising the N x N distance matrix in
device memory.

Kernels (CUDA C++, ``csrc/batch_hard.cu``, one source templated on
``WITH_IDX``):

* ``batch_hard_stats_idx`` (K1) replaces ``_stats_kernel``: the stats plus
  the winner columns, launched by the forward of the differentiable
  wrapper when the embeddings need a gradient;
* ``batch_hard_stats`` (K2) replaces ``_stats_kernel_noidx``: the stats
  alone, launched when no gradient is needed.

Both are bound by their operations on an H100: 2 N^2 d product flops plus
a masked epilogue per pair, against inputs of N d operand values.  A bf16
operand runs its products on the tensor cores (``wgmma``, bf16 x bf16
summed in f32, as the TPU kernel's matrix unit), fed by TMA through a ring
of shared-memory stages (``csrc/wgmma_tile.cuh``); 64-row blocks walk
128-column tiles with the epilogue on the accumulator fragments.  An f32
operand keeps the f32 FMA design of the first port (TF32 would break the
1e-4 parity with the JAX package).

TMA takes a bf16 operand whose rows are a multiple of 16 bytes and whose
base is 16-byte aligned.  So :func:`tma_operand`, called by the kernel
wrappers, pads a depth that is not a multiple of 8 with zero columns
(:func:`pad_depth`, which changes no inner product) and copies a base that
is not 16-byte aligned; operands that already qualify (every one that
:func:`prep_operands` makes at a depth that is a multiple of 8) pass
through without a copy.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes :func:`stats_plain`, the dense PyTorch version
of the same function.  ``LAUNCHES`` counts kernel launches only.

The mining entry points (:func:`fused_batch_hard_stats`,
:func:`batch_hard_fused`) take ``algo``: "row" launches K1/K2, "tri" the
triangular kernel K3 (``ops/kernels/batch_hard_tri.py``, the same function
from half the products), and "auto" follows :func:`use_triangular`, a gate
measured on an H100 (``PERF.md``), not the TPU's.  On a CPU tensor every
``algo`` takes :func:`stats_plain`.

Deviation from the TPU kernel, and its tolerance.  With ``precision="bf16"``
the operands are rounded to bf16 once (exact f32 row norms are kept) and the
products are summed in f32, as on the TPU; but the distance epilogue
(norms + inner product, clamp, masks) runs in f32, where the TPU kernel ran
it in bf16 to pack its vector registers.  The port's bf16 stats therefore
differ from the JAX package's by up to bf16 rounding of the distances
(about 2**-8 relative); with ``precision="f32"`` both are f32 throughout
and agree to f32 summation-order error (1e-4 in the tests).  The gradient
keeps the JAX gate ``cn < 0.5e30`` all the same.

The gradient flows through each row's winning pair only (the gradient of
the masked max/min over the dense matrix): d|a-b|^2/da = 2(a-b) into the
anchor and -2(a-b) scattered into the winner (:func:`winning_pair_grad`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind

POS_INF = 1e30

LAUNCHES.update(batch_hard_stats_idx=0, batch_hard_stats=0)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p])


class Operands(NamedTuple):
    """The prepared inputs of one stats call (kernel and plain version).

    opd [N, d] bf16 or f32 operand; sq [N] exact f32 row norms; sq_pen [N]
    column norms with +1e30 on invalid columns; labels [N] int64; valid [N]
    f32 (> 0 marks a valid column; summed into the negative count)."""
    opd: torch.Tensor
    sq: torch.Tensor
    sq_pen: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


def _label_ids(labels: torch.Tensor) -> torch.Tensor:
    """Integer labels as int64 as they are; float labels are ranked to
    dense ids, which keeps every equality exactly."""
    lab = labels.reshape(-1)
    if lab.is_floating_point():
        return torch.unique(lab, return_inverse=True)[1]
    return lab.to(torch.int64)


def prep_operands(emb: torch.Tensor, labels: torch.Tensor,
                  valid_f: torch.Tensor, precision: str) -> Operands:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got "
                         f"{precision!r}")
    emb32 = emb.float()
    sq = (emb32 * emb32).sum(dim=1)
    sq_pen = torch.where(valid_f <= 0.0, torch.full_like(sq, POS_INF), sq)
    opd = emb32.to(torch.bfloat16) if precision == "bf16" else emb32
    return Operands(opd.contiguous(), sq.contiguous(), sq_pen.contiguous(),
                    _label_ids(labels).contiguous(), valid_f.contiguous())


def stats_plain(ops: Operands, with_idx: bool):
    """Plain PyTorch version of the kernels: dense [N, N], same masks, same
    f32 epilogue.  Returns (fp, cn, nc) or (fp, cn, nc, fpi, cni); the
    winner is the lowest column that reaches the max/min, stated here
    rather than left to ``argmax``."""
    n = ops.sq.shape[0]
    inner = ops.opd.float() @ ops.opd.float().T
    dist = torch.clamp((ops.sq[:, None] + ops.sq_pen[None, :]) - 2.0 * inner,
                       min=0.0)
    same = (ops.labels[:, None] == ops.labels[None, :]) \
        & (ops.valid > 0.0)[None, :]
    cols = torch.arange(n, device=dist.device)
    not_self = cols[:, None] != cols[None, :]
    pos = torch.where(same & not_self, dist, torch.zeros_like(dist))
    neg = torch.where(same, torch.full_like(dist, POS_INF), dist)
    fp = pos.max(dim=1).values
    cn = neg.min(dim=1).values
    nc = torch.where(same, torch.zeros_like(dist), ops.valid[None, :]).sum(1)
    if not with_idx:
        return fp, cn, nc
    big = torch.full_like(pos, n, dtype=torch.int64)
    fpi = torch.where(pos == fp[:, None], cols[None, :], big).min(dim=1)
    cni = torch.where(neg == cn[:, None], cols[None, :], big).min(dim=1)
    return (fp, cn, nc, fpi.values.to(torch.int32),
            cni.values.to(torch.int32))


def check_operands(ops: Operands, who: str):
    """Raise unless ``ops`` is what the CUDA kernels take: contiguous CUDA
    tensors on one device, an [N, d] f32 or bf16 operand and [N] side
    vectors.  Returns (N, d)."""
    opd = ops.opd
    if not opd.is_cuda:
        raise ValueError(f"{who} needs CUDA tensors")
    if opd.dim() != 2 or opd.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand must be [N, d] f32 or bf16, got "
                         f"{tuple(opd.shape)} {opd.dtype}")
    n, d = opd.shape
    for name, t, dtype in (("sq", ops.sq, torch.float32),
                           ("sq_pen", ops.sq_pen, torch.float32),
                           ("labels", ops.labels, torch.int64),
                           ("valid", ops.valid, torch.float32)):
        if t.shape != (n,) or t.dtype != dtype or t.device != opd.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} "
                             f"tensor on {opd.device}")
    if not opd.is_contiguous():
        raise ValueError("operand must be contiguous")
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"shape {tuple(opd.shape)} exceeds int32")
    return n, d


def pad_depth(opd: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """``opd`` [N, d] with zero columns appended up to the next multiple of
    ``multiple`` (itself when d already is one).  Zero columns add nothing
    to any inner product, so every statistic is unchanged."""
    extra = -opd.shape[1] % multiple
    return F.pad(opd, (0, extra)) if extra else opd


def tma_operand(opd: torch.Tensor) -> torch.Tensor:
    """The operand as the kernels take it: a bf16 operand padded to a depth
    that is a multiple of 8 and copied when its base is not 16-byte
    aligned (TMA's rules); an f32 operand as it is."""
    if opd.dtype != torch.bfloat16:
        return opd
    opd = pad_depth(opd)
    if opd.data_ptr() % 16:
        opd = opd.clone()
    return opd


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device index."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def on_cpu(ops: Operands, what: str) -> bool:
    """True for CPU operands (the plain version), False for CUDA ones (the
    kernel); raises for any other device: no fallback."""
    if ops.opd.is_cuda:
        return False
    if ops.opd.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {ops.opd.device}")
    return True


def stats_kernel(ops: Operands, with_idx: bool):
    """Launch K1 (``with_idx``) or K2 on the operands' CUDA device, on the
    current stream.  Same returns as :func:`stats_plain`."""
    n, _ = check_operands(ops, "stats_kernel")
    opd = tma_operand(ops.opd)
    d = opd.shape[1]
    fn = bind("batch_hard", "batch_hard_stats", _ARGTYPES)
    fp, cn, nc = (torch.empty(n, dtype=torch.float32, device=opd.device)
                  for _ in range(3))
    if with_idx:
        fpi, cni = (torch.empty(n, dtype=torch.int32, device=opd.device)
                    for _ in range(2))
    with torch.cuda.device(opd.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(opd.data_ptr(), int(opd.dtype == torch.bfloat16), n, d,
                ops.sq.data_ptr(), ops.sq_pen.data_ptr(),
                ops.labels.data_ptr(), ops.valid.data_ptr(),
                fp.data_ptr(), cn.data_ptr(), nc.data_ptr(),
                fpi.data_ptr() if with_idx else None,
                cni.data_ptr() if with_idx else None,
                int(with_idx), stream)
    if rc != 0:
        raise RuntimeError(f"batch_hard_stats launch failed: CUDA error {rc}")
    LAUNCHES["batch_hard_stats_idx" if with_idx else "batch_hard_stats"] += 1
    return (fp, cn, nc, fpi, cni) if with_idx else (fp, cn, nc)


def use_triangular(n: int, d: int, sms: int) -> bool:
    """The "auto" gate between K3 (True) and K1/K2 for N rows of width d on
    a card with ``sms`` SMs.

    Measured on an H100 (132 SMs) by ``chip_smoke.py``'s timing grid, N
    from 16 to 16384 by d of 128, 512 and 1024 in bf16, winner-tracking
    kernels (``PERF.md``).  Since both run on the tensor cores:

    * N <= 128: K1, one launch against K3's two (tile walk and combine),
      which the products saved cannot pay for (K1 1.1x-1.6x faster);
    * d >= 512: K3 from N = 256 up: the products weigh, and K3 needs half
      of them (1.1x-2.9x);
    * d < 512: the masked epilogue, which K3 runs for both sides of every
      pair, weighs more than the products; K3 wins while K1's 64-row
      blocks leave SMs idle (N = 512 to 4096: 1.2x-1.5x) and loses once
      they fill three quarters of the SMs (N = 8192, 16384: K1 1.15x,
      1.26x faster), and at N = 256 (K1 1.15x).

    The rule below reproduces the faster kernel in every measured cell.
    The TPU's gate (d >= 512 and four VMEM blocks,
    ``ops/pallas/batch_hard.py:306-322``) does not apply here."""
    if n <= 128:
        return False
    if d >= 512:
        return True
    if n <= 256:
        return False
    return 4 * -(-n // 64) < 3 * sms


def batch_hard_stats(ops: Operands, with_idx: bool, algo: str = "auto"):
    """The kernel that ``algo`` names for CUDA operands, the plain version
    for CPU ones."""
    if algo not in ("auto", "row", "tri"):
        raise ValueError(f"unknown algo {algo!r}")
    if on_cpu(ops, "batch-hard"):
        return stats_plain(ops, with_idx)
    if algo == "auto":
        n, d = ops.opd.shape
        algo = "tri" if use_triangular(n, d, sm_count(ops.opd.device)) \
            else "row"
    if algo == "tri":
        # imported here: batch_hard_tri builds on this module
        from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri \
            import tri_stats_kernel
        return tri_stats_kernel(ops, with_idx)
    return stats_kernel(ops, with_idx)


def winning_pair_grad(emb, fp, cn, fpi, cni, g_fp, g_cn):
    """Gradient of per-row (furthest-positive, closest-negative) stats with
    respect to the embeddings, routed through each row's winning pair."""
    coef_fp = g_fp * (fp > 0.0)
    t = 2.0 * coef_fp[:, None] * (emb - emb[fpi])
    grad = t.clone()
    grad.index_add_(0, fpi, -t)
    # 0.5x threshold: the 1e30 no-negative sentinel must never route
    # gradient into an arbitrary "winner"
    coef_cn = g_cn * (cn < 0.5 * POS_INF)
    u = 2.0 * coef_cn[:, None] * (emb - emb[cni])
    grad = grad + u
    grad.index_add_(0, cni, -u)
    return grad


class _FusedStats(torch.autograd.Function):
    """(fp, cn, nc) with the winner-pair gradient.  The forward launches the
    winner-tracking kernel (K1, or K3 idx) when ``emb`` needs a gradient and
    the stats-only one (K2, or K3) when it does not."""

    @staticmethod
    def forward(ctx, emb, labels, valid_f, precision, algo):
        with_idx = ctx.needs_input_grad[0]
        ops = prep_operands(emb, labels, valid_f, precision)
        out = batch_hard_stats(ops, with_idx, algo)
        fp, cn, nc = out[:3]
        if with_idx:
            ctx.emb_dtype = emb.dtype
            ctx.save_for_backward(emb.float(), fp, cn, out[3], out[4])
        ctx.mark_non_differentiable(nc)
        return fp, cn, nc

    @staticmethod
    def backward(ctx, g_fp, g_cn, g_nc):
        emb, fp, cn, fpi, cni = ctx.saved_tensors
        grad = winning_pair_grad(emb, fp, cn, fpi.long(), cni.long(),
                                 g_fp, g_cn)
        return grad.to(ctx.emb_dtype), None, None, None, None


def fused_batch_hard_stats(emb: torch.Tensor, labels: torch.Tensor,
                           valid: Optional[torch.Tensor] = None,
                           precision: str = "bf16", algo: str = "auto"):
    """-> (furthest_positive [N], closest_negative [N], neg_count [N]).

    Squared euclidean distances; ``valid`` masks padding rows out of the
    positive and negative candidate sets.  Differentiable with respect to
    ``emb`` through each row's winning pair.  precision: "bf16" (default)
    or "f32".  algo: "row" (K1/K2), "tri" (K3) or "auto"
    (:func:`use_triangular`); the same stats, bit for bit, from each.
    Counterpart of the JAX ``fused_batch_hard_stats``.
    """
    n = emb.shape[0]
    valid_f = (torch.ones(n, dtype=torch.float32, device=emb.device)
               if valid is None else valid.reshape(-1).float())
    return _FusedStats.apply(emb, labels, valid_f, precision, algo)


def batch_hard_fused(emb: torch.Tensor, pids: torch.Tensor, margin="soft",
                     weighted: bool = True,
                     valid: Optional[torch.Tensor] = None,
                     precision: str = "bf16", algo: str = "auto"):
    """Batch-hard loss from embeddings through the fused stats (the JAX
    ``batch_hard_pallas``; ``algo`` as in :func:`fused_batch_hard_stats`).

    Same return tuple as ``ops.losses.batch_hard``: (loss, num_active, diff,
    weights, furthest_positive, closest_negative)."""
    pids = pids.reshape(-1)
    n = emb.shape[0]
    valid_f = (torch.ones(n, dtype=torch.float32, device=emb.device)
               if valid is None else valid.reshape(-1).float())
    fp, cn, neg_count = fused_batch_hard_stats(emb, pids, valid, precision,
                                               algo)
    diff = fp - cn
    if margin == "soft":
        diff = F.softplus(diff)
    else:
        diff = torch.clamp(diff + margin, min=0.0)

    foreground = (pids != 0).float() * valid_f
    foreground_num = foreground.sum()
    if weighted:
        weights = neg_count * foreground
        weights = weights / weights.sum()
    else:
        weights = valid_f / valid_f.sum()

    loss = (diff * weights).sum()
    num_active = ((diff * foreground) > 1e-5).float().sum() / foreground_num
    return loss, num_active, diff, weights, fp, cn
