"""Tiled pairwise squared euclidean distance, written out.

Port of the JAX package's ``ops/pallas/distance.py`` (``pallas_sqdist``):
[N, d] x [M, d] -> [N, M] f32, max(|a|^2 + |b|^2 - 2 a.b, 0), the operands
cast to f32 first and the row norms taken from the f32 operands.

Kernel (CUDA C++, ``csrc/distance.cu``): ``sqdist`` (K7) replaces
``_sqdist_kernel``: persistent CTAs over 64 x 128 output tiles, the
products on the tensor cores through 3xTF32 (each f32 k-slice split into
hi and lo in shared memory by the kernel, ``csrc/wgmma_split.cuh``), the
row norms summed once a tile from the same slices, and the output stores
left in flight under the next tile's products; ragged N, M and d masked.
The wrapper only pads the depth to a multiple of 4 (zero columns change
no distance) and copies a base that is not 16-byte aligned, as TMA needs.
A CUDA tensor launches it (or raises), a CPU tensor takes
:func:`sqdist_plain`.  The
port's ``ops/distances.py pairwise_distance`` does not use it, as the JAX
``pairwise_distance`` does not use ``pallas_sqdist``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind

LAUNCHES.update(sqdist=0)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _f32_operands(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"sqdist takes [N, d] and [M, d], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return a.float().contiguous(), b.float().contiguous()


def sqdist_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: f32 norms plus one f32 product."""
    a, b = _f32_operands(a, b)
    return torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                       - 2.0 * (a @ b.T), min=0.0)


def tma_depth(x: torch.Tensor) -> torch.Tensor:
    """An [R, d] f32 operand as the TMA-fed f32 kernels (K6, K7) read it:
    zero columns up to a depth that is a positive multiple of 4, and a
    16-byte aligned base (a copy only where one of them is missing)."""
    d = x.shape[1]
    extra = max(4, -(-d // 4) * 4) - d
    if extra:
        x = F.pad(x, (0, extra))
    return x.clone() if x.data_ptr() % 16 else x


def sqdist_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the operands' CUDA device, on the current stream."""
    a, b = _f32_operands(a, b)
    if not a.is_cuda:
        raise ValueError("sqdist_kernel needs CUDA tensors")
    (n, d), m = a.shape, b.shape[0]
    if max(n, m, d + 4) >= 2 ** 31 or -(-n // 64) * -(-m // 128) >= 2 ** 31:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)} exceed "
                         "the kernel's int32 indexing")
    out = torch.empty(n, m, dtype=torch.float32, device=a.device)
    a4, b4 = tma_depth(a), tma_depth(b)
    fn = bind("distance", "sqdist", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a4.data_ptr(), n, b4.data_ptr(), m, a4.shape[1],
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sqdist launch failed: CUDA error {rc}")
    LAUNCHES["sqdist"] += 1
    return out


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, d] x [M, d] -> [N, M] f32 squared euclidean distances: K7 for
    CUDA operands, :func:`sqdist_plain` for CPU ones."""
    if a.is_cuda:
        return sqdist_kernel(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"no sqdist kernel for device {a.device}")
    return sqdist_plain(a, b)
