"""Tiled pairwise squared euclidean distance, written out.

Port of the JAX package's ``ops/pallas/distance.py`` (``pallas_sqdist``):
[N, d] x [M, d] -> [N, M] f32, max(|a|^2 + |b|^2 - 2 a.b, 0), the operands
cast to f32 first and the row norms taken from the f32 operands.

Kernel (CUDA C++, ``csrc/distance.cu``): ``sqdist`` (K7) replaces
``_sqdist_kernel``; one CTA per 64 x 64 output tile, f32 FMA products, the
norms summed inside the kernel, ragged N, M and d masked.  A CUDA tensor
launches it (or raises), a CPU tensor takes :func:`sqdist_plain`.  The
port's ``ops/distances.py pairwise_distance`` does not use it, as the JAX
``pairwise_distance`` does not use ``pallas_sqdist``.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES, bind

LAUNCHES.update(sqdist=0)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_TILE = 64          # output tile edge of the kernel
_MAX_GRID_Y = 65535


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


def sqdist_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the operands' CUDA device, on the current stream."""
    a, b = _f32_operands(a, b)
    if not a.is_cuda:
        raise ValueError("sqdist_kernel needs CUDA tensors")
    (n, d), m = a.shape, b.shape[0]
    if -(-n // _TILE) > _MAX_GRID_Y or max(n, m, d) >= 2 ** 31:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)} exceed "
                         "the kernel's grid")
    out = torch.empty(n, m, dtype=torch.float32, device=a.device)
    fn = bind("distance", "sqdist", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), n, b.data_ptr(), m, d, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
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
