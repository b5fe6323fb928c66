"""PyTorch and CUDA port of ``multimodal_similarity_tpu``.

The JAX package is the reference; this package mirrors its layout
(``configs``, ``data``, ``models``, ``ops``, ``train``, ``eval``, ``utils``)
and imports neither JAX nor any module of the JAX package.  Every Pallas
kernel on a ported path is a hand-written CUDA C++ kernel under ``csrc/``,
built for ``sm_90a`` at first use.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; a tensor on the CPU takes each kernel's plain
PyTorch version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for (or defaulted to) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev
