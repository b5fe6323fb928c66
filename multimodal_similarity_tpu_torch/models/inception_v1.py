"""InceptionV1 (GoogLeNet) trunk, architecture-exact to TF-slim, to the
1024-d global-average ``AvgPool_0a_7x7`` endpoint: the CUB / Stanford40
image feature (``[B, 1024]`` at 224 x 224).

The port of the JAX package's ``models/inception_v1.py``: slim's block
table, slim's Branch_2 3x3 (the paper's 5x5 was never in the released
checkpoint) and its scope quirk (``Mixed_5b_Branch_2_Conv2d_0a_3x3``),
beta-only batch norm (``inception_v2.BatchNorm``), TF ``SAME`` padding
throughout.  The flat module names are the flax ones, so ``convert.py``
and ``slim_graft.py`` map by name.  ``forward`` takes NCHW ``[B, 3, H, W]``;
``capture_endpoints`` returns the endpoints in NCHW.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from multimodal_similarity_tpu_torch.models.inception_v2 import (
    BatchNorm, Conv, Generator, max_pool_same)

# (name, b0, (b1a, b1b), (b2a, b2b), b3): slim's inception_v1 table
_BLOCKS_3 = (
    ("Mixed_3b", 64, (96, 128), (16, 32), 32),
    ("Mixed_3c", 128, (128, 192), (32, 96), 64),
)
_BLOCKS_4 = (
    ("Mixed_4b", 192, (96, 208), (16, 48), 64),
    ("Mixed_4c", 160, (112, 224), (24, 64), 64),
    ("Mixed_4d", 128, (128, 256), (24, 64), 64),
    ("Mixed_4e", 112, (144, 288), (32, 64), 64),
    ("Mixed_4f", 256, (160, 320), (32, 128), 128),
)
_BLOCKS_5 = (
    ("Mixed_5b", 256, (160, 320), (32, 128), 128),
    ("Mixed_5c", 384, (192, 384), (48, 128), 128),
)

ENDPOINT_CHANNELS: Dict[str, int] = {
    "Conv2d_1a_7x7": 64, "Conv2d_2b_1x1": 64, "Conv2d_2c_3x3": 192,
    "Mixed_3b": 256, "Mixed_3c": 480, "Mixed_4b": 512, "Mixed_4c": 512,
    "Mixed_4d": 512, "Mixed_4e": 528, "Mixed_4f": 832, "Mixed_5b": 832,
    "Mixed_5c": 1024,
}


def _b2_name(name: str) -> str:
    # slim's scope quirk: Mixed_5b's Branch_2 second conv is Conv2d_0a_3x3
    # in the released checkpoint (every other block has 0b)
    suffix = "0a" if name == "Mixed_5b" else "0b"
    return f"{name}_Branch_2_Conv2d_{suffix}_3x3"


class InceptionV1(nn.Module):
    """Trunk to the 1024-d average pool: ``forward(x [B, 3, H, W]) ->
    [B, 1024]``, or (that, endpoints) with ``capture_endpoints``."""

    def __init__(self, capture_endpoints: bool = False,
                 generator: Generator = None):
        super().__init__()
        self.capture_endpoints = capture_endpoints

        def conv_bn(name, cin, cout, k, stride=1):
            self.add_module(name, Conv(cin, cout, k, stride,
                                       generator=generator))
            self.add_module(f"{name}_BatchNorm", BatchNorm(cout))

        conv_bn("Conv2d_1a_7x7", 3, 64, 7, 2)
        conv_bn("Conv2d_2b_1x1", 64, 64, 1)
        conv_bn("Conv2d_2c_3x3", 64, 192, 3)
        cin = 192
        for name, b0, b1, b2, b3 in _BLOCKS_3 + _BLOCKS_4 + _BLOCKS_5:
            conv_bn(f"{name}_Branch_0_Conv2d_0a_1x1", cin, b0, 1)
            conv_bn(f"{name}_Branch_1_Conv2d_0a_1x1", cin, b1[0], 1)
            conv_bn(f"{name}_Branch_1_Conv2d_0b_3x3", b1[0], b1[1], 3)
            conv_bn(f"{name}_Branch_2_Conv2d_0a_1x1", cin, b2[0], 1)
            conv_bn(_b2_name(name), b2[0], b2[1], 3)
            conv_bn(f"{name}_Branch_3_Conv2d_0b_1x1", cin, b3, 1)
            cin = b0 + b1[1] + b2[1] + b3

    def _cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return torch.relu(getattr(self, f"{name}_BatchNorm")(x))

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        r0 = self._cbr(f"{name}_Branch_0_Conv2d_0a_1x1", x)
        r1 = self._cbr(f"{name}_Branch_1_Conv2d_0b_3x3",
                       self._cbr(f"{name}_Branch_1_Conv2d_0a_1x1", x))
        r2 = self._cbr(_b2_name(name),
                       self._cbr(f"{name}_Branch_2_Conv2d_0a_1x1", x))
        r3 = self._cbr(f"{name}_Branch_3_Conv2d_0b_1x1", max_pool_same(x, 1))
        return torch.cat([r0, r1, r2, r3], dim=1)

    def forward(self, x: torch.Tensor):
        endpoints: Dict[str, torch.Tensor] = {}
        h = x.to(self.Conv2d_1a_7x7.weight.dtype)
        for name in ("Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3"):
            if name == "Conv2d_2b_1x1":
                h = max_pool_same(h, 2)
            h = self._cbr(name, h)
            endpoints[name] = h
        h = max_pool_same(h, 2)
        for blocks, pool_k in ((_BLOCKS_3, 3), (_BLOCKS_4, 2),
                               (_BLOCKS_5, None)):
            for name, *_ in blocks:
                h = self._block(name, h)
                endpoints[name] = h
            if pool_k is not None:
                h = max_pool_same(h, 2, pool_k)
        pool5 = h.mean(dim=(2, 3))          # AvgPool_0a_7x7 -> [B, 1024]
        if self.capture_endpoints:
            return pool5, endpoints
        return pool5
