"""InceptionV2 (BN-Inception) tower, architecture-exact to TF-slim: the
stem (a depthwise-separable 7x7), the Mixed_3b..Mixed_5c blocks and the
global average pool to the 1024-d ``AvgPool_1a`` endpoint.

The port of the JAX package's ``models/inception_v2.py``, with the same
flat module names (``Mixed_4b_Branch_2_Conv2d_0b_3x3`` and its
``..._BatchNorm``), so ``convert.py`` maps flax params and batch stats by
name.  What the layout change asks for:

* **Layout.**  Inputs are NHWC ``[B, H, W, 3]``, as in JAX, permuted once
  to NCHW at entry; ``capture_endpoints`` returns the endpoints in NCHW.
* **TF ``SAME`` padding.**  A stride-2 window pads asymmetrically (for a
  224 input, ``Conv2d_1a_7x7`` pads 2 before and 3 after; a stride-2 3x3
  on an even size pads 0 and 1), so those pads are explicit (``F.pad``),
  with -inf for the max pools.  Stride-1 windows pad symmetrically.
* **Average pools** leave padded cells out of the denominator
  (``count_include_pad=False``); Mixed_5c's pool branch is a max pool.
* **Batch norm** is beta only (slim's arg scope: no gamma), eps 0.001,
  decay 0.9997: :class:`BatchNorm`, whose training mode normalises with
  the biased batch variance E[x^2] - E[x]^2 (flax's fast variance) and
  moves the running statistics by 1 - 0.9997 towards the batch mean and
  that same biased variance.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (name, b0, (b1a, b1b), (b2a, b2b), b3, pool kind): slim's inception_v2
# block table at depth_multiplier=1; b2's two 3x3 convs share b2b
_BLOCKS = (
    ("Mixed_3b", 64, (64, 64), (64, 96), 32, "avg"),
    ("Mixed_3c", 64, (64, 96), (64, 96), 64, "avg"),
    ("Mixed_4a", None, (128, 160), (64, 96), None, "reduce"),
    ("Mixed_4b", 224, (64, 96), (96, 128), 128, "avg"),
    ("Mixed_4c", 192, (96, 128), (96, 128), 128, "avg"),
    ("Mixed_4d", 160, (128, 160), (128, 160), 96, "avg"),
    ("Mixed_4e", 96, (128, 192), (160, 192), 96, "avg"),
    ("Mixed_5a", None, (128, 192), (192, 256), None, "reduce"),
    ("Mixed_5b", 352, (192, 320), (160, 224), 128, "avg"),
    ("Mixed_5c", 352, (192, 320), (192, 224), 128, "max"),
)

# endpoint -> channel count
ENDPOINT_CHANNELS = {
    "Conv2d_1a_7x7": 64, "Conv2d_2b_1x1": 64, "Conv2d_2c_3x3": 192,
    "Mixed_3b": 256, "Mixed_3c": 320, "Mixed_4a": 576, "Mixed_4b": 576,
    "Mixed_4c": 576, "Mixed_4d": 576, "Mixed_4e": 576, "Mixed_5a": 1024,
    "Mixed_5b": 1024, "Mixed_5c": 1024,
}

Generator = Optional[torch.Generator]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF ``SAME``: ceil(size / stride) outputs, the padding split with the
    odd cell after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pair(k) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


def _pad_same(x: torch.Tensor, k, stride: int, value: float = 0.0):
    """(x, symmetric padding left for the op): pads ``x`` explicitly when
    TF's ``SAME`` split is uneven along either axis.  ``k`` is the window,
    an int or (kh, kw)."""
    kh, kw = _pair(k)
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, stride: int, k: int = 3) -> torch.Tensor:
    """k x k max pool with TF ``SAME`` padding (padded cells are -inf)."""
    x, pad = _pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride, padding=pad)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Generator = None) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1 / fan_in,
    truncated at two standard deviations (and rescaled for the cut)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """Conv with TF ``SAME`` (or, with ``padding="VALID"``, no) padding;
    ``weight`` [out, in / groups, kh, kw] (flax's HWIO kernel transposed),
    lecun-normal as flax's default, and a zero ``bias`` when asked for.
    ``k`` is an int or (kh, kw)."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 groups: int = 1, bias: bool = False,
                 generator: Generator = None, padding: str = "SAME"):
        super().__init__()
        kh, kw = _pair(k)
        self.k, self.stride, self.groups = (kh, kw), stride, groups
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        lecun_normal_(self.weight, cin // groups * kh * kw, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.padding == "SAME":
            x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad, 1,
                        self.groups)


class BatchNorm(nn.Module):
    """Beta-only batch norm over NCHW: a ``bias`` parameter and
    ``running_mean`` / ``running_var`` buffers (flax's ``mean`` / ``var``
    batch stats).  Training mode normalises with the batch mean and the
    biased batch variance and updates the buffers with ``momentum`` as
    flax's decay; eval mode uses the buffers."""

    def __init__(self, channels: int, momentum: float = 0.9997,
                 eps: float = 0.001):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class InceptionV2(nn.Module):
    """Trunk to the 1024-d AvgPool_1a endpoint: ``forward(x [B, H, W, 3])
    -> [B, 1024]``, or (that, endpoints) with ``capture_endpoints``."""

    def __init__(self, capture_endpoints: bool = False, in_channels: int = 3,
                 generator: Generator = None):
        super().__init__()
        self.capture_endpoints = capture_endpoints
        mult = min(64 // in_channels, 8)
        # Conv2d_1a_7x7: depthwise-separable, channel multiplier
        # min(64 // cin, 8) (slim's depthwise_multiplier), stride 2
        self.Conv2d_1a_7x7_depthwise = Conv(
            in_channels, in_channels * mult, 7, 2, groups=in_channels,
            generator=generator)
        self.Conv2d_1a_7x7_pointwise = Conv(in_channels * mult, 64, 1,
                                            generator=generator)
        self.Conv2d_1a_7x7_BatchNorm = BatchNorm(64)
        conv_bn = functools.partial(self._conv_bn, generator=generator)
        conv_bn("Conv2d_2b_1x1", 64, 64, 1)
        conv_bn("Conv2d_2c_3x3", 64, 192, 3)
        cin = 192
        for name, b0, b1, b2, b3, pool in _BLOCKS:
            if pool == "reduce":
                conv_bn(f"{name}_Branch_0_Conv2d_0a_1x1", cin, b1[0], 1)
                conv_bn(f"{name}_Branch_0_Conv2d_1a_3x3", b1[0], b1[1], 3, 2)
                conv_bn(f"{name}_Branch_1_Conv2d_0a_1x1", cin, b2[0], 1)
                conv_bn(f"{name}_Branch_1_Conv2d_0b_3x3", b2[0], b2[1], 3)
                conv_bn(f"{name}_Branch_1_Conv2d_1a_3x3", b2[1], b2[1], 3, 2)
                cin = b1[1] + b2[1] + cin
                continue
            conv_bn(f"{name}_Branch_0_Conv2d_0a_1x1", cin, b0, 1)
            conv_bn(f"{name}_Branch_1_Conv2d_0a_1x1", cin, b1[0], 1)
            conv_bn(f"{name}_Branch_1_Conv2d_0b_3x3", b1[0], b1[1], 3)
            conv_bn(f"{name}_Branch_2_Conv2d_0a_1x1", cin, b2[0], 1)
            conv_bn(f"{name}_Branch_2_Conv2d_0b_3x3", b2[0], b2[1], 3)
            conv_bn(f"{name}_Branch_2_Conv2d_0c_3x3", b2[1], b2[1], 3)
            conv_bn(f"{name}_Branch_3_Conv2d_0b_1x1", cin, b3, 1)
            cin = b0 + b1[1] + b2[1] + b3

    def _conv_bn(self, name: str, cin: int, cout: int, k: int,
                 stride: int = 1, generator: Generator = None) -> None:
        self.add_module(name, Conv(cin, cout, k, stride, generator=generator))
        self.add_module(f"{name}_BatchNorm", BatchNorm(cout))

    def _conv_bn_relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return torch.relu(getattr(self, f"{name}_BatchNorm")(x))

    def _block(self, spec, x: torch.Tensor) -> torch.Tensor:
        name, _, _, _, _, pool = spec
        if pool == "reduce":
            r0 = self._conv_bn_relu(f"{name}_Branch_0_Conv2d_0a_1x1", x)
            r0 = self._conv_bn_relu(f"{name}_Branch_0_Conv2d_1a_3x3", r0)
            r1 = self._conv_bn_relu(f"{name}_Branch_1_Conv2d_0a_1x1", x)
            r1 = self._conv_bn_relu(f"{name}_Branch_1_Conv2d_0b_3x3", r1)
            r1 = self._conv_bn_relu(f"{name}_Branch_1_Conv2d_1a_3x3", r1)
            return torch.cat([r0, r1, max_pool_same(x, 2)], dim=1)
        r0 = self._conv_bn_relu(f"{name}_Branch_0_Conv2d_0a_1x1", x)
        r1 = self._conv_bn_relu(f"{name}_Branch_1_Conv2d_0a_1x1", x)
        r1 = self._conv_bn_relu(f"{name}_Branch_1_Conv2d_0b_3x3", r1)
        r2 = self._conv_bn_relu(f"{name}_Branch_2_Conv2d_0a_1x1", x)
        r2 = self._conv_bn_relu(f"{name}_Branch_2_Conv2d_0b_3x3", r2)
        r2 = self._conv_bn_relu(f"{name}_Branch_2_Conv2d_0c_3x3", r2)
        if pool == "avg":
            # slim's avg_pool leaves padded cells out of the denominator
            p = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
        else:  # Mixed_5c's pool branch is a max pool
            p = max_pool_same(x, 1)
        r3 = self._conv_bn_relu(f"{name}_Branch_3_Conv2d_0b_1x1", p)
        return torch.cat([r0, r1, r2, r3], dim=1)

    def forward(self, x: torch.Tensor):
        endpoints: Dict[str, torch.Tensor] = {}
        h = x.to(self.Conv2d_2b_1x1.weight.dtype).permute(0, 3, 1, 2)
        h = self.Conv2d_1a_7x7_pointwise(self.Conv2d_1a_7x7_depthwise(
            h.contiguous()))
        h = torch.relu(self.Conv2d_1a_7x7_BatchNorm(h))
        endpoints["Conv2d_1a_7x7"] = h
        h = max_pool_same(h, 2)
        h = self._conv_bn_relu("Conv2d_2b_1x1", h)
        endpoints["Conv2d_2b_1x1"] = h
        h = self._conv_bn_relu("Conv2d_2c_3x3", h)
        endpoints["Conv2d_2c_3x3"] = h
        h = max_pool_same(h, 2)
        for spec in _BLOCKS:
            h = self._block(spec, h)
            endpoints[spec[0]] = h
        pool5 = h.mean(dim=(2, 3))                # AvgPool_1a -> [B, 1024]
        if self.capture_endpoints:
            return pool5, endpoints
        return pool5


# ---------------------------------------------------------------------------
# slim checkpoint grafting (the generic rules are in models/slim_graft.py)
# ---------------------------------------------------------------------------

def graft_slim_variables(model: nn.Module, slim_vars) -> nn.Module:
    """Fill ``model`` (an :class:`InceptionV2`) in place from a slim
    InceptionV2 checkpoint, a {slim variable name: array} dict."""
    from multimodal_similarity_tpu_torch.models import slim_graft
    return slim_graft.graft_slim_variables(model, slim_vars, "InceptionV2")


def graft_slim_npz(model: nn.Module, path: str) -> nn.Module:
    """Graft from an .npz of {slim variable name: array}."""
    from multimodal_similarity_tpu_torch.models import slim_graft
    return slim_graft.graft_slim_npz(model, path, "InceptionV2")
