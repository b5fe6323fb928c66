"""Plain Inception-ResNet-v2 trunk (TF-slim's, to ``Conv2d_7b_1x1``) and
the extraction's preprocessing, in functional PyTorch over a dict of
weights.

The architecture is slim's (``inception_resnet_v2.py`` of
tensorflow/models research/slim): the VALID stem, Mixed_5b, 10 block35
(scale 0.17), Mixed_6a, 20 block17 (0.10), Mixed_7a, 9 block8 (0.20),
the unactivated final Block8 and Conv2d_7b_1x1; beta-only batch norm in
inference form (eps 0.001); biased 1x1 residual projections.  The weight
names follow the flat slim scopes a unit at a time
(``units.<i>.<scope>.<leaf>``), as the port's module keys them, so one
dict of weights made by ``make_weights`` serves both.

``UNITS`` is the trunk as a list of (kind, scope) and ``conv_shapes`` its
convolutions, which the FLOP count reads."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import tf32

EPS = 0.001

# each unit kind's convolutions: (name, cin, cout, (kh, kw), stride,
# padding, batch-normed); names are relative to the unit's scope prefix
_STEM = [("Conv2d_1a_3x3", 3, 32, (3, 3), 2, "VALID", True),
         ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, "VALID", True),
         ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, "SAME", True),
         ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, "VALID", True),
         ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, "VALID", True)]
_MIXED_5B = [("Branch_0_Conv2d_1x1", 192, 96, (1, 1), 1, "SAME", True),
             ("Branch_1_Conv2d_0a_1x1", 192, 48, (1, 1), 1, "SAME", True),
             ("Branch_1_Conv2d_0b_5x5", 48, 64, (5, 5), 1, "SAME", True),
             ("Branch_2_Conv2d_0a_1x1", 192, 64, (1, 1), 1, "SAME", True),
             ("Branch_2_Conv2d_0b_3x3", 64, 96, (3, 3), 1, "SAME", True),
             ("Branch_2_Conv2d_0c_3x3", 96, 96, (3, 3), 1, "SAME", True),
             ("Branch_3_Conv2d_0b_1x1", 192, 64, (1, 1), 1, "SAME", True)]
_BLOCK35 = [("Branch_0_Conv2d_1x1", 320, 32, (1, 1), 1, "SAME", True),
            ("Branch_1_Conv2d_0a_1x1", 320, 32, (1, 1), 1, "SAME", True),
            ("Branch_1_Conv2d_0b_3x3", 32, 32, (3, 3), 1, "SAME", True),
            ("Branch_2_Conv2d_0a_1x1", 320, 32, (1, 1), 1, "SAME", True),
            ("Branch_2_Conv2d_0b_3x3", 32, 48, (3, 3), 1, "SAME", True),
            ("Branch_2_Conv2d_0c_3x3", 48, 64, (3, 3), 1, "SAME", True),
            ("Conv2d_1x1", 128, 320, (1, 1), 1, "SAME", False)]
_MIXED_6A = [("Branch_0_Conv2d_1a_3x3", 320, 384, (3, 3), 2, "VALID", True),
             ("Branch_1_Conv2d_0a_1x1", 320, 256, (1, 1), 1, "SAME", True),
             ("Branch_1_Conv2d_0b_3x3", 256, 256, (3, 3), 1, "SAME", True),
             ("Branch_1_Conv2d_1a_3x3", 256, 384, (3, 3), 2, "VALID", True)]
_BLOCK17 = [("Branch_0_Conv2d_1x1", 1088, 192, (1, 1), 1, "SAME", True),
            ("Branch_1_Conv2d_0a_1x1", 1088, 128, (1, 1), 1, "SAME", True),
            ("Branch_1_Conv2d_0b_1x7", 128, 160, (1, 7), 1, "SAME", True),
            ("Branch_1_Conv2d_0c_7x1", 160, 192, (7, 1), 1, "SAME", True),
            ("Conv2d_1x1", 384, 1088, (1, 1), 1, "SAME", False)]
_MIXED_7A = [("Branch_0_Conv2d_0a_1x1", 1088, 256, (1, 1), 1, "SAME", True),
             ("Branch_0_Conv2d_1a_3x3", 256, 384, (3, 3), 2, "VALID", True),
             ("Branch_1_Conv2d_0a_1x1", 1088, 256, (1, 1), 1, "SAME", True),
             ("Branch_1_Conv2d_1a_3x3", 256, 288, (3, 3), 2, "VALID", True),
             ("Branch_2_Conv2d_0a_1x1", 1088, 256, (1, 1), 1, "SAME", True),
             ("Branch_2_Conv2d_0b_3x3", 256, 288, (3, 3), 1, "SAME", True),
             ("Branch_2_Conv2d_1a_3x3", 288, 320, (3, 3), 2, "VALID", True)]
_BLOCK8 = [("Branch_0_Conv2d_1x1", 2080, 192, (1, 1), 1, "SAME", True),
           ("Branch_1_Conv2d_0a_1x1", 2080, 192, (1, 1), 1, "SAME", True),
           ("Branch_1_Conv2d_0b_1x3", 192, 224, (1, 3), 1, "SAME", True),
           ("Branch_1_Conv2d_0c_3x1", 224, 256, (3, 1), 1, "SAME", True),
           ("Conv2d_1x1", 448, 2080, (1, 1), 1, "SAME", False)]
_FINAL = _BLOCK8 + [("Conv2d_7b_1x1", 2080, 1536, (1, 1), 1, "SAME", True)]

_CONVS = {"stem": _STEM, "mixed_5b": _MIXED_5B, "block35": _BLOCK35,
          "mixed_6a": _MIXED_6A, "block17": _BLOCK17, "mixed_7a": _MIXED_7A,
          "block8": _BLOCK8, "final": _FINAL}

# (kind, scope prefix of its convolutions) for the 44 units in order
UNITS: List[Tuple[str, str]] = (
    [("stem", ""), ("mixed_5b", "Mixed_5b_")]
    + [("block35", f"Repeat_block35_{i}_") for i in range(1, 11)]
    + [("mixed_6a", "Mixed_6a_")]
    + [("block17", f"Repeat_1_block17_{i}_") for i in range(1, 21)]
    + [("mixed_7a", "Mixed_7a_")]
    + [("block8", f"Repeat_2_block8_{i}_") for i in range(1, 10)]
    + [("final", "Block8_")])


def _conv_name(prefix: str, name: str) -> str:
    # the final unit's Conv2d_7b_1x1 sits outside the Block8 scope
    return name if name == "Conv2d_7b_1x1" else prefix + name


def conv_shapes() -> List[Tuple[str, int, int, Tuple[int, int], int, str,
                                bool]]:
    """Every convolution of the trunk: (weight key prefix, cin, cout,
    kernel, stride, padding, batch-normed), in order."""
    out = []
    for i, (kind, prefix) in enumerate(UNITS):
        for name, cin, cout, k, s, pad, bn in _CONVS[kind]:
            out.append((f"units.{i}.{_conv_name(prefix, name)}", cin, cout,
                        k, s, pad, bn))
    return out


def make_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, bias and batch-norm statistic of the trunk from
    ``seed``, on the device: kernels normal of variance 1 / fan-in (one
    draw for all of them), betas and projection biases normal of standard
    deviation 0.01, running means normal of standard deviation 0.1 and
    running variances uniform in [0.5, 2), so that a wrong use of either
    statistic shows in the features."""
    convs = conv_shapes()
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [cout * cin * k[0] * k[1] for _, cin, cout, k, _, _, _ in convs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    n_bias = sum(cout for _, _, cout, _, _, _, _ in convs)
    biases = torch.randn(n_bias, generator=g, device=device) * 0.01
    means = torch.randn(n_bias, generator=g, device=device) * 0.1
    variances = 0.5 + 1.5 * torch.rand(n_bias, generator=g, device=device)
    out, off, boff = {}, 0, 0
    for (key, cin, cout, k, _, _, bn), size in zip(convs, sizes):
        fan_in = cin * k[0] * k[1]
        out[key + ".weight"] = (flat[off:off + size].reshape(
            cout, cin, k[0], k[1]) * fan_in ** -0.5)
        off += size
        bias = biases[boff:boff + cout]
        if bn:
            out[key + "_BatchNorm.bias"] = bias
            out[key + "_BatchNorm.running_mean"] = means[boff:boff + cout]
            out[key + "_BatchNorm.running_var"] = variances[boff:boff + cout]
        else:
            out[key + ".bias"] = bias
        boff += cout
    return out


class Trunk:
    """``Trunk(weights, control)(x [B, 3, H, W] f32) -> [B, 1536, h, w]``;
    ``control`` rounds every convolution's operands to TF32; ``record``
    (a list) receives each convolution's (cout, cin, kh, kw, h, w)."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 control: bool = False, record: list = None):
        self.w, self.control, self.record = weights, control, record

    def conv(self, key: str, x, k, stride, padding, bn):
        w, b = self.w[key + ".weight"], self.w.get(key + ".bias")
        pad = (0, 0) if padding == "VALID" else ((k[0] - 1) // 2,
                                                 (k[1] - 1) // 2)
        if self.control:
            x, w = tf32(x), tf32(w)
        y = F.conv2d(x, w, b, stride, pad)
        if self.record is not None:
            self.record.append(tuple(w.shape) + tuple(y.shape[2:]))
        if not bn:
            return y
        mean = self.w[key + "_BatchNorm.running_mean"]
        mul = torch.rsqrt(self.w[key + "_BatchNorm.running_var"] + EPS)
        beta = self.w[key + "_BatchNorm.bias"]
        y = ((y - mean[None, :, None, None]) * mul[None, :, None, None]
             + beta[None, :, None, None])
        return torch.relu(y)

    def unit(self, i: int, x):
        kind, prefix = UNITS[i]
        spec = {name: (k, s, pad, bn)
                for name, _, _, k, s, pad, bn in _CONVS[kind]}

        def c(name, h):
            return self.conv(f"units.{i}.{_conv_name(prefix, name)}", h,
                             *spec[name])

        if kind == "stem":
            h = c("Conv2d_2b_3x3", c("Conv2d_2a_3x3", c("Conv2d_1a_3x3", x)))
            h = F.max_pool2d(h, 3, 2)
            h = c("Conv2d_4a_3x3", c("Conv2d_3b_1x1", h))
            return F.max_pool2d(h, 3, 2)
        if kind == "mixed_5b":
            r0 = c("Branch_0_Conv2d_1x1", x)
            r1 = c("Branch_1_Conv2d_0b_5x5", c("Branch_1_Conv2d_0a_1x1", x))
            r2 = c("Branch_2_Conv2d_0c_3x3", c("Branch_2_Conv2d_0b_3x3",
                                               c("Branch_2_Conv2d_0a_1x1",
                                                 x)))
            pool = F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
            r3 = c("Branch_3_Conv2d_0b_1x1", pool)
            return torch.cat([r0, r1, r2, r3], 1)
        if kind == "block35":
            r0 = c("Branch_0_Conv2d_1x1", x)
            r1 = c("Branch_1_Conv2d_0b_3x3", c("Branch_1_Conv2d_0a_1x1", x))
            r2 = c("Branch_2_Conv2d_0c_3x3", c("Branch_2_Conv2d_0b_3x3",
                                               c("Branch_2_Conv2d_0a_1x1",
                                                 x)))
            up = c("Conv2d_1x1", torch.cat([r0, r1, r2], 1))
            return torch.relu(x + 0.17 * up)
        if kind == "mixed_6a":
            r0 = c("Branch_0_Conv2d_1a_3x3", x)
            r1 = c("Branch_1_Conv2d_1a_3x3", c("Branch_1_Conv2d_0b_3x3",
                                               c("Branch_1_Conv2d_0a_1x1",
                                                 x)))
            return torch.cat([r0, r1, F.max_pool2d(x, 3, 2)], 1)
        if kind == "block17":
            r0 = c("Branch_0_Conv2d_1x1", x)
            r1 = c("Branch_1_Conv2d_0c_7x1", c("Branch_1_Conv2d_0b_1x7",
                                               c("Branch_1_Conv2d_0a_1x1",
                                                 x)))
            up = c("Conv2d_1x1", torch.cat([r0, r1], 1))
            return torch.relu(x + 0.10 * up)
        if kind == "mixed_7a":
            r0 = c("Branch_0_Conv2d_1a_3x3", c("Branch_0_Conv2d_0a_1x1", x))
            r1 = c("Branch_1_Conv2d_1a_3x3", c("Branch_1_Conv2d_0a_1x1", x))
            r2 = c("Branch_2_Conv2d_1a_3x3", c("Branch_2_Conv2d_0b_3x3",
                                               c("Branch_2_Conv2d_0a_1x1",
                                                 x)))
            return torch.cat([r0, r1, r2, F.max_pool2d(x, 3, 2)], 1)
        # block8 (scale 0.20, relu) or the final one (scale 1, no relu,
        # then Conv2d_7b_1x1)
        r0 = c("Branch_0_Conv2d_1x1", x)
        r1 = c("Branch_1_Conv2d_0c_3x1", c("Branch_1_Conv2d_0b_1x3",
                                           c("Branch_1_Conv2d_0a_1x1", x)))
        up = c("Conv2d_1x1", torch.cat([r0, r1], 1))
        if kind == "block8":
            return torch.relu(x + 0.20 * up)
        return c("Conv2d_7b_1x1", x + up)

    def __call__(self, x):
        for i in range(len(UNITS)):
            x = self.unit(i, x)
        return x


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> [B, 3, size, size] in [-1, 1]: / 255,
    a bilinear resize with half-pixel centres that low-passes when it
    shrinks, then (x - 0.5) * 2."""
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    shrinks = x.shape[2] > size or x.shape[3] > size
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=shrinks)
    return (x - 0.5) * 2.0


def features(weights, frames: torch.Tensor, size: int,
             control: bool = False) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] on the device -> NHWC f32 features."""
    with torch.no_grad():
        return Trunk(weights, control)(preprocess(frames, size)).permute(
            0, 2, 3, 1)
