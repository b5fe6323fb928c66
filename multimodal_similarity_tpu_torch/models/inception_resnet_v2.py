"""Inception-ResNet-v2 trunk, architecture-exact to TF-slim, to the
``Conv2d_7b_1x1`` conv endpoint: ``[B, 1536, 8, 8]`` at 299 x 299 input,
the per-frame video feature of the Honda pipeline (``resnet``, 8x8x1536).

The port of the JAX package's ``models/inception_resnet_v2.py``: the
VALID-padded stem, Mixed_5b, 10x block35 (scale 0.17), Mixed_6a, 20x
block17 (0.10), Mixed_7a, 9x block8 (0.20), the final unactivated Block8
and Conv2d_7b_1x1.  Batch norm is beta only, eps 0.001, decay 0.9997
(``inception_v2.BatchNorm``); the residual projections ``<scope>_Conv2d_1x1``
are biased 1x1 convs with no batch norm, as in slim.

What the port changes:

* **Layout.**  ``forward`` takes NCHW ``[B, 3, H, W]`` and returns NCHW;
  ``capture_endpoints`` returns the endpoints in NCHW too.
* **Units.**  The trunk is ``units``, an ``nn.ModuleList`` of the
  ``N_PIPELINE_UNITS`` = 44 sequential units of the JAX ``_units`` (stem,
  Mixed_5b, block35_1..10, Mixed_6a, block17_1..20, Mixed_7a,
  block8_1..9, final), so a pipeline stage (``parallel/pipeline.py``) is a
  contiguous run ``units[lo:hi]``; ``forward(x, unit_lo, unit_hi)`` runs
  only that run, on the previous unit's activation when ``unit_lo > 0``.
* **Names.**  Each unit holds its convolutions and batch norms under the
  flat slim scope names of the flax module (``Repeat_1_block17_12_Branch_1
  _Conv2d_0b_1x7`` and its ``..._BatchNorm``), so the state key is
  ``units.<i>.<scope>.<leaf>``; ``flax_scopes()`` is the scope -> unit
  table that ``convert.py`` and ``slim_graft.py`` read.
* **TF ``SAME`` padding** of the stride-2 windows is asymmetric and
  explicit (``inception_v2._pad_same``); VALID windows pad nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_similarity_tpu_torch.models.inception_v2 import (
    BatchNorm, Conv, Generator)

ENDPOINT_CHANNELS: Dict[str, int] = {
    "Conv2d_1a_3x3": 32, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 64,
    "Conv2d_3b_1x1": 80, "Conv2d_4a_3x3": 192, "Mixed_5b": 320,
    "Mixed_6a": 1088, "Mixed_7a": 2080, "Conv2d_7b_1x1": 1536,
}

# the trunk as 44 sequential units: stem, Mixed_5b, 10x block35, Mixed_6a,
# 20x block17, Mixed_7a, 9x block8, the final Block8 + Conv2d_7b
N_PIPELINE_UNITS = 44


class _Unit(nn.Module):
    """A unit: convolutions and batch norms under flat slim scope names,
    each ``<name>`` conv followed by its ``<name>_BatchNorm`` and a relu."""

    def __init__(self, generator: Generator = None):
        super().__init__()
        self._gen = generator       # build_units drops it once built

    def conv_bn(self, name: str, cin: int, cout: int, k, stride: int = 1,
                padding: str = "SAME") -> None:
        self.add_module(name, Conv(cin, cout, k, stride,
                                   generator=self._gen, padding=padding))
        self.add_module(f"{name}_BatchNorm", BatchNorm(cout))

    def proj(self, name: str, cin: int, cout: int) -> None:
        """The residual projection: a biased 1x1 conv, no batch norm."""
        self.add_module(name, Conv(cin, cout, 1, bias=True,
                                   generator=self._gen))

    def cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        return torch.relu(getattr(self, f"{name}_BatchNorm")(x))


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class Stem(_Unit):
    """Conv2d_1a_3x3 (stride 2, VALID) .. Conv2d_4a_3x3 and the two VALID
    max pools: [B, 3, 299, 299] -> [B, 192, 35, 35]."""

    names = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
             "Conv2d_3b_1x1", "Conv2d_4a_3x3")

    def __init__(self, generator: Generator = None):
        super().__init__(generator)
        self.conv_bn("Conv2d_1a_3x3", 3, 32, 3, 2, "VALID")
        self.conv_bn("Conv2d_2a_3x3", 32, 32, 3, padding="VALID")
        self.conv_bn("Conv2d_2b_3x3", 32, 64, 3)
        self.conv_bn("Conv2d_3b_1x1", 64, 80, 1, padding="VALID")
        self.conv_bn("Conv2d_4a_3x3", 80, 192, 3, padding="VALID")

    def forward(self, x, endpoints: Optional[Dict] = None):
        h = x
        for i, name in enumerate(self.names):
            if i == 3:
                h = _max_pool_valid(h)
            h = self.cbr(name, h)
            if endpoints is not None:
                endpoints[name] = h
        return _max_pool_valid(h)


class Mixed5b(_Unit):
    def __init__(self, generator: Generator = None):
        super().__init__(generator)
        p = "Mixed_5b_"
        self.conv_bn(p + "Branch_0_Conv2d_1x1", 192, 96, 1)
        self.conv_bn(p + "Branch_1_Conv2d_0a_1x1", 192, 48, 1)
        self.conv_bn(p + "Branch_1_Conv2d_0b_5x5", 48, 64, 5)
        self.conv_bn(p + "Branch_2_Conv2d_0a_1x1", 192, 64, 1)
        self.conv_bn(p + "Branch_2_Conv2d_0b_3x3", 64, 96, 3)
        self.conv_bn(p + "Branch_2_Conv2d_0c_3x3", 96, 96, 3)
        self.conv_bn(p + "Branch_3_Conv2d_0b_1x1", 192, 64, 1)

    def forward(self, h):
        p = "Mixed_5b_"
        r0 = self.cbr(p + "Branch_0_Conv2d_1x1", h)
        r1 = self.cbr(p + "Branch_1_Conv2d_0b_5x5",
                      self.cbr(p + "Branch_1_Conv2d_0a_1x1", h))
        r2 = self.cbr(p + "Branch_2_Conv2d_0a_1x1", h)
        r2 = self.cbr(p + "Branch_2_Conv2d_0c_3x3",
                      self.cbr(p + "Branch_2_Conv2d_0b_3x3", r2))
        # slim's average pool leaves padded cells out of the denominator
        pool = F.avg_pool2d(h, 3, 1, 1, count_include_pad=False)
        r3 = self.cbr(p + "Branch_3_Conv2d_0b_1x1", pool)
        return torch.cat([r0, r1, r2, r3], dim=1)


class Block35(_Unit):
    """35 x 35 residual block (320 channels), scale 0.17."""

    def __init__(self, scope: str, generator: Generator = None):
        super().__init__(generator)
        self.scope = s = scope + "_"
        self.conv_bn(s + "Branch_0_Conv2d_1x1", 320, 32, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0a_1x1", 320, 32, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0b_3x3", 32, 32, 3)
        self.conv_bn(s + "Branch_2_Conv2d_0a_1x1", 320, 32, 1)
        self.conv_bn(s + "Branch_2_Conv2d_0b_3x3", 32, 48, 3)
        self.conv_bn(s + "Branch_2_Conv2d_0c_3x3", 48, 64, 3)
        self.proj(s + "Conv2d_1x1", 128, 320)

    def forward(self, x):
        s = self.scope
        r0 = self.cbr(s + "Branch_0_Conv2d_1x1", x)
        r1 = self.cbr(s + "Branch_1_Conv2d_0b_3x3",
                      self.cbr(s + "Branch_1_Conv2d_0a_1x1", x))
        r2 = self.cbr(s + "Branch_2_Conv2d_0a_1x1", x)
        r2 = self.cbr(s + "Branch_2_Conv2d_0c_3x3",
                      self.cbr(s + "Branch_2_Conv2d_0b_3x3", r2))
        up = getattr(self, s + "Conv2d_1x1")(torch.cat([r0, r1, r2], dim=1))
        return torch.relu(x + 0.17 * up)


class Mixed6a(_Unit):
    def __init__(self, generator: Generator = None):
        super().__init__(generator)
        p = "Mixed_6a_"
        self.conv_bn(p + "Branch_0_Conv2d_1a_3x3", 320, 384, 3, 2, "VALID")
        self.conv_bn(p + "Branch_1_Conv2d_0a_1x1", 320, 256, 1)
        self.conv_bn(p + "Branch_1_Conv2d_0b_3x3", 256, 256, 3)
        self.conv_bn(p + "Branch_1_Conv2d_1a_3x3", 256, 384, 3, 2, "VALID")

    def forward(self, h):
        p = "Mixed_6a_"
        r0 = self.cbr(p + "Branch_0_Conv2d_1a_3x3", h)
        r1 = self.cbr(p + "Branch_1_Conv2d_0a_1x1", h)
        r1 = self.cbr(p + "Branch_1_Conv2d_1a_3x3",
                      self.cbr(p + "Branch_1_Conv2d_0b_3x3", r1))
        return torch.cat([r0, r1, _max_pool_valid(h)], dim=1)


class Block17(_Unit):
    """17 x 17 residual block (1088 channels), scale 0.10."""

    def __init__(self, scope: str, generator: Generator = None):
        super().__init__(generator)
        self.scope = s = scope + "_"
        self.conv_bn(s + "Branch_0_Conv2d_1x1", 1088, 192, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0a_1x1", 1088, 128, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0b_1x7", 128, 160, (1, 7))
        self.conv_bn(s + "Branch_1_Conv2d_0c_7x1", 160, 192, (7, 1))
        self.proj(s + "Conv2d_1x1", 384, 1088)

    def forward(self, x):
        s = self.scope
        r0 = self.cbr(s + "Branch_0_Conv2d_1x1", x)
        r1 = self.cbr(s + "Branch_1_Conv2d_0a_1x1", x)
        r1 = self.cbr(s + "Branch_1_Conv2d_0c_7x1",
                      self.cbr(s + "Branch_1_Conv2d_0b_1x7", r1))
        up = getattr(self, s + "Conv2d_1x1")(torch.cat([r0, r1], dim=1))
        return torch.relu(x + 0.10 * up)


class Mixed7a(_Unit):
    def __init__(self, generator: Generator = None):
        super().__init__(generator)
        p = "Mixed_7a_"
        self.conv_bn(p + "Branch_0_Conv2d_0a_1x1", 1088, 256, 1)
        self.conv_bn(p + "Branch_0_Conv2d_1a_3x3", 256, 384, 3, 2, "VALID")
        self.conv_bn(p + "Branch_1_Conv2d_0a_1x1", 1088, 256, 1)
        self.conv_bn(p + "Branch_1_Conv2d_1a_3x3", 256, 288, 3, 2, "VALID")
        self.conv_bn(p + "Branch_2_Conv2d_0a_1x1", 1088, 256, 1)
        self.conv_bn(p + "Branch_2_Conv2d_0b_3x3", 256, 288, 3)
        self.conv_bn(p + "Branch_2_Conv2d_1a_3x3", 288, 320, 3, 2, "VALID")

    def forward(self, h):
        p = "Mixed_7a_"
        r0 = self.cbr(p + "Branch_0_Conv2d_1a_3x3",
                      self.cbr(p + "Branch_0_Conv2d_0a_1x1", h))
        r1 = self.cbr(p + "Branch_1_Conv2d_1a_3x3",
                      self.cbr(p + "Branch_1_Conv2d_0a_1x1", h))
        r2 = self.cbr(p + "Branch_2_Conv2d_0a_1x1", h)
        r2 = self.cbr(p + "Branch_2_Conv2d_1a_3x3",
                      self.cbr(p + "Branch_2_Conv2d_0b_3x3", r2))
        return torch.cat([r0, r1, r2, _max_pool_valid(h)], dim=1)


class Block8(_Unit):
    """8 x 8 residual block (2080 channels), scale 0.20 and a relu; the
    final Block8 (``Final``) takes scale 1.0 and no relu."""

    def __init__(self, scope: str, generator: Generator = None,
                 scale: float = 0.20, activate: bool = True):
        super().__init__(generator)
        self.scope = s = scope + "_"
        self.scale, self.activate = scale, activate
        self.conv_bn(s + "Branch_0_Conv2d_1x1", 2080, 192, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0a_1x1", 2080, 192, 1)
        self.conv_bn(s + "Branch_1_Conv2d_0b_1x3", 192, 224, (1, 3))
        self.conv_bn(s + "Branch_1_Conv2d_0c_3x1", 224, 256, (3, 1))
        self.proj(s + "Conv2d_1x1", 448, 2080)

    def forward(self, x):
        s = self.scope
        r0 = self.cbr(s + "Branch_0_Conv2d_1x1", x)
        r1 = self.cbr(s + "Branch_1_Conv2d_0a_1x1", x)
        r1 = self.cbr(s + "Branch_1_Conv2d_0c_3x1",
                      self.cbr(s + "Branch_1_Conv2d_0b_1x3", r1))
        up = getattr(self, s + "Conv2d_1x1")(torch.cat([r0, r1], dim=1))
        out = x + self.scale * up
        return torch.relu(out) if self.activate else out


class Final(Block8):
    """The unactivated final Block8, then Conv2d_7b_1x1 (2080 -> 1536)."""

    def __init__(self, generator: Generator = None):
        super().__init__("Block8", generator, scale=1.0, activate=False)
        self.conv_bn("Conv2d_7b_1x1", 2080, 1536, 1)

    def forward(self, x):
        return self.cbr("Conv2d_7b_1x1", super().forward(x))


def build_units(generator: Generator = None) -> List[nn.Module]:
    """The 44 units in order, with the JAX unit names' scopes."""
    units: List[nn.Module] = [Stem(generator), Mixed5b(generator)]
    units += [Block35(f"Repeat_block35_{i}", generator) for i in range(1, 11)]
    units.append(Mixed6a(generator))
    units += [Block17(f"Repeat_1_block17_{i}", generator)
              for i in range(1, 21)]
    units.append(Mixed7a(generator))
    units += [Block8(f"Repeat_2_block8_{i}", generator) for i in range(1, 10)]
    units.append(Final(generator))
    assert len(units) == N_PIPELINE_UNITS
    for unit in units:
        del unit._gen
    return units


# the endpoints named after a whole unit, by unit index
_UNIT_ENDPOINTS = {1: "Mixed_5b", 12: "Mixed_6a", 33: "Mixed_7a"}


class InceptionResNetV2(nn.Module):
    """Trunk to the Conv2d_7b_1x1 endpoint: ``forward(x [B, 3, H, W]) ->
    [B, 1536, h, w]`` ([B, 1536, 8, 8] at 299), or (that, endpoints) with
    ``capture_endpoints``.  ``generator`` draws the initial weights
    (lecun-normal kernels, zero biases and betas)."""

    def __init__(self, capture_endpoints: bool = False,
                 generator: Generator = None):
        super().__init__()
        self.capture_endpoints = capture_endpoints
        self.units = nn.ModuleList(build_units(generator))

    def flax_scopes(self) -> Dict[str, str]:
        """Each flat flax (and slim) scope -> its module path,
        ``units.<i>.<scope>``."""
        return {name: f"units.{i}.{name}"
                for i, unit in enumerate(self.units)
                for name, _ in unit.named_children()}

    def forward(self, x: torch.Tensor, unit_lo: int = 0,
                unit_hi: int = N_PIPELINE_UNITS):
        """The units in [unit_lo, unit_hi); the input is an image batch
        when ``unit_lo`` is 0, else unit ``unit_lo - 1``'s activation."""
        if self.capture_endpoints and (unit_lo, unit_hi) != (
                0, N_PIPELINE_UNITS):
            raise ValueError("capture_endpoints needs the full unit range")
        endpoints: Dict[str, torch.Tensor] = {}
        h = x
        if unit_lo == 0:
            h = h.to(self.units[0].Conv2d_1a_3x3.weight.dtype)
        for i in range(unit_lo, unit_hi):
            unit = self.units[i]
            h = unit(h, endpoints) if i == 0 else unit(h)
            if i in _UNIT_ENDPOINTS:
                endpoints[_UNIT_ENDPOINTS[i]] = h
        endpoints["Conv2d_7b_1x1"] = h
        if self.capture_endpoints:
            return h, endpoints
        return h
