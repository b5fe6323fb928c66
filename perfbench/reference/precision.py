"""The control's precision: TF32, the nearest below the float32 (TF32 off)
that the configurations state.

A TF32 product rounds each f32 operand to 10 mantissa bits and
accumulates in f32.  ``tf32`` rounds a tensor so (to nearest, ties away
from zero in magnitude), so an IEEE f32 product of rounded operands is a
TF32 product on the card and on the CPU alike."""

from __future__ import annotations

import torch

# the low mantissa bits TF32 drops, and half of its last kept bit
_DROP = -(1 << 13)
_HALF = 1 << 12


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value, kept in f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + _HALF) & _DROP).view(torch.float32)
