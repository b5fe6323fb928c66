"""LSTM with the reference's cell: ``tf.contrib.rnn.LSTMCell`` with
``forget_bias=1.0``.

Gate order (i, j, f, o), +1.0 added to the forget gate pre-activation, no
peepholes, tanh activations, and one fused ``[x; h]`` weight.
``torch.nn.LSTM`` orders its gates (i, f, g, o), keeps two weights and adds
no forget bias, so the cell is written out here.  The time loop is a Python
loop: the encoders run it over the few TSN segments.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

# flax's default Dense kernel init is lecun_normal: a normal truncated at two
# standard deviations, rescaled so the truncated draw keeps variance 1/fan_in
_TRUNC_STD_CORRECTION = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax ``lecun_normal`` on a torch ``[out, in]`` weight."""
    std = (1.0 / weight.shape[1]) ** 0.5 / _TRUNC_STD_CORRECTION
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class TFLSTMCell(nn.Module):
    """One step: ``gates = kernel([x; h])``, split (i, j, f, o)."""

    def __init__(self, input_size: int, features: int,
                 forget_bias: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.forget_bias = forget_bias
        # named like the flax cell's Dense ("cell/kernel") for convert.py
        self.kernel = nn.Linear(input_size + features, 4 * features)
        lecun_normal_(self.kernel.weight, generator)
        nn.init.zeros_(self.kernel.bias)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        c, h = carry
        gates = self.kernel(torch.cat([x, h], dim=-1))
        i, j, f, o = gates.chunk(4, dim=-1)
        new_c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class LSTM(nn.Module):
    """Unidirectional LSTM over [B, T, D]; returns (outputs [B, T, H],
    final (c, h) state)."""

    def __init__(self, input_size: int, features: int,
                 forget_bias: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.cell = TFLSTMCell(input_size, features, forget_bias, generator)

    def forward(self, x: torch.Tensor,
                initial_state: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
        if initial_state is None:
            zeros = x.new_zeros((x.shape[0], self.features))
            initial_state = (zeros, zeros)
        state = initial_state
        outputs = []
        for t in range(x.shape[1]):
            state, out = self.cell(state, x[:, t])
            outputs.append(out)
        return torch.stack(outputs, dim=1), state


class BiLSTM(nn.Module):
    """Bidirectional LSTM; outputs concat([fw, bw]) aligned to the input
    steps, as ``tf.nn.bidirectional_dynamic_rnn``: the backward output at
    step t has consumed x[t:], so outputs[:, -1] holds the forward pass
    after the whole sequence and the backward pass after the last frame."""

    def __init__(self, input_size: int, features: int,
                 forget_bias: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fw = LSTM(input_size, features, forget_bias, generator)
        self.bw = LSTM(input_size, features, forget_bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fw, _ = self.fw(x)
        bw, _ = self.bw(x.flip(1))
        return torch.cat([fw, bw.flip(1)], dim=-1)
