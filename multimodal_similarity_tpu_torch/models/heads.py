"""Pairwise similarity heads.

``PDDM`` is the Position-Dependent Deep Metric unit ("Local
Similarity-Aware Deep Feature Embedding"): u = |x_i - x_j| and v = (x_i +
x_j) / 2, each through an FC layer, relu and an l2 normalisation; their
concatenation through one more FC layer and relu into a 2-way score.  Its
layers keep the flax names ``score/u``, ``score/v``, ``score/c`` and
``score/s``, so ``convert.py`` maps them by name.  PairSim, PairSim2 and
the all-pairs scorers are not ported yet (ROADMAP slice 5).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_similarity_tpu_torch.models.encoders import dense


def _l2_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps)), the floor on the
    # squared SUM, so a near-zero vector (the u branch of a self-pair)
    # stays near zero instead of growing to unit norm
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


class PDDMScore(nn.Module):
    """The PDDM layers, called on pre-split [B, n_input] rows: (logits [B,
    2], prob [B, 2])."""

    def __init__(self, n_input: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.u = dense(n_input, n_input, generator)
        self.v = dense(n_input, n_input, generator)
        self.c = dense(2 * n_input, n_input, generator)
        self.s = dense(n_input, 2, generator)

    def forward(self, x_i: torch.Tensor, x_j: torch.Tensor):
        uu = _l2_normalize(torch.relu(self.u(torch.abs(x_i - x_j))))
        vv = _l2_normalize(torch.relu(self.v(0.5 * (x_i + x_j))))
        c = torch.relu(self.c(torch.cat([uu, vv], dim=-1)))
        logits = self.s(c)
        return logits, torch.softmax(logits, dim=-1)


class PDDM(nn.Module):
    """Pair head: ``score(x_i, x_j)`` on pre-split rows and ``forward(x)``
    on [B, 2, n_input] pairs, each returning (logits [B, 2], prob [B, 2]);
    prob[:, 1] is the similarity confidence.  ``score`` is the submodule
    that holds the layers, as the flax ``score`` method's name scope holds
    them (params ``score/u``, ...)."""

    def __init__(self, n_input: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.score = PDDMScore(n_input, generator)

    def forward(self, x: torch.Tensor):
        return self.score(x[:, 0], x[:, 1])
