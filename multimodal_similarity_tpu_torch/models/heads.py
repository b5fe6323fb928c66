"""Pairwise similarity heads and the all-pairs scorers.

Each head maps a pair of embeddings to a 2-way similar / dissimilar
distribution, (logits [B, 2], prob [B, 2]); prob[:, 1] is the similarity
confidence.  ``score(x_i, x_j)`` takes pre-split [B, n_input] rows and
``forward(x)`` [B, 2, n_input] pairs.  ``score`` is the submodule that
holds the layers, as the flax ``score`` method's name scope holds them, so
``convert.py`` maps ``score/<layer>`` by name:

* ``PairSim``: the concatenated pair through dropout, an FC layer
  (``score/pairwise``), relu, dropout and the 2-way FC (``score/out``);
* ``PairSim2``: the squared difference through ``score/pairwise``, relu,
  dropout and ``score/out``;
* ``PDDM``, the Position-Dependent Deep Metric unit ("Local
  Similarity-Aware Deep Feature Embedding"): u = |x_i - x_j| and v = (x_i +
  x_j) / 2, each through an FC layer (``score/u``, ``score/v``), relu and an
  l2 normalisation; their concatenation through ``score/c`` and relu into
  the 2-way ``score/s``.

Dropout draws its masks from an explicit generator on the inputs' device
and is active in training mode only.

``score_all_pairs``, ``score_rows`` and ``score_all_pairs_sym`` batch a
head over every pair, selected rows, or the upper-triangle tile pairs of a
swap-invariant head, each head call holding at most about
``_CHUNK_ELEMS`` elements in a [pairs, d] temporary.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch.models.encoders import Dropout, dense

ScoreFn = Callable[[torch.Tensor, torch.Tensor],
                   "tuple[torch.Tensor, torch.Tensor]"]

# elements of one [pairs, d] temporary a head call: 32 MB in f32
_CHUNK_ELEMS = 1 << 23


def _l2_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps)), the floor on the
    # squared SUM, so a near-zero vector (the u branch of a self-pair)
    # stays near zero instead of growing to unit norm
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


class PairSimScore(nn.Module):
    """The PairSim layers on pre-split [B, n_input] rows."""

    def __init__(self, n_input: int = 128, keep_prob: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.pairwise = dense(2 * n_input, n_input, generator)
        self.out = dense(n_input, 2, generator)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor):
        h = self.dropout(torch.cat([x_a, x_b], dim=-1))
        h = self.dropout(torch.relu(self.pairwise(h)))
        logits = self.out(h)
        return logits, torch.softmax(logits, dim=-1)


class PairSim2Score(nn.Module):
    """The PairSim2 layers on pre-split [B, n_input] rows."""

    def __init__(self, n_input: int = 128, keep_prob: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pairwise = dense(n_input, n_input, generator)
        self.dropout = Dropout(1.0 - keep_prob, dropout_generator)
        self.out = dense(n_input, 2, generator)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor):
        h = torch.relu(self.pairwise(torch.square(x_a - x_b)))
        logits = self.out(self.dropout(h))
        return logits, torch.softmax(logits, dim=-1)


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


class _PairHead(nn.Module):
    """``score(x_i, x_j)`` on pre-split rows, ``forward(x)`` on [B, 2,
    n_input] pairs."""

    score: nn.Module

    def forward(self, x: torch.Tensor):
        return self.score(x[:, 0], x[:, 1])


class PairSim(_PairHead):
    """Concat-pair MLP -> 2-way softmax; not swap-invariant."""

    def __init__(self, n_input: int = 128, keep_prob: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.score = PairSimScore(n_input, keep_prob, generator,
                                  dropout_generator)


class PairSim2(_PairHead):
    """Squared-difference MLP -> 2-way softmax; swap-invariant."""

    def __init__(self, n_input: int = 128, keep_prob: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.score = PairSim2Score(n_input, keep_prob, generator,
                                   dropout_generator)


class PDDM(_PairHead):
    """The PDDM unit; swap-invariant, no dropout."""

    def __init__(self, n_input: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.score = PDDMScore(n_input, generator)


def _similarity(score_fn: ScoreFn, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return score_fn(a, b)[1][:, 1]


def score_all_pairs(score_fn: ScoreFn, embeddings: torch.Tensor,
                    block: int = 128) -> torch.Tensor:
    """[N, d] -> [N, N] similarity probabilities prob[:, 1] of
    ``score_fn(a, b)`` (a head's ``score``) for every ordered pair (row i,
    column j): up to ``block`` rows against all N columns a head call."""
    n, d = embeddings.shape
    rows = max(1, min(block, _CHUNK_ELEMS // max(n * d, 1)))
    out = []
    for r0 in range(0, n, rows):
        a = embeddings[r0:r0 + rows]
        out.append(_similarity(score_fn, a.repeat_interleave(n, dim=0),
                               embeddings.repeat(a.shape[0], 1))
                   .reshape(a.shape[0], n))
    return torch.cat(out, dim=0)


def score_rows(score_fn: ScoreFn, embeddings: torch.Tensor,
               rows: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Similarity probabilities of the selected ``rows`` ([H] indices)
    against every row: [H, N], in column strips of up to ``block``."""
    n, d = embeddings.shape
    a = embeddings[rows]
    h = a.shape[0]
    width = max(1, min(block, n, _CHUNK_ELEMS // max(h * d, 1)))
    out = []
    for c0 in range(0, n, width):
        b = embeddings[c0:c0 + width]
        out.append(_similarity(score_fn, a.repeat_interleave(b.shape[0],
                                                             dim=0),
                               b.repeat(h, 1)).reshape(h, b.shape[0]))
    return torch.cat(out, dim=1)


def score_all_pairs_sym(score_fn: ScoreFn, embeddings: torch.Tensor,
                        block: int = 128) -> torch.Tensor:
    """:func:`score_all_pairs` for swap-invariant heads (PDDM, PairSim2:
    score(a, b) == score(b, a)), with half the head evaluations.

    The rows, zero-padded to whole ``block``-row tiles, are scored only for
    the T(T+1)/2 upper-triangle tile pairs; each lower tile is its mirror's
    transpose, and a diagonal tile is kept as scored.  Not valid for
    PairSim, whose concatenation order matters."""
    n, d = embeddings.shape
    nb = -(-n // block)
    tiles = torch.zeros((nb * block, d), dtype=embeddings.dtype,
                        device=embeddings.device)
    tiles[:n] = embeddings
    tiles = tiles.reshape(nb, block, d)
    ti_np, tj_np = np.triu_indices(nb)
    off_np = np.flatnonzero(ti_np != tj_np)
    ti, tj, off = (torch.from_numpy(t).to(embeddings.device)
                   for t in (ti_np, tj_np, off_np))
    per_call = max(1, _CHUNK_ELEMS // (block * block * d))
    sims = []
    for p0 in range(0, ti.shape[0], per_call):
        a = tiles[ti[p0:p0 + per_call]]                     # [k, B, d]
        b = tiles[tj[p0:p0 + per_call]]
        k = a.shape[0]
        aa = a[:, :, None, :].expand(k, block, block, d).reshape(-1, d)
        bb = b[:, None, :, :].expand(k, block, block, d).reshape(-1, d)
        sims.append(_similarity(score_fn, aa, bb).reshape(k, block, block))
    sims = torch.cat(sims, dim=0)
    out = torch.zeros((nb, nb, block, block), dtype=sims.dtype,
                      device=sims.device)
    out[tj[off], ti[off]] = sims[off].transpose(1, 2)
    out[ti, tj] = sims
    return out.permute(0, 2, 1, 3).reshape(nb * block, nb * block)[:n, :n]
