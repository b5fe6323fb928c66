"""Plain exact top-k retrieval, and the rows it is asked about.

``make_rows`` draws the gallery and the query pool from a seed on the
device: unit rows around class centres.  ``ReferenceTopK`` answers the
same queries exactly in float64 (or, as the control, with TF32 products)
and measures how far a returned answer lies from the exact one."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import tf32

# gallery rows a block of the exact product
_CHUNK = 65536


def make_rows(seed: int, n: int, classes: int, d: int, noise_norm: float,
              pool_calls: int, q: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(gallery [n, d], query pool [pool_calls, q, d]) of f32 unit rows: a
    class centre (a unit row) plus noise of norm about ``noise_norm``,
    normalised; every row's class drawn uniformly."""
    g = torch.Generator(device=device).manual_seed(seed)
    centres = F.normalize(torch.randn(classes, d, generator=g,
                                      device=device), dim=1)

    def draw(m):
        cls = torch.randint(classes, (m,), generator=g, device=device)
        noise = torch.randn(m, d, generator=g, device=device)
        return F.normalize(centres[cls] + noise * (noise_norm / d ** 0.5),
                           dim=1)

    gallery = draw(n)
    return gallery, draw(pool_calls * q).reshape(pool_calls, q, d)


def topk_rows(gallery: torch.Tensor, queries: torch.Tensor, k: int,
              control: bool = False):
    """(distances [Q, k], rows [Q, k]) ascending, squared euclidean: exact
    in float64, or with ``control`` the f32 Gram expansion on TF32
    products."""
    if control:
        q = queries.float()
        qs = (q * q).sum(1, keepdim=True)
        qt = tf32(q)
    else:
        q = queries.double()
        qs = (q * q).sum(1, keepdim=True)
    best_d = best_i = None
    for start in range(0, gallery.shape[0], _CHUNK):
        g = gallery[start:start + _CHUNK]
        if control:
            g = g.float()
            d = qs + (g * g).sum(1)[None, :] - 2.0 * (qt @ tf32(g).T)
        else:
            g = g.double()
            d = qs + (g * g).sum(1)[None, :] - 2.0 * (q @ g.T)
        d = torch.clamp(d, min=0.0)
        vals, cols = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cols = cols + start
        if best_d is None:
            best_d, best_i = vals, cols
        else:
            both_d = torch.cat([best_d, vals], 1)
            both_i = torch.cat([best_i, cols], 1)
            best_d, pos = torch.topk(both_d, k, dim=1, largest=False)
            best_i = both_i.gather(1, pos)
    order = torch.argsort(best_d, dim=1, stable=True)
    return best_d.gather(1, order), best_i.gather(1, order)


class ReferenceTopK:
    """The exact answers to batches of the query pool, worked out when
    first asked for."""

    def __init__(self, gallery: torch.Tensor, pool: torch.Tensor, k: int):
        self.gallery, self.pool, self.k = gallery, pool, k
        self._exact = {}

    def exact(self, pool_i: int):
        if pool_i not in self._exact:
            d, _ = topk_rows(self.gallery, self.pool[pool_i], self.k)
            self._exact[pool_i] = d
        return self._exact[pool_i]

    def control(self, pool_i: int):
        """The reference's own answer with TF32 products, as host arrays
        in the program's form."""
        d, i = topk_rows(self.gallery, self.pool[pool_i], self.k,
                         control=True)
        return d.float().cpu().numpy(), i.cpu().numpy()

    def gaps(self, pool_i: int, d: np.ndarray, idx: np.ndarray) -> dict:
        """``topk_gap``: the widest |returned distance - exact distance of
        the same rank|; ``index_gap``: the widest |returned distance -
        exact distance of the row returned with it| (inf for a row that is
        not in the gallery)."""
        want = self.exact(pool_i)
        dev = want.device
        got_d = torch.as_tensor(np.asarray(d), device=dev).double()
        got_i = torch.as_tensor(np.asarray(idx), device=dev).long()
        if got_d.shape != want.shape or got_i.shape != want.shape:
            return {"topk_gap": float("inf"), "index_gap": float("inf")}
        topk_gap = float((got_d - want).abs().max())
        n = self.gallery.shape[0]
        if bool(((got_i < 0) | (got_i >= n)).any()):
            return {"topk_gap": topk_gap, "index_gap": float("inf")}
        q = self.pool[pool_i].double()
        rows = self.gallery[got_i.reshape(-1)].double().reshape(
            got_i.shape + (q.shape[1],))
        true = ((q[:, None, :] - rows) ** 2).sum(-1)
        return {"topk_gap": topk_gap,
                "index_gap": float((got_d - true).abs().max())}
