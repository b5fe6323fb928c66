"""K-means on the run's device, in float64.

The clustering step of the unsupervised pretrain chain
(``train/trainers/unimodal_pretrain_cluster.py``) used scikit-learn's
``KMeans``; the port carries its own, with the same algorithm and the same
meaning of its results:

* greedy k-means++ seeding (the first centre uniform, then for each next
  centre ``2 + int(log k)`` candidates drawn in proportion to the squared
  distance to the nearest chosen centre, keeping the candidate that
  lowers the potential most), from an explicit ``torch.Generator``;
* Lloyd iterations until the labels stop changing, or the squared shift
  of the centres falls to ``TOL`` times the mean per-feature variance, or
  ``MAX_ITER``; an empty cluster takes the point farthest from its centre;
  then, unless the labels had converged, one more assignment;
* ``n_init`` runs, the lowest inertia (sum of squared distances to the
  assigned centres) kept;
* ``predict``: the nearest centre; ``transform``: the Euclidean distance to
  each centre.

The random stream is torch's, not NumPy's, so the clusters equal
scikit-learn's only up to relabelling and where the data leave one good
partition.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

MAX_ITER = 300
TOL = 1e-4  # of the mean per-feature variance, on the centres' shift


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, K] squared Euclidean distances |x|^2 - 2 x.c + |c|^2, floored at
    0 (float64, as scikit-learn upcasts float32 rows for them)."""
    d = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ c.T)
         + (c * c).sum(1)[None, :])
    return d.clamp_(min=0.0)


class KMeans:
    """``KMeans(n_clusters, n_init, ...).fit(x)``; then ``cluster_centers_``
    [K, D] and ``inertia_`` (NumPy), ``labels_``, ``n_iter_``."""

    def __init__(self, n_clusters: int = 8, n_init: int = 10,
                 seed: int = 0, device=None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.seed = seed
        self.device = torch.device(device or "cpu")
        self.cluster_centers_: Optional[np.ndarray] = None
        self.inertia_: Optional[float] = None

    def _plusplus(self, x: torch.Tensor, gen: torch.Generator
                  ) -> torch.Tensor:
        n, k = x.shape[0], self.n_clusters
        trials = 2 + int(math.log(k))
        first = int(torch.randint(n, (1,), generator=gen,
                                  device=self.device))
        centers = [x[first]]
        closest = _sq_dists(x, x[first:first + 1])[:, 0]
        pot = closest.sum()
        for _ in range(1, k):
            vals = torch.rand(trials, generator=gen, device=self.device,
                              dtype=x.dtype) * pot
            ids = torch.searchsorted(torch.cumsum(closest, 0), vals)
            ids = ids.clamp(max=n - 1)
            cand = torch.minimum(closest[None, :],
                                 _sq_dists(x, x[ids]).T)     # [trials, N]
            cand_pot = cand.sum(dim=1)
            best = int(torch.argmin(cand_pot))
            pot, closest = cand_pot[best], cand[best]
            centers.append(x[ids[best]])
        return torch.stack(centers)

    def _update(self, x: torch.Tensor, labels: torch.Tensor,
                dists: torch.Tensor) -> torch.Tensor:
        """The means of the assigned points; an empty cluster takes the
        points farthest from their centres, in that order."""
        k, d = self.n_clusters, x.shape[1]
        sums = torch.zeros(k, d, dtype=x.dtype, device=x.device)
        sums.index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        empty = torch.nonzero(counts == 0).flatten().tolist()
        if empty:
            own = dists.gather(1, labels[:, None])[:, 0]
            far = torch.topk(own, len(empty)).indices.tolist()
            for cid, idx in zip(empty, far):
                old = int(labels[idx])
                sums[old] -= x[idx]
                counts[old] -= 1
                sums[cid] = x[idx]
                counts[cid] = 1
        return sums / counts[:, None]

    def _lloyd(self, x: torch.Tensor, centers: torch.Tensor, tol: float):
        labels_old = None
        strict = False
        for it in range(1, MAX_ITER + 1):
            dists = _sq_dists(x, centers)
            labels = torch.argmin(dists, dim=1)
            new = self._update(x, labels, dists)
            shift = float(((new - centers) ** 2).sum())
            centers = new
            if labels_old is not None and torch.equal(labels, labels_old):
                strict = True
                break
            if shift <= tol:
                break
            labels_old = labels
        if not strict:
            labels = torch.argmin(_sq_dists(x, centers), dim=1)
        inertia = float(_sq_dists(x, centers).gather(
            1, labels[:, None]).sum())
        return centers, labels, inertia, it

    def fit(self, x) -> "KMeans":
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"{x.shape[0]} samples < n_clusters="
                             f"{self.n_clusters}")
        tol = float(x.var(dim=0, unbiased=False).mean()) * TOL
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        best = None
        for _ in range(self.n_init):
            run = self._lloyd(x, self._plusplus(x, gen), tol)
            if best is None or run[2] < best[2]:
                best = run
        centers, labels, inertia, n_iter = best
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = labels.cpu().numpy()
        self.inertia_ = inertia
        self.n_iter_ = n_iter
        return self

    def _centers(self) -> torch.Tensor:
        if self.cluster_centers_ is None:
            raise ValueError("KMeans is not fitted")
        return torch.as_tensor(self.cluster_centers_, dtype=torch.float64,
                               device=self.device)

    def predict(self, x) -> np.ndarray:
        """The index of each row's nearest centre."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        return torch.argmin(_sq_dists(x, self._centers()),
                            dim=1).cpu().numpy()

    def transform(self, x) -> np.ndarray:
        """[N, K] Euclidean distances of each row to each centre."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        return torch.sqrt(_sq_dists(x, self._centers())).cpu().numpy()

    def state(self) -> dict:
        """The fitted model as plain values: what ``kmeans_model.pkl``
        holds."""
        return {"cluster_centers": self.cluster_centers_,
                "inertia": self.inertia_, "n_clusters": self.n_clusters,
                "n_init": self.n_init, "seed": self.seed,
                "n_iter": self.n_iter_}
