"""Faults planted underneath a run's timed path, for the tests that see
``correct`` come out false and for the calibration of the limits on the
card.  ``plant(kind, fault)`` patches the program in this process and
returns the function that takes the patch out again.

Kinds: ``train_cached``, ``retrieval``, ``extract`` (``perfbench/kinds/``).
Faults: ``unchanged`` (a step that returns its state unchanged; training
only), ``half_batch`` (half of the batch left out, the rest standing for
it) and ``altered`` (an answer altered where it is produced).  A cell on
one chip has no exchange between chips to leave out."""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

FAULTS = {"train_cached": ("unchanged", "half_batch", "altered"),
          "retrieval": ("half_batch", "altered"),
          "extract": ("half_batch", "altered")}


def _patch(obj, name, new) -> Tuple[object, str, object]:
    old = getattr(obj, name)
    setattr(obj, name, new)
    return obj, name, old


def plant(kind: str, fault: str) -> Callable[[], None]:
    if fault not in FAULTS.get(kind, ()):
        raise ValueError(f"no fault {fault!r} for {kind!r}")
    undo: List[Tuple[object, str, object]] = []
    if kind == "train_cached":
        from multimodal_similarity_tpu_torch.data.device_cache import (
            DeviceFeatureCache)
        from multimodal_similarity_tpu_torch.train.trainers import (
            multimodal_model as mm)
        apply = mm.apply_gradients
        if fault == "unchanged":
            undo.append(_patch(mm, "apply_gradients", lambda opt, lr: None))
        elif fault == "altered":
            def doubled(opt, lr):
                # the gradient of the trained leaves' last bias (the core
                # LSTM's) doubled before the update
                biases = [p for g in opt.param_groups for p in g["params"]
                          if p.grad is not None and p.ndim == 1]
                biases[-1].grad.mul_(2.0)
                apply(opt, lr)
            undo.append(_patch(mm, "apply_gradients", doubled))
        else:
            gather = DeviceFeatureCache.gather

            def halved(self, packed, generator, rows=None):
                out, labels, mask = gather(self, packed, generator, rows)
                keep = torch.ones_like(mask)
                keep[mask.shape[0] // 2:] = 0.0
                return out, labels * keep.to(labels.dtype), mask * keep
            undo.append(_patch(DeviceFeatureCache, "gather", halved))
    elif kind == "retrieval":
        from multimodal_similarity_tpu_torch.serving import RetrievalIndex
        query = RetrievalIndex.query

        def faulty(self, queries, k=10):
            if fault == "half_batch":
                half = queries.shape[0] // 2
                d, i, m = query(self, queries[:half], k)
                rest = queries.shape[0] - half
                return _tile(d, rest), _tile(i, rest), m + m[:rest]
            d, i, m = query(self, queries, k)
            i = i.copy()
            i[0, 0] = (i[0, 0] + 1) % len(self)
            return d, i, m
        undo.append(_patch(RetrievalIndex, "query", faulty))
    else:
        from multimodal_similarity_tpu_torch.preprocess import features
        slim = features.slim_backbone

        def faulty_backbone(*a, **kw):
            embed = slim(*a, **kw)

            def faulty(batch):
                if fault == "half_batch":
                    half = batch.shape[0] // 2
                    out = embed(batch[:half])
                    return _tile(out, batch.shape[0] - half)
                out = embed(batch).copy()
                out[0, 0, 0, 0] += 1.0
                return out
            faulty.model = embed.model
            return faulty
        undo.append(_patch(features, "slim_backbone", faulty_backbone))

    def remove():
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)
    return remove


def _tile(first, rest):
    """``first`` followed by its first ``rest`` rows again: the left-out
    rows answered by the others'."""
    import numpy as np
    return np.concatenate([first, first[:rest]])
