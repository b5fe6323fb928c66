"""Synthetic Honda-layout dataset generator.

Writes the exact on-disk contract the loaders consume
(features/<session><suffix>.npy, labels/<session>_goal.pkl with
{'label', 's', 'G'}, session-list txts) with class-correlated features, so
the full pipeline is exercisable without the proprietary HDD-100h data.
Used by tests and the demo/benchmark configs.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from multimodal_similarity_tpu_torch.data.honda import MODALITY_SUFFIX


def generate_synthetic_honda(
    data_root: str,
    n_sessions: int = 6,
    frames_per_session: int = 400,
    modal_dims: Dict[str, Tuple[int, ...]] | None = None,
    n_raw_classes: int = 11,
    class_scale: float = 1.0,
    noise_scale: float = 1.0,
    seed: int = 0,
    splits: Tuple[float, float] = (0.6, 0.2),
    length_range: Tuple[int, int] = (4, 60),
) -> Dict[str, list]:
    """Create a synthetic dataset under ``data_root``.

    modal_dims -- per-frame feature shape per modality, e.g.
        {'resnet': (4, 4, 32), 'sensors': (8,), 'segment': (357,)}.
    splits -- (train_frac, val_frac); remainder is test.
    length_range -- half-open randint bounds for event lengths in frames
        (benchmarks use short events to bound disk size at video dims).
    Returns {'train': [...], 'val': [...], 'test': [...], 'all': [...]}.
    """
    if modal_dims is None:
        modal_dims = {"resnet": (4, 4, 32), "sensors": (8,),
                      "segment": (64,)}
    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(data_root, "features")
    label_dir = os.path.join(data_root, "labels")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    centers = {m: rng.randn(n_raw_classes, int(np.prod(dim))) * class_scale
               for m, dim in modal_dims.items()}

    sessions = [f"2017{i:08d}" for i in range(n_sessions)]
    for sess in sessions:
        # random event segmentation: raw labels 0..10, background-heavy
        boundaries = [0]
        raw_labels = []
        t = 0
        while t < frames_per_session:
            length = int(rng.randint(*length_range))
            length = min(length, frames_per_session - t)
            is_bg = rng.rand() < 0.4
            raw = 0 if is_bg else int(rng.randint(1, n_raw_classes))
            raw_labels.append(raw)
            t += length
            boundaries.append(t)

        frame_labels = np.zeros(frames_per_session, dtype=np.int64)
        for i, raw in enumerate(raw_labels):
            frame_labels[boundaries[i]: boundaries[i + 1]] = raw

        for m, dim in modal_dims.items():
            flat = int(np.prod(dim))
            feats = (centers[m][frame_labels]
                     + noise_scale * rng.randn(frames_per_session, flat))
            feats = feats.reshape((frames_per_session,) + tuple(dim))
            np.save(os.path.join(feat_dir, sess + MODALITY_SUFFIX[m]),
                    feats.astype(np.float32))

        with open(os.path.join(label_dir, f"{sess}_goal.pkl"), "wb") as f:
            pickle.dump({"label": frame_labels,
                         "s": np.asarray(boundaries, dtype=np.int64),
                         "G": np.asarray(raw_labels, dtype=np.int64)}, f)

    n_train = max(1, int(splits[0] * n_sessions))
    n_val = max(1, int(splits[1] * n_sessions))
    out = {
        "all": sessions,
        "train": sessions[:n_train],
        "val": sessions[n_train:n_train + n_val],
        "test": sessions[n_train + n_val:] or sessions[-1:],
    }
    for split, ids in out.items():
        with open(os.path.join(data_root, f"{split}_session.txt"), "w") as f:
            f.write("\n".join(ids))
    return out
