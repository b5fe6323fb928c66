"""CUB-200-2011 track data (NumPy only; a copy of the JAX package's
``data/cub.py``).

On-disk contract:
  <data_dir>/feat_train.npy  [N, 1024]  GoogLeNet/Inception features
  <data_dir>/feat_test.npy
  <data_dir>/label_train.npy [N]        1-indexed class ids
  <data_dir>/label_test.npy
  <data_dir>/att_train.npy   [N, 312]   attribute vectors (optional)
  <data_dir>/att_test.npy

``load_cub`` makes the train labels 0-based and leaves the test labels
1-based, as the reference does.  ``generate_synthetic_cub`` writes the same
contract with class-correlated features.  ``sample_cub_batch`` draws from
the given ``np.random.RandomState`` in the JAX function's order, so the
same seed gives the same indices.  ``prepare_attribute``:
certainty-weighted attribute vectors from the CUB image_attribute_labels
file (certainty ids {2: 0.5, 3: 0.75, 4: 1.0} scale present attributes).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def load_cub(data_dir: str, attributes: bool = False) -> Dict[str, np.ndarray]:
    out = {
        "feat_train": np.load(os.path.join(data_dir, "feat_train.npy")),
        "feat_test": np.load(os.path.join(data_dir, "feat_test.npy")),
        "label_train": np.load(os.path.join(data_dir, "label_train.npy")),
        "label_test": np.load(os.path.join(data_dir, "label_test.npy")),
    }
    # reference makes train labels 0-based (base_model_CUB.py:165)
    out["label_train"] = np.asarray(out["label_train"]).astype(np.int64) - 1
    out["label_test"] = np.asarray(out["label_test"]).astype(np.int64)
    if attributes:
        out["att_train"] = np.load(os.path.join(data_dir, "att_train.npy"))
        out["att_test"] = np.load(os.path.join(data_dir, "att_test.npy"))
    return out


def generate_synthetic_cub(data_dir: str, n_classes: int = 10,
                           per_class: int = 12, feat_dim: int = 64,
                           att_dim: int = 32, noise: float = 1.0,
                           seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    centers = rng.randn(n_classes, feat_dim)
    att_centers = rng.rand(n_classes, att_dim)

    def split(frac_train=0.5):
        labels = np.repeat(np.arange(1, n_classes + 1), per_class)
        feats = centers[labels - 1] + noise * rng.randn(len(labels), feat_dim)
        atts = np.clip(att_centers[labels - 1]
                       + 0.3 * rng.randn(len(labels), att_dim), 0, 1)
        return feats.astype(np.float32), atts.astype(np.float32), labels

    f_tr, a_tr, l_tr = split()
    f_te, a_te, l_te = split()
    np.save(os.path.join(data_dir, "feat_train.npy"), f_tr)
    np.save(os.path.join(data_dir, "feat_test.npy"), f_te)
    np.save(os.path.join(data_dir, "label_train.npy"), l_tr)
    np.save(os.path.join(data_dir, "label_test.npy"), l_te)
    np.save(os.path.join(data_dir, "att_train.npy"), a_tr)
    np.save(os.path.join(data_dir, "att_test.npy"), a_te)
    return load_cub(data_dir, attributes=True)


def sample_cub_batch(class_idx_dict: Dict[int, list], batch_size: int,
                     rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Class-balanced batch: sample classes, 5-10 images each, truncate to
    batch_size (reference base_model_CUB.py:251-261)."""
    rng = rng or np.random
    class_in_batch = set()
    idx_batch = np.array([], dtype=np.int32)
    keys = list(class_idx_dict.keys())
    while len(idx_batch) < batch_size:
        if len(class_in_batch) == len(keys):
            # fewer classes than the reference's 100: allow re-sampling so
            # small synthetic datasets can still fill a batch
            class_in_batch.clear()
        sampled_class = keys[rng.randint(len(keys))]
        if sampled_class not in class_in_batch:
            class_in_batch.add(sampled_class)
            subsample_size = rng.randint(5, 11)
            subsample = rng.permutation(
                class_idx_dict[sampled_class])[:subsample_size]
            idx_batch = np.append(idx_batch, subsample)
    return idx_batch[:batch_size]


CERTAINTY_WEIGHT = {1: 0.0, 2: 0.5, 3: 0.75, 4: 1.0}


def prepare_attribute(attr_file: str, n_images: int,
                      n_attributes: int = 312) -> np.ndarray:
    """image_attribute_labels.txt -> [n_images, n_attributes] certainty-
    weighted vectors (reference preprocess/prepare_attribute.py:15-42).

    Each line: <image_id> <attribute_id> <is_present> <certainty_id> <time>.
    """
    out = np.zeros((n_images, n_attributes), dtype=np.float32)
    with open(attr_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            img, att, present, certainty = (int(parts[0]), int(parts[1]),
                                            int(parts[2]), int(parts[3]))
            if present:
                out[img - 1, att - 1] = CERTAINTY_WEIGHT.get(certainty, 1.0)
    return out
