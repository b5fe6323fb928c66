"""TSN segment sampling on the host (NumPy).

Train time draws one random frame per segment; test time takes each
segment's centre frame.  ``mean_pool_input`` pools a whole window instead
(the cross-prediction trainer's regression target).
"""

from __future__ import annotations

import numpy as np


def tsn_prepare_input(n_seg: int, feat: np.ndarray,
                      rng: np.random.RandomState | None = None) -> np.ndarray:
    """Random per-segment frame sampling (train time).

    feat -- [time_steps, ...]; returns [1, n_seg, ...]."""
    randint = (rng.randint if rng is not None else np.random.randint)
    average_duration = feat.shape[0] // n_seg
    if average_duration <= 0:
        raise NotImplementedError(
            f"sequence of {feat.shape[0]} frames too short for {n_seg} segments")
    offsets = np.multiply(range(n_seg), average_duration) + \
        randint(average_duration, size=n_seg)
    return np.expand_dims(feat[offsets].astype("float32"), 0)


def tsn_prepare_input_test(n_seg: int, feat: np.ndarray) -> np.ndarray:
    """Centre-frame sampling (test time)."""
    average_duration = feat.shape[0] // n_seg
    offsets = np.array([int(average_duration / 2.0 + average_duration * x)
                        for x in range(n_seg)])
    return np.expand_dims(feat[offsets].astype("float32"), 0)


def mean_pool_input(feat: np.ndarray, flatten: bool = True) -> np.ndarray:
    """Mean over the time axis: [time_steps, ...] -> [1, D] (flattened) or
    [1, ...]."""
    new_feat = np.mean(feat, axis=0)
    if flatten:
        new_feat = new_feat.flatten()
    return np.expand_dims(new_feat, 0)
