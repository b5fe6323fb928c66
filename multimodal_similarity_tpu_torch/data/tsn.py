"""Input preparation on the host (NumPy): TSN segment sampling and
fixed-length padding.

Train time draws one random frame per segment; test time takes each
segment's centre frame.  ``rnn_prepare_input`` zero-pads or truncates a
window to a fixed frame count (the ConvLSTM input), and
``mean_pool_input`` pools a whole window (the cross-prediction trainer's
regression target; with ``max_pool_input``, the no-model baseline's
features).
"""

from __future__ import annotations

import functools
from typing import Callable

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


def max_pool_input(feat: np.ndarray, flatten: bool = True) -> np.ndarray:
    """Max over the time axis: [time_steps, ...] -> [1, D] (flattened) or
    [1, ...]."""
    new_feat = np.max(feat, axis=0)
    if flatten:
        new_feat = new_feat.flatten()
    return np.expand_dims(new_feat, 0)


def rnn_prepare_input(max_time: int, feat: np.ndarray) -> np.ndarray:
    """Zero-pad or truncate to ``max_time`` frames: [time_steps, ...] ->
    [1, max_time, ...] f32."""
    new_feat = np.zeros((max_time,) + feat.shape[1:], dtype="float32")
    if feat.shape[0] > max_time:
        new_feat = feat[:max_time].astype("float32")
    else:
        new_feat[: feat.shape[0]] = feat
    return np.expand_dims(new_feat, 0)


def make_prepare_input(network: str, n_seg: int = 3, max_time: int = 90,
                       train: bool = True) -> Callable:
    """The prepare function of a ``--network``: fixed-length padding for
    ``convlstm``, else TSN sampling (random at train time, centre frames
    at test time)."""
    if network == "convlstm":
        return functools.partial(rnn_prepare_input, max_time)
    if train:
        return functools.partial(tsn_prepare_input, n_seg)
    return functools.partial(tsn_prepare_input_test, n_seg)
