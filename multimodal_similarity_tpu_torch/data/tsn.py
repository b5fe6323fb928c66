"""Input preparation on the host (NumPy): TSN segment sampling and
fixed-length padding.

Train time draws one random frame per segment; test time takes each
segment's centre frame.  ``rnn_prepare_input`` zero-pads or truncates a
window to a fixed frame count (the ConvLSTM input), and
``mean_pool_input`` pools a whole window (the cross-prediction trainer's
regression target; with ``max_pool_input``, the no-model baseline's
features).  ``tsn_sample_offsets`` and ``tsn_center_offsets`` are the
device versions the feature cache (data/device_cache.py) gathers with: the
frame index of each segment as a tensor, from uniforms drawn by
``draw_tsn_uniforms``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Device versions
# ---------------------------------------------------------------------------

def draw_tsn_uniforms(generator: torch.Generator, b: int, n_seg: int,
                      device) -> torch.Tensor:
    """[b, n_seg] f32 uniforms in [0, 1) for one TSN draw.  Every device
    TSN draw goes through here, so a test can replay another package's
    stream in its place."""
    return torch.rand((b, n_seg), generator=generator, device=device)


def tsn_sample_offsets(generator: torch.Generator, seq_len: torch.Tensor,
                       n_seg: int,
                       rows: Optional[Tuple[int, slice]] = None
                       ) -> torch.Tensor:
    """Per-event random TSN offsets on the device.

    seq_len -- [B] true frame counts; returns [B, n_seg] int64 frame indices
    (segment start + the uniform's share of the segment, truncated),
    clamped to the last frame: the host sampler's scheme for seq_len >=
    n_seg.  ``rows`` = (b, sl): ``seq_len`` holds rows ``sl`` of a batch of
    ``b`` rows, and the uniforms are drawn for the whole batch and those
    rows kept (a data-parallel rank draws what one device would)."""
    if rows is None:
        u = draw_tsn_uniforms(generator, seq_len.shape[0], n_seg,
                              seq_len.device)
    else:
        u = draw_tsn_uniforms(generator, rows[0], n_seg,
                              seq_len.device)[rows[1]]
    avg = torch.clamp(seq_len // n_seg, min=1)
    base = torch.arange(n_seg, device=seq_len.device)[None, :] * avg[:, None]
    offs = (u * avg[:, None].to(torch.float32)).to(torch.int32)
    return torch.minimum(base + offs, (seq_len - 1)[:, None]).long()


def tsn_center_offsets(seq_len: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Deterministic centre-frame offsets on the device (test time).  No
    path of the port calls it yet; its tests hold it to the JAX
    function."""
    avg = torch.clamp(seq_len // n_seg, min=1)
    base = torch.arange(n_seg, device=seq_len.device)[None, :] * avg[:, None]
    return torch.minimum(base + avg[:, None] // 2,
                         (seq_len - 1)[:, None]).long()
