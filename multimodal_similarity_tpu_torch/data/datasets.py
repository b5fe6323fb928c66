"""On-disk dataset contract.

The reference layout:
  DATA_ROOT/features/<session><suffix>.npy      per-frame features
  DATA_ROOT/labels/<session>_{goal,stimuli}.pkl  {'label': ..., 's': RLE
      segment boundaries, 'G': per-segment raw labels}
Event slicing drops events shorter than MIN_LENGTH (background shorter than
MIN_LENGTH_BACKGROUND), caps them at MAX_LENGTH frames, and optionally
applies the 11->7 label transfer.  This is the NumPy path of the JAX
package's ``data/datasets.py``; its native gather fast path is not ported.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_similarity_tpu_torch.data.honda import (
    LABEL_TRANSFER,
    MAX_LENGTH,
    MIN_LENGTH,
    MIN_LENGTH_BACKGROUND,
    MODALITY_SUFFIX,
)


def modality_suffix(feat: str) -> str:
    if feat not in MODALITY_SUFFIX:
        raise NotImplementedError(f"unknown modality: {feat}")
    return MODALITY_SUFFIX[feat]


def prepare_dataset(data_dir: str, sessions: Sequence[str], feat: str,
                    label_dir: Optional[str] = None,
                    label_type: str = "goal") -> List[Tuple[str, str]]:
    """session ids -> [(feat_path, label_path)]."""
    appendix = modality_suffix(feat)
    return [(os.path.join(data_dir, sess + appendix),
             os.path.join(label_dir, f"{sess}_{label_type}.pkl"))
            for sess in sessions]


def prepare_multimodal_dataset(data_dir: str, sessions: Sequence[str],
                               feat_list: Sequence[str],
                               label_dir: Optional[str] = None,
                               label_type: str = "goal") -> List[List[str]]:
    """session ids -> [[feat_path per modality ..., label_path]]."""
    return [[os.path.join(data_dir, sess + modality_suffix(feat))
             for feat in feat_list]
            + [os.path.join(label_dir, f"{sess}_{label_type}.pkl")]
            for sess in sessions]


def load_data_and_label(
    feat_path: str,
    label_path: str,
    preprocess_func: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    transfer: bool = True,
):
    """Load one session and slice per-event windows.

    Returns (events [N, ...], labels [N, 1] int32, boundaries [(s, e)]).
    ``preprocess_func`` maps a [length, ...] frame window to a [1, ...] model
    input (e.g. TSN segment sampling).
    """
    if preprocess_func is None:
        preprocess_func = lambda x: x  # noqa: E731

    feats = np.load(feat_path, mmap_mode="r")
    with open(label_path, "rb") as f:
        label = pickle.load(f)

    events, labels, boundary = [], [], []
    for i in range(len(label["G"])):
        length = label["s"][i + 1] - label["s"][i]
        if length > MIN_LENGTH:
            if label["G"][i] == 0 and length < MIN_LENGTH_BACKGROUND:
                continue
            length = min(length, MAX_LENGTH)
            window = np.asarray(feats[label["s"][i]: label["s"][i] + length])
            events.append(preprocess_func(window))
            labels.append(LABEL_TRANSFER[label["G"][i]] if transfer
                          else label["G"][i])
            boundary.append((label["s"][i], label["s"][i] + length))

    if not events:
        raise ValueError(
            f"no event in session {feat_path!r} survives the length "
            f"filters (MIN_LENGTH={MIN_LENGTH}, MIN_LENGTH_BACKGROUND="
            f"{MIN_LENGTH_BACKGROUND}); {len(label['G'])} raw segments")
    events = np.concatenate(events, axis=0).astype("float32")
    labels = np.asarray(labels, dtype="int32").reshape(-1, 1)
    return events, labels, boundary


def load_validation_set(dataset, preprocess_func=None, transfer: bool = True):
    """Concatenate every session of a prepared dataset.

    Returns (feats, labels, session_ids, boundaries)."""
    feats, labels, sess, boundaries = [], [], [], []
    for row in dataset:
        session_id = os.path.basename(row[-1]).split("_")[0]
        eve, lab, bou = load_data_and_label(row[0], row[-1], preprocess_func,
                                            transfer)
        feats.append(eve)
        labels.append(lab)
        sess.extend([session_id] * eve.shape[0])
        boundaries.extend(bou)
    return (np.concatenate(feats, axis=0), np.concatenate(labels, axis=0),
            sess, boundaries)
