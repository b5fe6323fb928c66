"""On-disk dataset contract.

The reference layout:
  DATA_ROOT/features/<session><suffix>.npy      per-frame features
  DATA_ROOT/labels/<session>_{goal,stimuli}.pkl  {'label': ..., 's': RLE
      segment boundaries, 'G': per-segment raw labels}
Event slicing drops events shorter than MIN_LENGTH (background shorter than
MIN_LENGTH_BACKGROUND), caps them at MAX_LENGTH frames, and optionally
applies the 11->7 label transfer.  A session sampled by a TSN prepare
function takes the native gather (``data/native.py``): the same offsets,
drawn in the same order, and only the sampled frames copied; any other
session takes the per-event Python loop.
"""

from __future__ import annotations

import functools
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
from multimodal_similarity_tpu_torch.data import native
from multimodal_similarity_tpu_torch.data import tsn as _tsn
from multimodal_similarity_tpu_torch.utils.profiling import count


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


def _tsn_sampling_plan(preprocess_func):
    """A TSN prepare function -> (n_seg, randint, is_test), or None for
    any other.

    The trainers and loaders bind ``tsn_prepare_input`` and
    ``tsn_prepare_input_test`` through ``functools.partial`` chains
    (``n_seg`` first, then the loader's ``rng=``); they are unwrapped here,
    the outer binding winning a keyword as a call would."""
    func, n_seg, kw = preprocess_func, None, {}
    while isinstance(func, functools.partial):
        for k, v in (func.keywords or {}).items():
            kw.setdefault(k, v)
        if func.args:
            n_seg = func.args[0]
        func = func.func
    if n_seg is None:
        return None
    if func is _tsn.tsn_prepare_input:
        rng = kw.get("rng")
        randint = rng.randint if rng is not None else np.random.randint
        return int(n_seg), randint, False
    if func is _tsn.tsn_prepare_input_test:
        return int(n_seg), None, True
    return None


def _load_events_tsn_native(feats, label, preprocess_func, transfer):
    """The native gather of a TSN-sampled session: each event's ``n_seg``
    sampled frames copied once, straight into the session's array, where
    the Python loop copies and casts them per event, then concatenates and
    casts the session.  Returns
    (events, labels, boundaries) as ``load_data_and_label`` does, or None
    to leave the session to the Python loop.

    Bit-equal to the Python loop: the offsets are drawn from the same
    generator, in the same order per event, and whether the session is
    eligible (a TSN sampler, f32 C-contiguous features) is decided before
    the first draw, so the generator is left in the same state.  A session
    where no event survives is left to the loop, which raises."""
    plan = _tsn_sampling_plan(preprocess_func)
    if plan is None:
        return None
    if feats.dtype != np.float32 or not feats.flags["C_CONTIGUOUS"]:
        return None
    n_seg, randint, is_test = plan
    native.load_native()  # a failed build raises before any draw

    starts, offsets, labels, boundary = [], [], [], []
    for i in range(len(label["G"])):
        length = label["s"][i + 1] - label["s"][i]
        if length > MIN_LENGTH:
            if label["G"][i] == 0 and length < MIN_LENGTH_BACKGROUND:
                continue
            length = min(length, MAX_LENGTH)
            avg = length // n_seg
            if is_test:
                offs = np.array([int(avg / 2.0 + avg * x)
                                 for x in range(n_seg)], np.int64)
            else:
                if avg <= 0:
                    raise NotImplementedError(
                        f"sequence of {length} frames too short for "
                        f"{n_seg} segments")
                offs = np.multiply(range(n_seg), avg) + \
                    randint(avg, size=n_seg)
            starts.append(int(label["s"][i]))
            offsets.append(offs)
            labels.append(LABEL_TRANSFER[label["G"][i]] if transfer
                          else label["G"][i])
            boundary.append((label["s"][i], label["s"][i] + length))

    if not starts:
        return None
    out = native.native_gather_segments(
        feats.reshape(feats.shape[0], -1), np.asarray(starts, np.int64),
        np.asarray(offsets, np.int64))
    events = out.reshape((len(starts), n_seg) + feats.shape[1:])
    return events, np.asarray(labels, np.int32).reshape(-1, 1), boundary


def load_data_and_label(
    feat_path: str,
    label_path: str,
    preprocess_func: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    transfer: bool = True,
):
    """Load one session and slice per-event windows.

    Returns (events [N, ...], labels [N, 1] int32, boundaries [(s, e)]).
    ``preprocess_func`` maps a [length, ...] frame window to a [1, ...] model
    input (e.g. TSN segment sampling); a TSN sampler's sessions take the
    native gather, counted as ``native.gather``.
    """
    if preprocess_func is None:
        preprocess_func = lambda x: x  # noqa: E731

    feats = np.load(feat_path, mmap_mode="r")
    with open(label_path, "rb") as f:
        label = pickle.load(f)

    fast = _load_events_tsn_native(feats, label, preprocess_func, transfer)
    if fast is not None:
        count("native.gather")
        return fast
    count("native.gather_deferred")

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
