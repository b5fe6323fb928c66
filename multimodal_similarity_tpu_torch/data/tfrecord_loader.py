"""Event-level TFRecord loader.

Reads the one-SequenceExample-per-event files that
``generate_event_tfrecords`` writes, shuffles them with a seeded
``RandomState``, and emits fixed-shape zero-padded batches with the true
sequence lengths (the ConvLSTM input), loaded on a background thread.  A
batch is parsed by the native library's thread pool when every one of its
events parses there; otherwise (a missing key, another frame width, a
corrupt record) the whole batch is parsed in Python, which raises on what
it cannot read.  The counters ``native.parse`` and
``native.parse_deferred`` count the batches of each path.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_similarity_tpu_torch.data import native
from multimodal_similarity_tpu_torch.data.loader import _prefetched
from multimodal_similarity_tpu_torch.data.tfrecords import (
    parse_sequence_example,
    read_tfrecord,
)
from multimodal_similarity_tpu_torch.utils.profiling import count


def list_event_tfrecords(tfrecords_root: str,
                         sessions: Optional[Sequence[str]] = None):
    """The sorted ``*.tfrecords`` paths under ``tfrecords_root``, only those
    of ``sessions`` when given (the file name's prefix before ``_``)."""
    paths = sorted(glob.glob(os.path.join(tfrecords_root, "*.tfrecords")))
    if sessions is not None:
        keep = set(sessions)
        paths = [p for p in paths
                 if os.path.basename(p).split("_")[0] in keep]
    return paths


class EventTFRecordLoader:
    """Yields batches {features [B, max_time, D], seq_len [B], labels [B],
    mask [B], num_events} with background prefetch; the last batch of an
    epoch is padded (``mask`` 0, ``seq_len`` 1)."""

    def __init__(self, paths: Sequence[str], feat_name: str,
                 feat_dim: int, event_per_batch: int = 64,
                 max_time: int = 90, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2):
        self.paths = list(paths)
        self.feat_name = feat_name
        self.feat_dim = feat_dim
        self.event_per_batch = event_per_batch
        self.max_time = max_time
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch

    @property
    def batches_per_epoch(self) -> int:
        return -(-len(self.paths) // self.event_per_batch)

    def _load_event(self, path: str):
        rec = next(iter(read_tfrecord(path)))
        context, feature_lists = parse_sequence_example(rec)
        frames = feature_lists[self.feat_name]          # [T, D]
        t = min(frames.shape[0], self.max_time)
        out = np.zeros((self.max_time, self.feat_dim), np.float32)
        out[:t] = frames[:t, : self.feat_dim]
        return out, t, int(context.get("label", 0))

    def _make_batch(self, paths: List[str]) -> Dict[str, np.ndarray]:
        b = self.event_per_batch
        feats = np.zeros((b, self.max_time, self.feat_dim), np.float32)
        seq_len = np.ones((b,), np.int32)
        labels = np.zeros((b,), np.int32)
        mask = np.zeros((b,), np.float32)
        mask[: len(paths)] = 1.0
        # parsed straight into the batch (a 64-event ConvLSTM batch of
        # 8x8x1536 frames is 2.3 GB); the Python path rewrites every row
        n = len(paths)
        _, _, _, ok = native.native_load_event_batch(
            paths, self.feat_name, self.max_time, self.feat_dim,
            out=(feats[:n], seq_len[:n], labels[:n]))
        if ok == n:
            count("native.parse")
        else:
            count("native.parse_deferred")
            for i, p in enumerate(paths):
                feats[i], seq_len[i], labels[i] = self._load_event(p)
        return {"features": feats, "seq_len": seq_len, "labels": labels,
                "mask": mask, "num_events": len(paths)}

    def epoch(self):
        order = list(self.paths)
        if self.shuffle:
            self.rng.shuffle(order)
        groups = [order[i:i + self.event_per_batch]
                  for i in range(0, len(order), self.event_per_batch)]
        yield from _prefetched(groups, self._make_batch, self.prefetch)
