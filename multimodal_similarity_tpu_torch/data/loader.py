"""Host-side session loader.

Plain Python + NumPy loading on a background prefetch thread, emitting
fixed-shape batches (event budget + validity mask).  The same seed gives
the same batches as the JAX package's loader, draw for draw.  The
reference's "cap at 1000 events via random permutation" is the
pad-or-subsample to ``event_budget``.
"""

from __future__ import annotations

import functools
import inspect
import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from multimodal_similarity_tpu_torch.data.datasets import load_data_and_label


def _prefetched(items, load_one, prefetch: int):
    """Yield load_one(item) for each item, loaded on a background thread.

    Worker failures re-raise in the consumer; abandoning the generator
    early (exception in the training loop, KeyboardInterrupt) cancels the
    worker instead of leaving it blocked forever on a full queue holding
    large batch arrays.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = object()
    cancel = threading.Event()

    def _put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for it in items:
                if cancel.is_set() or not _put(load_one(it)):
                    return
            _put(stop)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            # surface loader failures in the training thread instead of
            # silently truncating the epoch
            _put(exc)
        finally:
            # an item generator (a nested loader epoch) ends on this
            # thread, which iterated it
            close = getattr(items, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join()


class SessionBatchLoader:
    """Iterates epochs of session groups, yielding padded event batches.

    dataset -- rows of (feat_path, [feat2_path, ...,] label_path); one or
        more modalities per row (prepare_funcs aligned with modalities).
    sess_per_batch -- sessions concatenated per batch (data_io.py:182).
    event_budget -- static event count per batch: longer batches are
        randomly subsampled, shorter ones zero-padded (mask marks real rows).
    prepare_funcs -- per-modality preprocess functions; modality 0's
        function receives an optional ``rng`` kwarg if it accepts one.
    """

    def __init__(
        self,
        dataset: Sequence[Sequence[str]],
        sess_per_batch: int = 3,
        event_budget: int = 1024,
        prepare_funcs: Optional[Sequence[Callable]] = None,
        shuffle: bool = True,
        transfer: bool = True,
        seed: int = 12345,
        prefetch: int = 2,
    ):
        self.dataset = [list(row) for row in dataset]
        if not self.dataset:
            raise ValueError(
                "SessionBatchLoader got an empty dataset (fewer train "
                "sessions than hosts on a sharded run?)")
        # fewer sessions than sess_per_batch would floor batches_per_epoch
        # to zero and every epoch would silently yield nothing (a sharded
        # run can leave a host with a tiny shard); clamp so the remaining
        # sessions form one smaller batch per epoch instead
        self.sess_per_batch = min(sess_per_batch, len(self.dataset))
        self.event_budget = event_budget
        self.num_modalities = len(self.dataset[0]) - 1
        self.rng = np.random.RandomState(seed)
        if prepare_funcs is None:
            prepare_funcs = [None] * self.num_modalities
        self.prepare_funcs = [self._bind_rng(f) for f in prepare_funcs]
        self.shuffle = shuffle
        self.transfer = transfer
        self.prefetch = prefetch

    def _bind_rng(self, func: Optional[Callable]) -> Optional[Callable]:
        """Bind the loader's seeded RNG into prepare functions that accept
        an ``rng`` kwarg (e.g. tsn_prepare_input's per-segment sampling) so
        batch contents are a pure function of the loader seed, not of
        whatever global np.random state the process happens to be in."""
        if func is None:
            return None
        try:
            params = inspect.signature(func).parameters
        except (TypeError, ValueError):
            return func
        if "rng" not in params:
            return func
        return functools.partial(func, rng=self.rng)

    @property
    def batches_per_epoch(self) -> int:
        return len(self.dataset) // self.sess_per_batch

    def _load_group(self, rows: List[List[str]]) -> Dict[str, np.ndarray]:
        events = [[] for _ in range(self.num_modalities)]
        labels: List[np.ndarray] = []
        sess: List[str] = []
        for row in rows:
            label_path = row[-1]
            lab0 = None
            for m in range(self.num_modalities):
                eve, lab, _ = load_data_and_label(
                    row[m], label_path, self.prepare_funcs[m], self.transfer)
                events[m].append(eve)
                if m == 0:
                    lab0 = lab
            labels.append(lab0)
            # strip modality suffixes: <session>_sensors_normalized.npy etc.
            session_id = os.path.basename(row[0]).split(".")[0].split("_")[0]
            sess.extend([session_id] * lab0.shape[0])

        evs = [np.concatenate(e, axis=0) for e in events]
        lab = np.concatenate(labels, axis=0).reshape(-1)
        sess_arr = np.asarray(sess)

        n = lab.shape[0]
        budget = self.event_budget
        # one permutation serves both shuffle and over-budget subsample
        # (base_model.py:249-253): a shuffle followed by a random subsample
        # is distributionally the same draw, and skipping the first
        # full-array copy halves the loader thread's memory traffic
        if n > budget:
            idx = self.rng.permutation(n)[:budget]
        elif self.shuffle:
            idx = self.rng.permutation(n)
        else:
            idx = None
        if idx is not None:
            evs = [e[idx] for e in evs]
            lab = lab[idx]
            sess_arr = sess_arr[idx]
            n = min(n, budget)

        mask = np.zeros(budget, dtype=np.float32)
        mask[:n] = 1.0
        out: Dict[str, np.ndarray] = {
            "labels": np.zeros(budget, dtype=np.int32),
            "mask": mask,
            "num_events": n,
            "sessions": sess_arr,
        }
        out["labels"][:n] = lab
        for m, e in enumerate(evs):
            padded = np.zeros((budget,) + e.shape[1:], dtype=np.float32)
            padded[:n] = e
            out["events" if m == 0 else f"events{m + 1}"] = padded
        return out

    def _epoch_groups(self) -> List[List[List[str]]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(order)
        groups = []
        for start in range(0, self.batches_per_epoch * self.sess_per_batch,
                           self.sess_per_batch):
            groups.append([self.dataset[i]
                           for i in order[start:start + self.sess_per_batch]])
        return groups

    def epoch(self, max_batches: Optional[int] = None):
        """Yield one epoch of batches with background prefetch.

        ``max_batches`` truncates the epoch BEFORE the worker starts
        (multihost lockstep: a host holding surplus sessions emits the
        global per-epoch step count).  Truncating here rather than
        abandoning the stream mid-epoch keeps ``self.rng`` consumption
        deterministic — the prefetch worker never loads (and never draws
        rng for) batches the consumer will drop."""
        groups = self._epoch_groups()
        if max_batches is not None:
            groups = groups[:max_batches]
        yield from _prefetched(groups, self._load_group, self.prefetch)
