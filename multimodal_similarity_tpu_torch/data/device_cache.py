"""Device-resident int8 epoch feature cache, on one device.

Counterpart of the JAX package's ``data/device_cache.py``.  Disk-fed
training sends the same event windows to the card every epoch, though at
the reference operating point (45-frame capped windows) the whole train set
fits in device memory as int8.  The cache turns that recurring cost into a
one-time one:

1. ``build``: the label pickles alone give every event's label and frame
   count, and so the frame trim ``t_eff`` (the longest window, at least
   ``n_seg``).  Each session's windows are then read at ``t_eff`` frames,
   quantized to int8 with the feed's scheme (data/device_feed.py
   ``quantize_features``: scales per (event, frame[, channel]), so trimming
   frames before or after quantizing gives the same bits) and copied to the
   device.  The resident ``q``, ``scale``, ``seq_len`` and label table equal
   the JAX cache's (``mesh=None``) bit for bit.
2. Each batch: the host draws a KB-sized index plan (``_plan_epoch``, the
   session loader's semantics from the cache's own ``RandomState``) and the
   device gathers fresh TSN frames from the resident arrays (``gather``),
   with labels and mask derived on the device from the label table.

Over the ``budget_bytes`` estimate, ``build`` returns None with the JAX
cache's notice and the trainer keeps the streaming feed.  The estimate
counts ``max_frames`` (45) frames an event, as the reference's does, though
the resident arrays hold ``t_eff`` frames (ROADMAP §3).  A sharded cache
(``mesh``) is ROADMAP slice 8c.  ``COUNTS`` counts builds and gathers.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch.data.device_feed import (
    _scale_shape, quantize_features)
from multimodal_similarity_tpu_torch.data.honda import (
    LABEL_TRANSFER, MAX_LENGTH, MIN_LENGTH, MIN_LENGTH_BACKGROUND)
from multimodal_similarity_tpu_torch.data.tsn import tsn_sample_offsets

# cache builds and gathers since the last reset (chip_smoke.py reads them)
COUNTS = {"build": 0, "gather": 0}

# events staged per quantize pass: the f32 temporaries stay small (64
# ConvRTSN events of 6 x 8x8x1536 f32 are 150 MB)
_CHUNK = 64


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _session_events(label_path: str) -> List[Tuple[int, int, int]]:
    """(start frame, capped length, raw label) of every event of a session
    that survives load_data_and_label's filters, in its order."""
    with open(label_path, "rb") as f:
        label = pickle.load(f)
    events = []
    for i in range(len(label["G"])):
        length = label["s"][i + 1] - label["s"][i]
        if length > MIN_LENGTH:
            if label["G"][i] == 0 and length < MIN_LENGTH_BACKGROUND:
                continue
            events.append((int(label["s"][i]), int(min(length, MAX_LENGTH)),
                           int(label["G"][i])))
    return events


def _session_event_lengths(label_path: str) -> List[int]:
    """Per-event capped frame counts of one session, from its label pickle
    alone."""
    return [length for _, length, _ in _session_events(label_path)]


def _session_label_metadata(label_path: str, transfer: bool,
                            max_frames: int):
    """(labels [N] int32, seq_len [N] int32) of one session from its label
    pickle alone: the loader's event filters, lengths capped at
    ``MAX_LENGTH`` and then at ``max_frames``."""
    events = _session_events(label_path)
    if not events:
        with open(label_path, "rb") as f:
            raw = len(pickle.load(f)["G"])
        raise ValueError(
            f"no event in session {label_path!r} survives the length "
            f"filters (MIN_LENGTH={MIN_LENGTH}, MIN_LENGTH_BACKGROUND="
            f"{MIN_LENGTH_BACKGROUND}); {raw} raw segments")
    labs = [LABEL_TRANSFER[g] if transfer else g for _, _, g in events]
    lens = [min(length, max_frames) for _, length, _ in events]
    return np.asarray(labs, np.int32), np.asarray(lens, np.int32)


def _npy_shape(path: str) -> tuple:
    """The array shape in a ``.npy`` header (no data read, no map)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            return np.lib.format.read_array_header_1_0(f)[0]
        return np.lib.format.read_array_header_2_0(f)[0]


def estimate_cache_bytes(dataset: Sequence[Sequence[str]],
                         max_frames: int = MAX_LENGTH) -> int:
    """Estimated device bytes for caching every modality of ``dataset``
    (int8 frames + f32 scales at ``max_frames`` frames an event), from the
    label pickles and the ``.npy`` headers alone.  Raises ValueError when
    the per-frame dims differ between sessions."""
    num_modalities = len(dataset[0]) - 1
    n_events = 0
    per_event = 0
    dims0 = None
    for i, row in enumerate(dataset):
        n_events += len(_session_event_lengths(row[-1]))
        dims = tuple(tuple(_npy_shape(row[m])[1:])
                     for m in range(num_modalities))
        if i == 0:
            dims0 = dims
            for shape in dims:
                # int8 frames plus one f32 scale a frame (flat features)
                # or a frame and channel (conv maps)
                scale_elems = shape[-1] if len(shape) >= 2 else 1
                per_event += max_frames * (int(np.prod(shape))
                                           + 4 * scale_elems)
        elif dims != dims0:
            raise ValueError(
                f"heterogeneous feature dims: session 0 has {dims0}, "
                f"session {i} ({row[0]!r}) has {dims}; the cache (and its "
                "HBM budget estimate) requires homogeneous per-frame dims")
    return n_events * per_event


def _stage_session(feat_paths: Sequence[str],
                   events: List[Tuple[int, int, int]], seq_len: np.ndarray,
                   t_eff: int):
    """One session's int8 windows: per modality (q [n, t_eff, ...] int8,
    scale f32) on the host, ``seq_len`` frames of each event from its start
    and zeros after, quantized ``_CHUNK`` events at a time."""
    out = []
    n = len(events)
    for path in feat_paths:
        feats = np.load(path, mmap_mode="r")
        shape = (n, t_eff) + feats.shape[1:]
        q = torch.empty(shape, dtype=torch.int8)
        scale = torch.empty(_scale_shape(shape), dtype=torch.float32)
        chunk = min(_CHUNK, n)
        buf = np.zeros((chunk,) + shape[1:], np.float32)
        scratch = torch.empty(buf.shape, dtype=torch.float32)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            buf.fill(0.0)
            for j in range(lo, hi):
                start = events[j][0]
                window = feats[start:start + int(seq_len[j])]
                buf[j - lo, :window.shape[0]] = window
            quantize_features(torch.from_numpy(buf[:hi - lo]),
                              out=(q[lo:hi], scale[lo:hi]),
                              scratch=scratch[:hi - lo])
        out.append((q, scale))
    return out


class DeviceFeatureCache:
    """Int8 event windows resident on one device, re-sampled there each
    batch.

    Build with :meth:`build` (None over budget).  :meth:`epoch_plans` gives
    one epoch of host index plans and :meth:`gather` turns a plan on the
    device into a batch in the int8 feed's form (``{"q", "scale"}`` a TSN
    modality, a dense [B, ...] mean for a ``meanpool`` one), with labels
    and mask; :meth:`epoch_batches` does both (the two-call path)."""

    def __init__(self, *, n_seg: int, sess_per_batch: int, event_budget: int,
                 seed: int, device,
                 modality_modes: Optional[Sequence[str]] = None):
        self.n_seg = n_seg
        self.sess_per_batch = sess_per_batch
        self.event_budget = event_budget
        self.device = torch.device(device)
        self.modality_modes = modality_modes
        self.rng = np.random.RandomState(seed)
        self._sessions: List[np.ndarray] = []  # global event ids a session
        self._labels: List[np.ndarray] = []    # host labels a session

    @classmethod
    def build(cls, dataset: Sequence[Sequence[str]], *, n_seg: int,
              sess_per_batch: int, event_budget: int, seed: int,
              device="cuda", mesh=None, max_frames: int = MAX_LENGTH,
              budget_bytes: Optional[int] = None,
              modality_modes: Optional[Sequence[str]] = None,
              beat=None, workers: Optional[int] = None,
              verbose: bool = True) -> Optional["DeviceFeatureCache"]:
        """Read, quantize and upload every session of ``dataset`` (rows of
        feature paths, label path last) to ``device``.

        ``modality_modes`` picks each modality's gather: ``"tsn"`` (the
        default) fresh TSN segment frames each batch, ``"meanpool"`` the
        masked frame mean of the window.  ``beat`` (a callable) fires once
        a session staged.  ``workers`` sizes a thread pool over the
        sessions (default ``min(4, usable cores)``); results drain in
        submission order, so the layout is the same for any count.
        Returns None, with a notice, when the estimate exceeds
        ``budget_bytes``."""
        if mesh is not None:
            raise NotImplementedError(
                "a sharded device cache (mesh=...) is not ported yet "
                "(ROADMAP slice 8c)")
        est = estimate_cache_bytes(dataset, max_frames)
        if budget_bytes is not None and est > budget_bytes:
            if verbose:
                print(f"[device_cache] estimated {est / 1e9:.2f} GB exceeds "
                      f"budget {budget_bytes / 1e9:.2f} GB; falling back to "
                      "the streaming feed")
            return None
        if verbose:
            print(f"[device_cache] caching {len(dataset)} sessions "
                  f"(~{est / 1e9:.2f} GB int8) on device")
        num_modalities = len(dataset[0]) - 1
        if modality_modes is not None:
            if len(modality_modes) != num_modalities:
                raise ValueError(
                    f"modality_modes {modality_modes} does not match "
                    f"{num_modalities} modalities")
            bad = set(modality_modes) - {"tsn", "meanpool"}
            if bad:
                raise ValueError(f"unknown modality modes: {sorted(bad)}")
        self = cls(n_seg=n_seg, sess_per_batch=min(sess_per_batch,
                                                   len(dataset)),
                   event_budget=event_budget, seed=seed, device=device,
                   modality_modes=modality_modes)
        self.num_modalities = num_modalities

        # the layout from the label pickles alone: labels, frame counts,
        # global event ids and the frame trim, before any feature is read
        events = [_session_events(row[-1]) for row in dataset]
        base = 0
        lens = []
        for row in dataset:
            lab, seq_len = _session_label_metadata(
                row[-1], transfer=True, max_frames=max_frames)
            self._sessions.append(np.arange(base, base + lab.shape[0],
                                            dtype=np.int32))
            self._labels.append(lab)
            lens.append(seq_len)
            base += lab.shape[0]
        self.shard_rows = base
        seq_len = np.concatenate(lens)
        t_eff = max(n_seg, int(seq_len.max()))
        self.max_frames = t_eff
        self.label_table = np.concatenate(self._labels)

        dims = [tuple(_npy_shape(dataset[0][m])[1:])
                for m in range(num_modalities)]
        self.q, self.scale = [], []
        for d in dims:
            shape = (base, t_eff) + d
            self.q.append(torch.empty(shape, dtype=torch.int8,
                                      device=self.device))
            self.scale.append(torch.empty(_scale_shape(shape),
                                          dtype=torch.float32,
                                          device=self.device))

        starts = np.cumsum([0] + [len(e) for e in events])
        tasks = [(row[:-1], events[i], lens[i], t_eff)
                 for i, row in enumerate(dataset)]
        if workers is None:
            try:  # the cores this process may run on
                avail = len(os.sched_getaffinity(0))
            except AttributeError:
                avail = os.cpu_count() or 1
            workers = min(4, avail)

        def place(i, mods):
            lo, hi = starts[i], starts[i + 1]
            for m, (q, scale) in enumerate(mods):
                self.q[m][lo:hi].copy_(q)
                self.scale[m][lo:hi].copy_(scale)
            if beat is not None:
                beat()

        if workers > 1 and len(tasks) > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=workers)
            try:
                # drained in submission order: the first failing session
                # raises here, and the beats follow the session order
                for i, mods in enumerate(pool.map(
                        lambda t: _stage_session(*t), tasks)):
                    place(i, mods)
            except BaseException:
                pool.shutdown(wait=False, cancel_futures=True)
                raise
            pool.shutdown(wait=True)
        else:
            for i, task in enumerate(tasks):
                place(i, _stage_session(*task))

        self.seq_len = torch.from_numpy(seq_len).to(self.device)
        # the label table is resident too: a batch's labels and mask derive
        # on the device from its index plan
        self.label_dev = torch.from_numpy(self.label_table).to(self.device)
        self.device_bytes = int(sum(
            t.numel() * t.element_size()
            for t in (*self.q, *self.scale, self.seq_len, self.label_dev)))
        COUNTS["build"] += 1
        return self

    # -- the epoch plan -----------------------------------------------------

    @property
    def batches_per_epoch(self) -> int:
        return len(self._sessions) // self.sess_per_batch

    def _plan_epoch(self):
        """One epoch of (event ids, labels, mask) a batch: the session
        loader's semantics (shuffle the session order, group
        ``sess_per_batch`` sessions, permute the group's events, cut to
        the budget or pad up to it with row 0, masked out)."""
        bpe = self.batches_per_epoch
        order = self.rng.permutation(len(self._sessions))
        plans = []
        for b in range(bpe):
            idx = np.concatenate([
                self._sessions[i] for i in
                order[b * self.sess_per_batch:(b + 1) * self.sess_per_batch]])
            n = idx.shape[0]
            if n > self.event_budget:
                take = self.rng.permutation(n)[:self.event_budget]
            else:
                take = self.rng.permutation(n)
            idx = idx[take]
            labels = self.label_table[idx]
            mask = np.ones(idx.shape[0], np.float32)
            pad = self.event_budget - idx.shape[0]
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, np.int32)])
                labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            plans.append((idx, labels, mask))
        return plans

    def epoch_plans(self):
        """One epoch of host plans: ``packed`` [budget + 1] int32 (the event
        ids, then the real-event count) is a batch's only upload;
        ``labels_host`` / ``mask_host`` are its labels and mask in gathered
        order, for a sampling policy that runs on the plan."""
        for idx, labels, mask in self._plan_epoch():
            yield {"packed": np.concatenate(
                       [idx, [int(mask.sum())]]).astype(np.int32),
                   "labels_host": labels, "mask_host": mask,
                   "num_events": int(mask.sum())}

    def put_plans(self, args):
        """The plan operands as they are: on one device nothing is sharded
        (the JAX cache's multi-process placement is slice 8c).  Kept for
        the JAX cache's interface; only the tests call it."""
        return tuple(args)

    def step_operands(self):
        """The resident arrays a gather reads: (seq_len, label table, then
        q and scale of each modality), in the JAX cache's order.  Only the
        tests call it, to hold the resident arrays to the JAX cache's."""
        mods = []
        for m in range(self.num_modalities):
            mods.extend([self.q[m], self.scale[m]])
        return (self.seq_len, self.label_dev, *mods)

    # -- the device gather ----------------------------------------------------

    def gather(self, packed: torch.Tensor, generator: torch.Generator,
               rows: Optional[torch.Tensor] = None):
        """One batch from a plan on the device: (one output a modality,
        labels [B] int32, mask [B] f32).  ``packed`` is a plan's [budget +
        1] ids and count; ``generator`` draws each TSN modality's uniforms
        in modality order, [budget, n_seg] each.  ``rows`` (optional)
        takes those rows of the batch: the features of the others are
        never read."""
        COUNTS["gather"] += 1
        indices = packed[:-1].long()
        budget = indices.shape[0]
        mask = (torch.arange(budget, device=indices.device)
                < packed[-1]).to(torch.float32)
        labels = self.label_dev[indices] * mask.to(torch.int32)
        lens = self.seq_len[indices]
        t = self.max_frames
        modes = self.modality_modes or ("tsn",) * self.num_modalities
        out = []
        for m, mode in enumerate(modes):
            q, scale = self.q[m], self.scale[m]
            if mode == "meanpool":
                idx = indices if rows is None else indices[rows]
                n_len = lens if rows is None else lens[rows]
                # f32 accumulation: the int8 storage is the only
                # approximation of the streamed f32 mean
                x = (q.index_select(0, idx).to(torch.float32)
                     * scale.index_select(0, idx))
                tail = (1,) * (x.ndim - 2)
                valid = (torch.arange(t, device=idx.device)[None, :]
                         < n_len[:, None]).to(torch.float32)
                denom = torch.clamp(n_len.to(torch.float32), min=1.0)
                out.append((x * valid.reshape(valid.shape + tail)).sum(1)
                           / denom.reshape((-1,) + tail))
                continue
            # every TSN modality draws its own offsets, as the streamed
            # loader's prepare calls do
            offs = tsn_sample_offsets(generator, lens, self.n_seg)
            flat = indices[:, None] * t + offs
            if rows is not None:
                flat = flat[rows]
            flat = flat.reshape(-1)
            out.append({
                "q": q.reshape((-1,) + q.shape[2:]).index_select(
                    0, flat).reshape((-1, self.n_seg) + q.shape[2:]),
                "scale": scale.reshape((-1,) + scale.shape[2:]).index_select(
                    0, flat).reshape((-1, self.n_seg) + scale.shape[2:])})
        if rows is not None:
            labels, mask = labels[rows], mask[rows]
        return tuple(out), labels, mask

    def epoch_batches(self, generator: torch.Generator):
        """One epoch of gathered batches (the two-call path): each plan
        uploaded, then gathered.  A batch holds ``events`` (and
        ``events2``, ``events3`` ...), ``labels``, ``mask`` on the device,
        and the plan's ``labels_host``, ``mask_host``, ``num_events`` and
        ``global_indices``."""
        for plan in self.epoch_plans():
            packed = torch.from_numpy(plan["packed"]).to(self.device)
            gathered, labels, mask = self.gather(packed, generator)
            batch = {"labels": labels, "mask": mask,
                     "labels_host": plan["labels_host"],
                     "mask_host": plan["mask_host"],
                     "num_events": plan["num_events"],
                     "global_indices": plan["packed"][:-1]}
            for m, g in enumerate(gathered):
                batch["events" if m == 0 else f"events{m + 1}"] = g
            yield batch


def cache_budget_bytes(gb: float) -> int:
    return int(gb * 1e9)


def notice_window_shortfall(cache, steps_per_dispatch: int, name: str,
                            silent: bool) -> None:
    """Say so when --steps_per_dispatch K exceeds the batches of an epoch:
    every window is then a short one and runs the K=1 path."""
    if steps_per_dispatch > cache.batches_per_epoch and not silent:
        print(f"[{name}] --steps_per_dispatch {steps_per_dispatch} exceeds "
              f"{cache.batches_per_epoch} batches/epoch: every epoch is a "
              "remainder window and steps run one at a time (K=1).  Lower "
              "K or raise sessions per epoch to get whole windows.")
