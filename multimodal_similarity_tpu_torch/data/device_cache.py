"""Device-resident int8 epoch feature cache, on one device or a process
mesh.

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
the resident arrays hold ``t_eff`` frames (ROADMAP §3).  On a process mesh
(``mesh``) each rank holds one shard of the sessions and gathers its own
row block of every batch (``DeviceFeatureCache``).  The counters
``cache.build`` and ``cache.gather`` (utils/profiling.py) count builds and
gathers.
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
from multimodal_similarity_tpu_torch.utils import profiling
from multimodal_similarity_tpu_torch.utils.profiling import count, span

# events staged per quantize pass: the f32 temporaries stay small (64
# ConvRTSN events of 6 x 8x8x1536 f32 are 150 MB)
_CHUNK = 64


def reset_counts() -> None:
    """Set the cache's counters, ``cache.build`` and ``cache.gather``,
    to 0."""
    profiling.reset_counts("cache.", ("build", "gather"))


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
                         max_frames: int = MAX_LENGTH,
                         n_shards: int = 1) -> int:
    """Estimated device bytes for caching every modality of ``dataset``
    (int8 frames + f32 scales at ``max_frames`` frames an event), from the
    label pickles and the ``.npy`` headers alone.  ``n_shards`` gives
    ``build``'s mesh layout: sessions go round-robin onto the shards and
    every shard pads to the largest one's event count, so the estimate is
    ``n_shards`` times that count.  Raises ValueError when the per-frame
    dims differ between sessions."""
    num_modalities = len(dataset[0]) - 1
    shard_events = [0] * max(n_shards, 1)
    per_event = 0
    dims0 = None
    for i, row in enumerate(dataset):
        shard_events[i % len(shard_events)] += len(
            _session_event_lengths(row[-1]))
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
    return max(shard_events) * len(shard_events) * per_event


def _mesh_locality(mesh, n_shards: int):
    """(local shards, multi-process, shards a process) of a mesh's "data"
    axis.  On the port's mesh a rank is a process with one device (ROADMAP
    D6), so shard r belongs to rank r: each rank stages and uploads its
    own shard alone."""
    if mesh is None:
        return [0], False, {0: 1}
    return [mesh.rank], n_shards > 1, dict.fromkeys(range(n_shards), 1)


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
    """Int8 event windows resident on the device, re-sampled there each
    batch; on a process mesh (``mesh``), each rank holds its shard.

    Build with :meth:`build` (None over budget).  :meth:`epoch_plans` gives
    one epoch of host index plans and :meth:`gather` turns a plan on the
    device into a batch in the int8 feed's form (``{"q", "scale"}`` a TSN
    modality, a dense [B, ...] mean for a ``meanpool`` one), with labels
    and mask; :meth:`epoch_batches` does both (the two-call path).

    On a mesh of n ranks the sessions go round-robin over n shards (the
    order of ``host_local_sessions``), shard r is rank r's, and every shard
    pads to the largest one's event count ``shard_rows``: shard s holds the
    global event ids ``[s shard_rows, (s + 1) shard_rows)``.  The label
    table, the frame trim, ``shard_rows`` and the plans are the same on
    every rank, from the label pickles alone; each rank reads, quantizes
    and uploads the features of its own shard.  A plan is shard-aligned:
    the batch's rows ``[s per, (s + 1) per)`` (``per`` = budget / n) are
    events of shard s, so a rank gathers its own row block with no
    collective on the features."""

    def __init__(self, *, n_seg: int, sess_per_batch: int, event_budget: int,
                 seed: int, device, mesh=None,
                 modality_modes: Optional[Sequence[str]] = None):
        self.n_seg = n_seg
        self.sess_per_batch = sess_per_batch
        self.event_budget = event_budget
        self.device = torch.device(device)
        self.mesh = mesh
        self.n_shards = mesh.size if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        if event_budget % self.n_shards:
            raise ValueError(
                f"event_budget {event_budget} not divisible by "
                f"{self.n_shards} mesh shards")
        self.modality_modes = modality_modes
        self.rng = np.random.RandomState(seed)
        # per shard: the global event ids of each of its sessions
        self._shard_sessions: List[List[np.ndarray]] = [
            [] for _ in range(self.n_shards)]
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
        feature paths, label path last) to ``device``; on a ``mesh``
        (parallel.ProcessMesh), this rank's shard of them.

        ``modality_modes`` picks each modality's gather: ``"tsn"`` (the
        default) fresh TSN segment frames each batch, ``"meanpool"`` the
        masked frame mean of the window.  ``beat`` (a callable) fires once
        a session staged.  ``workers`` sizes a thread pool over the
        sessions (default ``min(4, usable cores)``); results drain in
        submission order, so the layout is the same for any count.
        Returns None, with a notice, when the estimate exceeds
        ``budget_bytes``: on a mesh, when the worst rank's share of it
        does (every shard pads to the same rows, so every rank takes the
        same decision), or when there are fewer sessions than shards."""
        n_shards = mesh.size if mesh is not None else 1
        local, multiprocess, per_process = _mesh_locality(mesh, n_shards)
        est = estimate_cache_bytes(dataset, max_frames, n_shards)
        est_local = est * max(per_process.values()) // n_shards
        if budget_bytes is not None and est_local > budget_bytes:
            if verbose:
                share = " the largest host share of" if multiprocess else ""
                print(f"[device_cache] estimated{share} "
                      f"{est_local / 1e9:.2f} GB exceeds budget "
                      f"{budget_bytes / 1e9:.2f} GB; falling back to the "
                      "streaming feed")
            return None
        if verbose:
            print(f"[device_cache] caching {len(dataset)} sessions "
                  f"(~{est / 1e9:.2f} GB int8"
                  + (f" global, <= {est_local / 1e9:.2f} GB per host"
                     if multiprocess else "")
                  + ") on device")
        num_modalities = len(dataset[0]) - 1
        if modality_modes is not None:
            if len(modality_modes) != num_modalities:
                raise ValueError(
                    f"modality_modes {modality_modes} does not match "
                    f"{num_modalities} modalities")
            bad = set(modality_modes) - {"tsn", "meanpool"}
            if bad:
                raise ValueError(f"unknown modality modes: {sorted(bad)}")
        self = cls(n_seg=n_seg, sess_per_batch=sess_per_batch,
                   event_budget=event_budget, seed=seed, device=device,
                   mesh=mesh, modality_modes=modality_modes)
        self.num_modalities = num_modalities

        # sessions round-robin over the shards
        per_shard = [list(range(s, len(dataset), n_shards))
                     for s in range(n_shards)]
        if any(not sess for sess in per_shard):
            if verbose:
                print(f"[device_cache] {len(dataset)} sessions < "
                      f"{n_shards} shards; falling back to the streaming "
                      "feed")
            return None
        # a thin shard still forms one batch an epoch
        self.sess_per_batch = min(sess_per_batch,
                                  min(len(sess) for sess in per_shard))

        # the layout from the label pickles alone: labels, frame counts,
        # global event ids and the frame trim, before any feature is read
        meta = [_session_label_metadata(row[-1], transfer=True,
                                        max_frames=max_frames)
                for row in dataset]
        counts = [sum(meta[i][0].shape[0] for i in sess)
                  for sess in per_shard]
        n_max = max(counts)
        self.shard_rows = n_max
        self.label_table = np.zeros(n_shards * n_max, np.int32)
        for s, sess in enumerate(per_shard):
            base = s * n_max
            for i in sess:
                lab = meta[i][0]
                ids = np.arange(base, base + lab.shape[0], dtype=np.int32)
                self._shard_sessions[s].append(ids)
                self._labels.append(lab)
                self.label_table[ids] = lab
                base += lab.shape[0]
        t_eff = max(n_seg, max(int(m[1].max()) for m in meta))
        self.max_frames = t_eff

        # this rank's shard: its sessions' windows, padded to n_max rows
        # (padding frames zero with scale one, seq_len n_seg)
        mine = per_shard[local[0]]
        seq_len = np.concatenate(
            [meta[i][1] for i in mine]
            + [np.full(n_max - counts[local[0]], n_seg, np.int32)])
        dims = [tuple(_npy_shape(dataset[0][m])[1:])
                for m in range(num_modalities)]
        self.q, self.scale = [], []
        for d in dims:
            shape = (n_max, t_eff) + d
            self.q.append(torch.zeros(shape, dtype=torch.int8,
                                      device=self.device))
            self.scale.append(torch.ones(_scale_shape(shape),
                                         dtype=torch.float32,
                                         device=self.device))

        starts = np.cumsum([0] + [meta[i][0].shape[0] for i in mine])
        tasks = [(dataset[i][:-1], _session_events(dataset[i][-1]),
                  meta[i][1], t_eff) for i in mine]
        if workers is None:
            try:  # the cores this process may run on
                avail = len(os.sched_getaffinity(0))
            except AttributeError:
                avail = os.cpu_count() or 1
            workers = min(4, avail)

        def place(j, mods):
            lo, hi = starts[j], starts[j + 1]
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
                for j, mods in enumerate(pool.map(
                        lambda t: _stage_session(*t), tasks)):
                    place(j, mods)
            except BaseException:
                pool.shutdown(wait=False, cancel_futures=True)
                raise
            pool.shutdown(wait=True)
        else:
            for j, task in enumerate(tasks):
                place(j, _stage_session(*task))

        self.seq_len = torch.from_numpy(seq_len).to(self.device)
        # the whole label table is resident on every rank: a batch's labels
        # and mask derive on the device from its index plan
        self.label_dev = torch.from_numpy(self.label_table).to(self.device)
        # this rank's resident bytes
        self.device_bytes = int(sum(
            t.numel() * t.element_size()
            for t in (*self.q, *self.scale, self.seq_len, self.label_dev)))
        count("cache.build")
        return self

    # -- the epoch plan -----------------------------------------------------

    @property
    def batches_per_epoch(self) -> int:
        return min(len(sess) // self.sess_per_batch
                   for sess in self._shard_sessions)

    @property
    def plan_rows(self) -> int:
        """Entries of a packed plan: each shard's event ids and its
        real-event count."""
        return self.event_budget + self.n_shards

    def _plan_epoch(self):
        """One epoch of plans, a list of per-shard (global event ids,
        labels, mask) a batch: the session loader's semantics in each shard
        (shuffle the shard's session order, group ``sess_per_batch``
        sessions, permute the group's events, cut to the shard's share of
        the budget or pad up to it with the shard's first row, masked
        out)."""
        bpe = self.batches_per_epoch
        per = self.event_budget // self.n_shards
        groups = []
        for sess in self._shard_sessions:
            order = self.rng.permutation(len(sess))
            groups.append([
                [sess[i] for i in order[g * self.sess_per_batch:
                                        (g + 1) * self.sess_per_batch]]
                for g in range(bpe)])
        plans = []
        for b in range(bpe):
            rows = []
            for s in range(self.n_shards):
                idx = np.concatenate(groups[s][b])
                n = idx.shape[0]
                take = (self.rng.permutation(n)[:per] if n > per
                        else self.rng.permutation(n))
                idx = idx[take]
                labels = self.label_table[idx]
                mask = np.ones(idx.shape[0], np.float32)
                pad = per - idx.shape[0]
                if pad:
                    idx = np.concatenate(
                        [idx, np.full(pad, s * self.shard_rows, np.int32)])
                    labels = np.concatenate([labels,
                                             np.zeros(pad, np.int32)])
                    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
                rows.append((idx, labels, mask))
            plans.append(rows)
        return plans

    def epoch_plans(self):
        """One epoch of host plans: ``packed`` [budget + shards] int32 (each
        shard's shard-local event ids, then its real-event count; on one
        device the ids, then the count) is a batch's only upload;
        ``labels_host`` / ``mask_host`` are its labels and mask in gathered
        order, for a sampling policy that runs on the plan."""
        for rows in self._plan_epoch():
            mask = np.concatenate([r[2] for r in rows])
            yield {"packed": np.concatenate([
                       np.concatenate([r[0] % self.shard_rows,
                                       [int(r[2].sum())]])
                       for r in rows]).astype(np.int32),
                   "labels_host": np.concatenate([r[1] for r in rows]),
                   "mask_host": mask, "num_events": int(mask.sum()),
                   "global_indices": np.concatenate([r[0] for r in rows])}

    def put_plans(self, args):
        """The plan operands as they are: every rank uploads the whole
        (KB-sized) plan itself.  Kept for the JAX cache's interface; only
        the tests call it."""
        return tuple(args)

    def step_operands(self):
        """The resident arrays a gather reads: (seq_len, label table, then
        q and scale of each modality), in the JAX cache's order; on a mesh,
        this rank's rows of all but the label table, which every rank holds
        whole.  Only the tests call it, to hold the resident arrays to the
        JAX cache's."""
        mods = []
        for m in range(self.num_modalities):
            mods.extend([self.q[m], self.scale[m]])
        return (self.seq_len, self.label_dev, *mods)

    # -- the device gather ----------------------------------------------------

    def gather(self, packed: torch.Tensor, generator: torch.Generator,
               rows: Optional[torch.Tensor] = None):
        """One batch from a plan on the device: (one output a modality,
        labels [B] int32, mask [B] f32).  ``packed`` is a plan's
        ``plan_rows`` entries; ``generator`` draws each TSN modality's
        uniforms in modality order, [budget, n_seg] each.  On a mesh the
        outputs are this rank's row block of the batch, the labels and
        mask the whole batch's.  ``rows`` (optional) takes those rows of
        the batch: on one device the features of the others are never
        read; on a mesh each rank receives its contiguous share of them,
        routed from the ranks that hold them in one all-to-all a tensor
        (parallel/data_parallel.py ``gather_rows``), with their labels and
        mask."""
        count("cache.gather")
        with span("cache.gather"):
            n, budget = self.n_shards, self.event_budget
            per = budget // n
            plan = packed.view(n, per + 1)
            ids = plan[:, :-1].long()
            valid = (torch.arange(per, device=ids.device)[None, :]
                     < plan[:, -1:]).to(torch.float32)
            base = (torch.arange(n, device=ids.device)[:, None]
                    * self.shard_rows)
            labels = (self.label_dev[ids + base]
                      * valid.to(torch.int32)).reshape(-1)
            mask = valid.reshape(-1)
            indices = ids[self.rank]
            lens = self.seq_len[indices]
            sel = rows if self.mesh is None else None
            block = slice(self.rank * per, (self.rank + 1) * per)
            t = self.max_frames
            modes = self.modality_modes or ("tsn",) * self.num_modalities
            out = []
            for m, mode in enumerate(modes):
                q, scale = self.q[m], self.scale[m]
                if mode == "meanpool":
                    idx = indices if sel is None else indices[sel]
                    n_len = lens if sel is None else lens[sel]
                    # f32 accumulation: the int8 storage is the only
                    # approximation of the streamed f32 mean
                    x = (q.index_select(0, idx).to(torch.float32)
                         * scale.index_select(0, idx))
                    tail = (1,) * (x.ndim - 2)
                    frames = (torch.arange(t, device=idx.device)[None, :]
                              < n_len[:, None]).to(torch.float32)
                    denom = torch.clamp(n_len.to(torch.float32), min=1.0)
                    out.append((x * frames.reshape(frames.shape + tail)).sum(1)
                               / denom.reshape((-1,) + tail))
                    continue
                # every TSN modality draws its own offsets, as the streamed
                # loader's prepare calls do; drawn for the whole batch
                offs = tsn_sample_offsets(generator, lens, self.n_seg,
                                          rows=(budget, block))
                flat = indices[:, None] * t + offs
                if sel is not None:
                    flat = flat[sel]
                flat = flat.reshape(-1)
                out.append({
                    "q": q.reshape((-1,) + q.shape[2:]).index_select(
                        0, flat).reshape((-1, self.n_seg) + q.shape[2:]),
                    "scale": scale.reshape(
                        (-1,) + scale.shape[2:]).index_select(0, flat).reshape(
                            (-1, self.n_seg) + scale.shape[2:])})
            if rows is not None:
                if self.mesh is not None:
                    from multimodal_similarity_tpu_torch.parallel.\
                        data_parallel import gather_rows, share
                    out = [gather_rows(o, rows, self.mesh, per) for o in out]
                    rows = rows[share(rows.shape[0], self.mesh)]
                labels, mask = labels[rows], mask[rows]
            return tuple(out), labels, mask

    def epoch_batches(self, generator: torch.Generator):
        """One epoch of gathered batches (the two-call path): each plan
        uploaded, then gathered.  A batch holds ``events`` (and
        ``events2``, ``events3`` ...; on a mesh this rank's row block),
        ``labels``, ``mask`` on the device, and the plan's
        ``labels_host``, ``mask_host``, ``num_events`` and
        ``global_indices``."""
        for plan in self.epoch_plans():
            packed = torch.from_numpy(plan["packed"]).to(self.device)
            gathered, labels, mask = self.gather(packed, generator)
            batch = {"labels": labels, "mask": mask,
                     "labels_host": plan["labels_host"],
                     "mask_host": plan["mask_host"],
                     "num_events": plan["num_events"],
                     "global_indices": plan["global_indices"]}
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
