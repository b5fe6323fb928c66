"""Host-to-device batch feeding, one thread ahead of the step.

Counterpart of the JAX package's ``data/device_feed.py`` and of the feature
helpers of its ``train/steps.py``.  ``device_prefetch`` runs the host side
of each batch on a background thread, ``DEPTH`` batches ahead of the
consumer: the row gather of a selection, the bf16 cast or int8 quantizing
(``--bf16_features`` / ``--int8_features``, both before the wire, as in
the JAX package), and the upload.

The batch shapes are fixed (a change of shape raises).  On ``cuda`` the
gather and cast write straight into a ring of ``DEPTH + 1`` page-locked
host buffers, allocated once, and each upload is an asynchronous copy on a
side stream that records an event.  The consumer's stream waits on that
event and the received tensors are marked used on it (``record_stream``),
so the caching allocator keeps them until the consumer's work is done.  A
ring buffer is refilled only after the copy that last read it completed.
Nothing falls back to a pageable copy: a failed pin, copy or stream
operation raises in the consumer.  On the CPU (the caller asked for it)
the staged tensors are the batch; there is no pinning and no stream.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_similarity_tpu_torch.data.loader import _prefetched

# batches the feed thread runs ahead of the consumer (the JAX feed's
# default); the pinned ring holds DEPTH + 1
DEPTH = 2

# rows staged per cast or quantize pass: the temporaries of one pass stay
# small (16 ConvRTSN events of 3 x 8x8x1536 f32 are 19 MB)
_CHUNK = 16


def _scale_axes(nd: int) -> tuple:
    """The axes one int8 scale spans: all but event, frame and (for conv
    maps) channel."""
    if nd >= 4:
        return tuple(range(2, nd - 1))
    return tuple(range(2, nd)) or (nd - 1,)


def _scale_shape(shape) -> tuple:
    return tuple(1 if ax in _scale_axes(len(shape)) else n
                 for ax, n in enumerate(shape))


def quantize_features(a, out: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                      scratch: Optional[torch.Tensor] = None):
    """Symmetric int8 quantization with fine-grained max-abs scales, bit for
    bit the JAX package's.

    Scale groups: per (event, frame) for flat features ([N, S, D] -> scales
    [N, S, 1]) and per (event, frame, channel) for conv maps ([N, S, h, w,
    C] -> scales [N, S, 1, 1, C]).  Returns (q int8, scale float32) tensors
    with x_hat = q * scale (error at most scale / 2), written into ``out``
    when given; ``scratch`` (f32, the size of the input) holds x / scale,
    so a caller that passes both allocates nothing.  The division is IEEE
    f32 and the rounding half to even, as NumPy's."""
    x = torch.as_tensor(np.asarray(a, np.float32)) \
        if not isinstance(a, torch.Tensor) else a.float()
    if out is None:
        out = (torch.empty(x.shape, dtype=torch.int8, device=x.device),
               torch.empty(_scale_shape(x.shape), dtype=torch.float32,
                           device=x.device))
    q, scale = out
    axes = _scale_axes(x.ndim)
    grouped = x.reshape(x.shape[:axes[0]] + (-1,) + x.shape[axes[-1] + 1:])
    # max |x| of each group from one pass over x
    lo, hi = torch.aminmax(grouped, dim=axes[0], keepdim=True)
    amax = torch.maximum(hi, lo.neg_()).clamp_(min=1e-12)
    scale.copy_((amax / 127.0).reshape(scale.shape))
    t = torch.empty_like(x) if scratch is None else scratch
    torch.div(x, scale, out=t)
    q.copy_(t.round_().clamp_(-127, 127))
    return q, scale


def dequant_features(x):
    """A dense feature tensor as it is, or the int8 feed's {"q", "scale"}
    as bf16 ``q.bf16 * scale.bf16`` (the JAX steps' dequantization).  Call
    at each place of use: a triplet gather runs on the int8 tensor first
    (``take_features``)."""
    if isinstance(x, dict) and "q" in x:
        return x["q"].to(torch.bfloat16) * x["scale"].to(torch.bfloat16)
    return x


def take_features(x, idx: torch.Tensor):
    """Row gather in the feed's storage type (int8 rows stay int8)."""
    if isinstance(x, dict) and "q" in x:
        return {k: v.index_select(0, idx) for k, v in x.items()}
    return x.index_select(0, idx)


def feature_keys(cfg) -> dict:
    """The placer's cast arguments for a config: the events cast to bf16 on
    the host under --bf16_features, quantized to int8 under
    --int8_features (the JAX ``feature_caster`` and ``int8_keys``)."""
    return {"bf16_keys": ("events",) if cfg.bf16_features else (),
            "int8_keys": ("events",) if cfg.int8_features else ()}


def _tensors(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x


class BatchPlacer:
    """The JAX ``make_batch_placer``'s counterpart.  ``place(batch)``
    stages and uploads one host batch (on the feed thread);
    ``receive(placed)`` hands it to the calling thread's stream (on the
    consumer).  ``placer(batch)`` does both on one thread.

    A batch is a dict of NumPy arrays.  Entries named in ``device_keys``
    go to ``device`` (missing ones are skipped; the rest stay on the host);
    an optional ``rows`` entry selects their rows first, gathered straight
    into the staging buffer.  ``bf16_keys`` are cast to bfloat16 (round to
    nearest even), ``int8_keys`` quantized to {"q", "scale"}.  ``None``
    passes through (a loader draw with nothing to train on)."""

    def __init__(self, device, device_keys: Sequence[str],
                 bf16_keys: Sequence[str] = (),
                 int8_keys: Sequence[str] = ()):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"cannot feed device {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            # the caller's card: the feed thread's own current device is
            # cuda:0, whatever the caller's is
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.device_keys = tuple(device_keys)
        self.bf16 = frozenset(bf16_keys)
        self.int8 = frozenset(int8_keys)
        self._layout = None    # key -> (kind, shape, dtype), fixed by batch 1
        self._ring = []        # DEPTH + 1 slots of {"bufs", "event"}
        self._scratch = {}     # key -> f32 [2, chunk, ...] for cast keys
        self._next = 0
        self._stream = None

    def _kind(self, key: str) -> str:
        return ("int8" if key in self.int8 else
                "bf16" if key in self.bf16 else "plain")

    def _layout_of(self, batch) -> Dict[str, tuple]:
        rows = batch.get("rows")
        layout = {}
        for key in self.device_keys:
            if key not in batch:
                continue
            a = np.asarray(batch[key])
            n = a.shape[0] if rows is None else len(rows)
            kind = self._kind(key)
            dtype = (torch.bfloat16 if kind == "bf16" else
                     torch.float32 if kind == "int8" else
                     torch.from_numpy(a[:0]).dtype)
            layout[key] = (kind, (n,) + a.shape[1:], dtype)
        return layout

    @staticmethod
    def _alloc(spec, pin: bool):
        kind, shape, dtype = spec
        if kind == "int8":
            return {"q": torch.empty(shape, dtype=torch.int8,
                                     pin_memory=pin),
                    "scale": torch.empty(_scale_shape(shape),
                                         dtype=torch.float32,
                                         pin_memory=pin)}
        return torch.empty(shape, dtype=dtype, pin_memory=pin)

    def _slot(self):
        """The next ring slot, its buffers free for refilling."""
        if not self._ring:
            # on this thread, whose current device is not the caller's
            with torch.cuda.device(self.device):
                self._stream = torch.cuda.Stream(device=self.device)
                for _ in range(DEPTH + 1):
                    self._ring.append({
                        "bufs": {k: self._alloc(s, pin=True)
                                 for k, s in self._layout.items()},
                        "event": torch.cuda.Event()})
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        # the copy that last read these buffers must be done
        slot["event"].synchronize()
        return slot

    def stage(self, batch):
        """Gather, cast or quantize the device keys into host buffers:
        the next pinned ring slot on ``cuda``, new tensors on the CPU.
        Returns (host buffers by key, ring slot or None)."""
        layout = self._layout_of(batch)
        if self._layout is None:
            self._layout = layout
        elif layout != self._layout:
            raise ValueError(f"feed batch layout changed: {layout} after "
                             f"{self._layout}; the feed's shapes are fixed "
                             "(its pinned ring holds them)")
        slot = None
        if self.device.type == "cuda":
            slot = self._slot()
            bufs = slot["bufs"]
        else:
            bufs = {k: self._alloc(s, pin=False) for k, s in layout.items()}
        rows = batch.get("rows")
        if rows is not None:
            rows = torch.from_numpy(np.asarray(rows, np.int64))
        for key, (kind, shape, _) in layout.items():
            src = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if kind != "plain" and key not in self._scratch:
                # two f32 chunks, reused for every batch: a fresh large
                # temporary a chunk would be mapped and faulted in anew
                self._scratch[key] = torch.empty(
                    (2, min(_CHUNK, shape[0])) + shape[1:])
            _fill(src, rows, kind, bufs[key], self._scratch.get(key))
        return bufs, slot

    def upload(self, batch, bufs, slot):
        """The batch with its device keys replaced by ``device`` tensors,
        and the event that marks their copy done (None on the CPU)."""
        out = {k: v for k, v in batch.items() if k != "rows"}
        if slot is None:
            out.update(bufs)
            return out, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for key, buf in bufs.items():
                out[key] = _to_device(buf, self.device)
            slot["event"].record(self._stream)
        return out, slot["event"]

    def place(self, batch):
        if batch is None:
            return None
        return self.upload(batch, *self.stage(batch))

    def receive(self, placed):
        """The placed batch, ready on the calling thread's current stream."""
        if placed is None:
            return None
        out, event = placed
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for key in self.device_keys:
                for t in _tensors(out.get(key)):
                    t.record_stream(stream)
        return out

    def __call__(self, batch):
        return self.receive(self.place(batch))


def _fill(src: torch.Tensor, rows: Optional[torch.Tensor], kind: str, out,
          scratch: Optional[torch.Tensor]):
    """src[rows] (or src) into ``out``, cast or quantized by ``kind``, a
    chunk of rows at a time through ``scratch``."""
    if kind == "plain":
        if rows is None:
            out.copy_(src)
        else:
            torch.index_select(src, 0, rows, out=out)
        return
    n = (out["q"] if kind == "int8" else out).shape[0]
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        part = src[lo:hi]
        if rows is not None:
            part = torch.index_select(src, 0, rows[lo:hi],
                                      out=scratch[0, :hi - lo])
        if kind == "bf16":
            out[lo:hi].copy_(part)
        else:
            quantize_features(part, out=(out["q"][lo:hi],
                                         out["scale"][lo:hi]),
                              scratch=scratch[1, :hi - lo])


def _to_device(buf, device):
    if isinstance(buf, dict):
        return {k: _to_device(v, device) for k, v in buf.items()}
    return torch.empty(buf.shape, dtype=buf.dtype, device=device).copy_(
        buf, non_blocking=True)


def device_prefetch(batches: Iterable[Optional[dict]], device,
                    device_keys: Sequence[str],
                    bf16_keys: Sequence[str] = (),
                    int8_keys: Sequence[str] = ()):
    """Yield ``batches`` with ``device_keys`` on ``device``.

    The source iterator itself (so any selection it does), the staging and
    the upload run on a background thread ``DEPTH`` batches ahead; each
    batch is handed over on the consumer's stream.  Closing the generator
    cancels the thread."""
    placer = BatchPlacer(device, device_keys, bf16_keys, int8_keys)
    placed_batches = _prefetched(batches, placer.place, DEPTH)
    try:
        for placed in placed_batches:
            yield placer.receive(placed)
    finally:
        placed_batches.close()
