"""Profiling: the program's spans and counters, and the ``--profile_dir``
trace.

Spans.  ``with span(name):`` marks a phase of the program at a layer
boundary.  It records only while a ``torch.profiler`` profile runs in the
calling thread (``recording()``: the ``--profile_dir`` window, or any
caller's profile); otherwise it costs one flag check and hands back a
shared no-op context manager.  The first span of a profile opens a
session: one ``torch.cuda.synchronize()``, an anchor event on the current
stream and the host's clock beside it.  Each span then keeps its name, the
span it nests in, its unit (the step, call or batch it belongs to: a span
opened with ``unit=True`` starts one, the spans inside it share its id),
its host interval on ``time.perf_counter``'s clock and, where CUDA is in
use, a timing event recorded on the current stream at entry and one at
exit.  Nothing is synchronised and nothing is read back until the session
is read: ``session()`` waits for the card once, maps every event onto the
host's clock through the anchor and returns the spans.  A span that finds
the profiler stopped closes the session.

Counters.  ``count(name, n)`` adds to one registry, always on; names are
dotted by layer (``cache.gather``, ``native.parse``, ``mm.hard_fired``).
A session also keeps what its thread counted while it recorded.

The trace.  ``StepWindowProfiler`` writes a Chrome trace
(``*.pt.trace.json``; open it in Perfetto, ui.perfetto.dev, or
``chrome://tracing``) of a window of steady train steps, CPU and CUDA
activity where a card is visible, and merges the window's spans into it on
two tracks of their own: their host intervals, nested over the operations
they issued, and their card intervals.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

# True while a torch.profiler profile runs in the calling thread: the
# profiler's own flag (CPU or CUDA activities alike)
recording = torch._C._autograd._profiler_enabled

# -- counters -----------------------------------------------------------------

_COUNTS: Dict[str, float] = {}
_COUNT_LOCK = threading.Lock()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (any thread); while the thread
    records, to its open session's too."""
    with _COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _LIVE is not None and recording():
        _LIVE.gained[name] = _LIVE.gained.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, float]:
    """The counters whose names start with ``prefix``, the prefix cut
    off."""
    with _COUNT_LOCK:
        return {k[len(prefix):]: v for k, v in _COUNTS.items()
                if k.startswith(prefix)}


def reset_counts(prefix: str = "", names: Iterable[str] = ()) -> None:
    """Drop the counters under ``prefix``, then set ``prefix + name`` to 0
    for each of ``names``."""
    with _COUNT_LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]
        for name in names:
            _COUNTS[prefix + name] = 0


# -- spans --------------------------------------------------------------------


class Span(NamedTuple):
    """One span of a read session; times in seconds on ``perf_counter``'s
    clock, the card's None where no event was recorded."""

    name: str
    parent: Optional[int]     # the enclosing span's index in the session
    unit: Optional[int]       # the id of the unit the span belongs to
    host_start: float
    host_end: float
    card_start: Optional[float]
    card_end: Optional[float]


@dataclass
class Session:
    """The spans of one profile, in entry order, and what its thread
    counted while it recorded; ``opened`` on ``perf_counter``'s clock,
    ``unix_offset`` Unix time less that clock (seconds)."""

    spans: List[Span]
    counters: Dict[str, float]
    opened: float
    unix_offset: float

    def self_times(self, card: bool = False) -> List[Optional[float]]:
        """Each span's self time in seconds: its interval less the union
        of its children's, on the host's clock or, with ``card``, the
        card's; None where the span or a child has no card stamps."""
        kids: List[List[int]] = [[] for _ in self.spans]
        for i, s in enumerate(self.spans):
            if s.parent is not None:
                kids[s.parent].append(i)

        def interval(s):
            return (s.card_start, s.card_end) if card else (s.host_start,
                                                            s.host_end)

        out: List[Optional[float]] = []
        for i, s in enumerate(self.spans):
            lo, hi = interval(s)
            inner = [interval(self.spans[j]) for j in kids[i]]
            if None in (lo, hi) or any(None in iv for iv in inner):
                out.append(None)
                continue
            covered, cursor = 0.0, lo
            for a, b in sorted(inner):
                a, b = max(a, cursor), min(b, hi)
                if b > a:
                    covered += b - a
                    cursor = b
            out.append(hi - lo - covered)
        return out


_POOL: List[torch.cuda.Event] = []


def _record(live: "_Live") -> torch.cuda.Event:
    """A pooled timing event recorded on the current stream.  The
    stream's Python object is made again only when the current stream
    changes: ``torch.cuda.current_stream()`` costs the card's host about
    twice the record itself."""
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    if key != live.stream_key:
        live.stream_key, live.stream = key, torch.cuda.current_stream()
    ev.record(live.stream)
    return ev


class _Live:
    """The open session: what the spans of the profiling thread record."""

    def __init__(self):
        self.thread = threading.get_ident()
        # [name, parent, unit, host start ns, host end ns, event, event]
        self.records: List[list] = []
        self.stack: List[int] = []
        self.units = 0
        self.gained: Dict[str, float] = {}     # counted while recording
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.stream_key = self.stream = self.anchor = None
        if self.cuda:
            torch.cuda.synchronize()
            self.anchor = _record(self)
        self.opened_ns = time.perf_counter_ns()
        self.unix_offset = (time.time_ns() - time.perf_counter_ns()) / 1e9

    def close(self) -> None:
        now = time.perf_counter_ns()
        for i in self.stack:            # spans left open end here
            self.records[i][4] = now
        self.stack = []

    def events(self):
        yield self.anchor
        for rec in self.records:
            yield rec[5]
            yield rec[6]

    def read(self) -> Session:
        """Wait for the card once, then map every event onto the host's
        clock through the anchor; the events go back to the pool."""
        if self.cuda:
            torch.cuda.synchronize()
        base = self.opened_ns / 1e9

        def card(ev):
            if ev is None:
                return None
            try:
                return base + self.anchor.elapsed_time(ev) / 1e3
            except RuntimeError:        # recorded on another device
                return None

        spans = [Span(name, parent, unit, t0 / 1e9, t1 / 1e9, card(e0),
                      card(e1))
                 for name, parent, unit, t0, t1, e0, e1 in self.records]
        _POOL.extend(ev for ev in self.events() if ev is not None)
        self.records = []
        return Session(spans, self.gained, base, self.unix_offset)


_LIVE: Optional[_Live] = None      # the open session
_CLOSED: Optional[_Live] = None    # the newest closed one, not yet read
_READ: Optional[Session] = None    # the newest read one


def _close_live() -> None:
    global _LIVE, _CLOSED
    _LIVE.close()
    _LIVE, _CLOSED = None, _LIVE


def _open_live() -> _Live:
    global _LIVE, _CLOSED, _READ
    live = _Live()
    if _CLOSED is not None:
        # the anchor's synchronize finished every event it holds
        _POOL.extend(ev for ev in _CLOSED.events() if ev is not None)
        _CLOSED = None
    _LIVE, _READ = live, None
    return live


class _Span:
    __slots__ = ("name", "unit", "live", "rec")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self):
        live = _LIVE if _LIVE is not None else _open_live()
        parent = live.stack[-1] if live.stack else None
        if self.unit:
            live.units += 1
            unit = live.units
        else:
            unit = None if parent is None else live.records[parent][2]
        rec = [self.name, parent, unit, 0, 0, None, None]
        live.stack.append(len(live.records))
        live.records.append(rec)
        if live.cuda:
            rec[5] = _record(live)
        rec[3] = time.perf_counter_ns()
        self.live, self.rec = live, rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[4] = time.perf_counter_ns()
        if self.live.cuda:
            rec[6] = _record(self.live)
        if self.live.stack:
            self.live.stack.pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):   # no *args: no tuple built
        return False


_OFF = _Off()


def span(name: str, unit: bool = False):
    """A context manager marking the phase ``name``; ``unit=True`` starts a
    unit (a step, a call, a batch) that the spans inside it share.
    Records only while a profile runs in this thread."""
    if not recording():
        if _LIVE is not None and _LIVE.thread == threading.get_ident():
            _close_live()
        return _OFF
    return _Span(name, unit)


def session() -> Optional[Session]:
    """The newest session, read once and kept (an open one is closed
    first); None before any."""
    global _CLOSED, _READ
    if _LIVE is not None:
        _close_live()
    if _CLOSED is not None:
        _READ, _CLOSED = _CLOSED.read(), None
    return _READ


# -- the --profile_dir trace ------------------------------------------------

# the tracks of the merged spans, in the trace's own process
_HOST_TRACK, _CARD_TRACK = 0x5350414E, 0x5350414F


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start_profile() -> torch.profiler.profile:
    """A started profiler; device work queued before it finishes first, so
    the trace holds only what is launched inside the window."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop_profile(prof: torch.profiler.profile, path: str) -> str:
    """Stop ``prof`` once the queued device work has finished, and write
    its Chrome trace to ``path``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def _merge_spans(path: str, sess: Session) -> None:
    """Add the spans of ``sess`` to the Chrome trace at ``path``: host
    intervals and card intervals on two tracks of the trace's process.
    The trace's ``ts`` (us) plus ``baseTimeNanoseconds`` / 1e3 is Unix
    time; the session knows Unix time less ``perf_counter``'s."""
    with open(path) as f:
        trace = json.load(f)
    offset = (1e6 * sess.unix_offset
              - trace.get("baseTimeNanoseconds", 0) / 1e3)
    pid = os.getpid()
    events = trace["traceEvents"]
    for tid, label in ((_HOST_TRACK, "program spans (host)"),
                       (_CARD_TRACK, "program spans (card)")):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": label}})
    for s in sess.spans:
        args = {"unit": s.unit,
                "parent": None if s.parent is None
                else sess.spans[s.parent].name}
        for tid, lo, hi in ((_HOST_TRACK, s.host_start, s.host_end),
                            (_CARD_TRACK, s.card_start, s.card_end)):
            if lo is not None and hi is not None:
                events.append({"ph": "X", "cat": "program_span",
                               "name": s.name, "pid": pid, "tid": tid,
                               "ts": 1e6 * lo + offset,
                               "dur": 1e6 * (hi - lo), "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


class StepWindowProfiler:
    """Trace a window of steady-state train steps (``--profile_dir``).

    ``update(step)`` starts a ``torch.profiler`` trace when ``step``
    reaches ``start_step`` (default 1: AFTER the first step, so the trace
    shows the steady per-step timeline, not the one-time warm-up) and stops
    it ``num_steps`` steps later, writing ``trace_path`` with the window's
    spans merged in.  The window is relative to the first observed step,
    so a run resumed from a checkpoint still traces ``num_steps`` steps.
    Call ``close()`` on trainer exit so an interrupted window still writes
    its trace.  No-op when ``log_dir`` is empty.
    """

    def __init__(self, log_dir: str, num_steps: int = 5,
                 start_step: int = 1):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._base = None  # first observed step: windows are RELATIVE so
        self._prof = None  # checkpoint-resumed runs still trace num_steps
        self._first = self._last = None
        self._since = None
        self._done = not log_dir

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def update(self, step: int) -> None:
        if self._done:
            return
        if self._base is None:
            # the first observed step is the warm-up step regardless of the
            # restored step count
            self._base = step - 1
        rel = step - self._base
        self._last = step
        if not self._active and rel >= self.start_step:
            self._first = step + 1
            self._since = time.perf_counter()
            self._prof = _start_profile()
        elif self._active and rel >= self.stop_step:
            self._finish()

    def _finish(self) -> None:
        path = os.path.join(self.log_dir, f"trace_steps{self._first}-"
                            f"{self._last}.pt.trace.json")
        prof, self._prof = self._prof, None
        self.trace_path = _stop_profile(prof, path)
        sess = session()
        if sess is not None and sess.opened >= self._since:
            _merge_spans(self.trace_path, sess)
        self._done = True

    def close(self) -> None:
        """End the window; an open one is written with the steps it
        holds."""
        if self._active:
            self._finish()
        self._done = True
