"""The program's own spans and counters, as the per-layer metrics of a
traced run read them.

The port records spans only while a profiler runs in its thread
(``multimodal_similarity_tpu_torch/utils/profiling.py``), so in a
``--trace 1`` run its newest session is the traced window: each span's
host interval on ``time.perf_counter``'s clock, its card interval (CUDA
events on the current stream, mapped onto the same clock), its parent and
its unit, and what the program counted while it recorded.  A phase's
"card ms" is its spans' card-side self time (the card interval less the
union of the children's), "host ms" the host-side self time; both are
summed over the window and divided by its units of work
(``run.trace["counters"]["attempted"]``: steps, calls, batches).

A program that keeps no spans (one older than them), a session without
the phase, or spans without card stamps (no card) give None, never a
wrong 0.
"""

from __future__ import annotations

from typing import Optional, Sequence


def session(run):
    """The program's newest session of spans, or None."""
    if not run.trace:
        return None
    try:
        from multimodal_similarity_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "session", None)
    sess = read() if read is not None else None
    return sess if sess is not None and sess.spans else None


def _units(run) -> Optional[float]:
    return (run.trace or {}).get("counters", {}).get("attempted") or None


def self_ms(run, names: Sequence[str], card: bool) -> Optional[float]:
    """The self time of the spans named ``names`` a unit of the traced
    window, in ms, on the card's clock (``card``) or the host's."""
    sess, units = session(run), _units(run)
    if sess is None or units is None:
        return None
    picked = [t for s, t in zip(sess.spans, sess.self_times(card=card))
              if s.name in names]
    if not picked or any(t is None for t in picked):
        return None
    return 1e3 * sum(picked) / units


def card_ms(run, *names: str) -> Optional[float]:
    return self_ms(run, names, card=True)


def host_ms(run, *names: str) -> Optional[float]:
    return self_ms(run, names, card=False)


def exit_lag_ms(run, name: str) -> Optional[float]:
    """The mean over the spans ``name`` of the card's time at the span's
    exit boundary less the host's, in ms: about 0 where the card waits on
    the host, the card's backlog where the host runs ahead."""
    sess = session(run)
    if sess is None:
        return None
    ends = [(s.card_end, s.host_end) for s in sess.spans if s.name == name]
    if not ends or any(card is None for card, _ in ends):
        return None
    return 1e3 * sum(card - host for card, host in ends) / len(ends)


def counted_share(run, parts: Sequence[str], whole: str) -> Optional[float]:
    """100 x the sum of the counters ``parts`` over the counter ``whole``,
    as the program counted them in the traced window."""
    sess = session(run)
    if sess is None or not sess.counters.get(whole):
        return None
    return 100.0 * sum(sess.counters.get(p, 0) for p in parts) \
        / sess.counters[whole]
