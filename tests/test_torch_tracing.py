"""The port's spans and counters (``utils/profiling.py``) on the CPU: a
span records nothing while no profiler runs; under ``torch.profiler`` the
spans nest with their parents and units, a session closes when the
profile stops, the counters (the device cache's and the native path's
among them) add up, the flagship's cached step gives the same scalars
with recording on as off and opens every phase once a step, so do the
CUB trainer's steps, and a ``--profile_dir`` trace holds the spans on the
trace's own clock."""

import itertools
import json
import os
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import device_cache, native
from multimodal_similarity_tpu_torch.data.synthetic import (
    generate_synthetic_honda)
from multimodal_similarity_tpu_torch.train.cached_steps import (
    make_cached_body_step)
from multimodal_similarity_tpu_torch.train.trainers import (
    multimodal_model as mm)
from multimodal_similarity_tpu_torch.train.trainers import base_CUB
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)
from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
from multimodal_similarity_tpu_torch.utils import profiling
from multimodal_similarity_tpu_torch.utils.profiling import (
    Session, Span, count, span)

MM_PHASES = ("mm.embed", "mm.mine_semihard", "mm.branches",
             "mm.mine_rowwise", "mm.pddm", "mm.take", "mm.forward_loss",
             "mm.backward", "mm.optimizer")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _peak_bytes(body, n: int) -> int:
    """The peak of traced allocations while ``body`` runs ``n`` times,
    above what was held before."""
    tracemalloc.start()
    try:
        current, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, n):
            body()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return peak - current


def test_span_off_records_nothing_and_allocates_nothing():
    """With no profiler running a span hands back the one shared no-op
    context manager: no session opens, and entering spans allocates no
    more than entering that object alone."""
    before = profiling.session()
    assert not profiling.recording()
    off = span("a")
    assert span("b", unit=True) is off

    def spans():
        with span("x"):
            with span("y", unit=True):
                pass

    def shared():
        with off:
            with off:
                pass

    for body in (spans, shared):        # warm the call paths
        body()
    assert _peak_bytes(spans, 10000) == _peak_bytes(shared, 10000)
    assert _peak_bytes(spans, 10000) == _peak_bytes(spans, 1)
    assert profiling._LIVE is None
    assert profiling.session() is before


def test_spans_nest_with_parents_units_and_self_time():
    with _cpu_profile():
        with span("call", unit=True):
            with span("a"):
                time.sleep(0.002)
            with span("b"):
                with span("b.inner"):
                    time.sleep(0.002)
            time.sleep(0.001)
        with span("call", unit=True):
            with span("a"):
                pass
        with span("loose"):
            pass
    sess = profiling.session()
    names = [s.name for s in sess.spans]
    assert names == ["call", "a", "b", "b.inner", "call", "a", "loose"]
    assert [s.parent for s in sess.spans] == [None, 0, 0, 2, None, 4, None]
    assert [s.unit for s in sess.spans] == [1, 1, 1, 1, 2, 2, None]
    # no card here: host stamps alone
    assert all(s.card_start is None and s.card_end is None
               for s in sess.spans)
    for s in sess.spans:
        assert s.host_start <= s.host_end
        if s.parent is not None:
            p = sess.spans[s.parent]
            assert p.host_start <= s.host_start <= s.host_end <= p.host_end
    host = sess.self_times()
    dur = [s.host_end - s.host_start for s in sess.spans]
    assert host[0] == pytest.approx(dur[0] - dur[1] - dur[2], abs=1e-9)
    assert host[2] == pytest.approx(dur[2] - dur[3], abs=1e-9)
    assert host[3] == pytest.approx(dur[3]) and host[3] >= 0.002
    assert host[0] >= 0.001
    assert sess.self_times(card=True) == [None] * 7


def test_self_times_take_the_union_of_children():
    """Overlapping children count once; a child reaching past its parent
    is clipped; a span or child without card stamps has no card time."""
    spans = [Span("p", None, 1, 0.0, 10.0, 100.0, 120.0),
             Span("c1", 0, 1, 1.0, 4.0, 102.0, 106.0),
             Span("c2", 0, 1, 3.0, 5.0, 105.0, 125.0),
             Span("q", None, 2, 11.0, 12.0, None, None),
             Span("r", None, None, 13.0, 15.0, 130.0, 131.0),
             Span("r.c", 4, None, 13.5, 14.0, None, None)]
    sess = Session(spans, {}, 0.0, 0.0)
    assert sess.self_times() == pytest.approx([6.0, 3.0, 2.0, 1.0, 1.5,
                                               0.5])
    card = sess.self_times(card=True)
    assert card[:3] == pytest.approx([2.0, 4.0, 20.0])
    assert card[3:] == [None, None, None]


def test_session_closes_when_the_profiler_stops():
    """The first span after the profile stops closes the session, which
    keeps what was counted while it recorded; a second profile opens a new
    session."""
    with _cpu_profile():
        with span("first", unit=True):
            count("test.tracing.inside", 2)
    count("test.tracing.after", 1)
    with span("outside"):
        pass
    assert profiling._LIVE is None
    sess = profiling.session()
    assert [s.name for s in sess.spans] == ["first"]
    assert sess.counters.get("test.tracing.inside") == 2
    assert "test.tracing.after" not in sess.counters
    assert profiling.session() is sess
    with _cpu_profile():
        with span("second"):
            pass
    again = profiling.session()
    assert again is not sess
    assert [s.name for s in again.spans] == ["second"]
    assert again.opened > sess.opened


def test_counters_and_the_folded_counts():
    profiling.reset_counts("test.counts.")
    count("test.counts.a")
    count("test.counts.a", 2.5)
    count("test.counts.b", 0)
    assert profiling.counters("test.counts.") == {"a": 3.5, "b": 0}
    profiling.reset_counts("test.counts.", ("a", "c"))
    assert profiling.counters("test.counts.") == {"a": 0, "c": 0}
    native.reset_counts()
    assert profiling.counters("native.") == dict.fromkeys(native.PATHS, 0)
    count("native.parse")
    assert profiling.counters("native.")["parse"] == 1
    device_cache.reset_counts()
    assert profiling.counters("cache.") == {"build": 0, "gather": 0}
    assert profiling.counters()["test.counts.c"] == 0


# -- the flagship's cached step ------------------------------------------------

DIMS = {"resnet": (2, 2, 8), "sensors": (8,), "segment": (12,)}


@pytest.fixture(scope="module")
def honda_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing"))
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims=DIMS, seed=0, length_range=(4, 16))
    return root


def _flagship_epoch(root, result_dir, recorded: bool):
    """One cached epoch of the fused flagship step, built from the seeds;
    -> (each step's scalars, the session or None)."""
    cfg = TrainConfig(
        DATA_ROOT=root, name="trace", network="convrtsn", n_input=8, n_h=2,
        n_w=2, n_C=4, num_seg=3, emb_dim=16, feat="resnet,sensors,segment",
        event_per_batch=48, sess_per_batch=1, triplet_per_batch=12,
        num_negative=3, lambda_multimodal=0.5, keep_prob=0.5,
        learning_rate=0.01, device_mining=True, device_cache=True,
        steps_per_dispatch=2, seed=7).resolve()
    exp = HondaExperiment(cfg, modalities=cfg.feat, supports_int8=True,
                          result_dir=result_dir)
    try:
        cache = exp.build_cache("cpu")
        model = mm.build_model(cfg, "cpu", sensors=8, segment=12)
        opt = mm.mm_optimizer(cfg, model)
        margins = mm.margin_table({c: [0.1 + 0.05 * c] for c in range(12)},
                                  "cpu")
        fused = mm.make_mm_fused_step(
            model, opt, cfg, torch.Generator().manual_seed(cfg.seed + 2))
        step = make_cached_body_step(
            lambda ev, lab, m, lr: fused(*ev, lab, m, margins, 1.0, lr),
            cache, torch.Generator().manual_seed(cfg.seed + 3))
        got = []

        def kept(plan, lr):
            out = step(plan, lr)
            got.append({k: v.detach().clone() for k, v in out.items()})
            return out

        def echo(e, s, sc):
            return mm._echo(cfg, e, s, sc["loss"], sc["triplet_count"],
                            sc["hard_count"], sc["struct_count"])

        if recorded:
            with _cpu_profile():
                exp.run_cached_epoch(cache, kept, cfg.learning_rate, 0, 0,
                                     echo)
            return got, profiling.session(), cfg
        exp.run_cached_epoch(cache, kept, cfg.learning_rate, 0, 0, echo)
        return got, None, cfg
    finally:
        exp.close()


def test_flagship_step_is_the_same_with_recording_on(honda_root, tmp_path):
    """The same scalars, bit for bit, with recording on as off; every
    phase of the fused step opens once a step, inside that step's unit;
    the mined counts arrive through the flush."""
    off, _, _ = _flagship_epoch(honda_root, str(tmp_path / "off"), False)
    on, sess, cfg = _flagship_epoch(honda_root, str(tmp_path / "on"), True)
    assert len(off) == len(on) >= 2
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    names = [s.name for s in sess.spans]
    steps = [i for i, n in enumerate(names) if n == "trainer.step"]
    assert len(steps) == len(on)
    assert names.count("cache.plan") == 1
    assert names.count("trainer.flush") >= 1
    for i in steps:
        unit = sess.spans[i].unit
        inside = [s.name for s in sess.spans if s.unit == unit]
        assert inside[:2] == ["trainer.step", "cache.gather"]
        assert sorted(inside[2:]) == sorted(MM_PHASES)
    pddm = names.index("mm.pddm")
    assert sess.spans[sess.spans[pddm].parent].name == "mm.mine_rowwise"
    gained = sess.counters
    assert gained["mm.triplet_budget"] == len(on) * (12 + 12 + 6)
    for key, col in (("mm.semihard_fired", "triplet_count"),
                     ("mm.hard_fired", "hard_count"),
                     ("mm.struct_fired", "struct_count")):
        assert gained.get(key, 0) == sum(float(o[col]) for o in on)
    assert gained["cache.gather"] == len(on)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """``StepWindowProfiler`` merges the window's spans into its trace on
    a track of their own; a ``record_function`` opened inside a span lies
    inside that span's exported interval, within 0.1 ms."""
    prof = profiling.StepWindowProfiler(str(tmp_path), num_steps=1)
    prof.update(1)                     # the window opens
    with span("trainer.step", unit=True):
        time.sleep(0.001)
        with span("phase"):
            with record_function("probe"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.001)
    prof.update(2)                     # the window closes
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "program_span"}
    assert set(spans) == {"trainer.step", "phase"}
    assert spans["phase"]["args"] == {"unit": 1, "parent": "trainer.step"}
    assert {e["tid"] for e in spans.values()} == {profiling._HOST_TRACK}
    assert any(e.get("ph") == "M" and e["tid"] == profiling._HOST_TRACK
               and e["args"] == {"name": "program spans (host)"}
               for e in events)
    probe = next(e for e in events if e.get("name") == "probe"
                 and e.get("ph") == "X")
    ph = spans["phase"]
    assert probe["ts"] >= ph["ts"] - 100
    assert probe["ts"] + probe["dur"] <= ph["ts"] + ph["dur"] + 100
    outer = spans["trainer.step"]
    assert outer["ts"] <= ph["ts"] and (ph["ts"] + ph["dur"]
                                        <= outer["ts"] + outer["dur"] + 1)
    assert os.path.basename(prof.trace_path) == "trace_steps2-2.pt.trace.json"
    assert ph["dur"] > 0 and outer["dur"] > 0


# -- the CUB trainer's step ----------------------------------------------------

CUB_PHASES = ("cub.sample", "cub.upload", "cub.crop", "cub.tower",
              "cub.loss", "cub.backward", "cub.optimizer")


def _cub_steps(result_dir, n: int):
    """``n`` steps of ``CUBTrainer`` (the ConvBackbone tower) from the
    seeds; -> each step's loss."""
    cfg = TrainConfig(name="trace", network="conv", emb_dim=8,
                      batch_size=32, learning_rate=1e-2, seed=5,
                      silent_mode=True).resolve()
    rng = torch.Generator().manual_seed(0)
    labels = torch.arange(4).repeat_interleave(12).numpy()
    images = torch.rand(48, 20, 20, 3, generator=rng).numpy()
    model = base_CUB.build_model(cfg, "cpu")
    opt = base_CUB.build_optimizer(cfg.optimizer, model, cfg.learning_rate)
    trainer = base_CUB.CUBTrainer(cfg, model, opt, images, labels, 16,
                                  "cpu", MetricsLogger(result_dir))
    return [float(trainer.step(cfg.learning_rate)["loss"])
            for _ in range(n)]


def test_cub_spans_nest_under_the_step(tmp_path):
    """Without a profile the CUB steps record nothing; under one each step
    is a ``cub.step`` unit holding its seven phases once, in order, with
    ``cub.log`` after it; the losses are the same either way, and the
    counters hold the images and bytes uploaded."""
    before = profiling.session()
    off = _cub_steps(str(tmp_path / "off"), 3)
    assert profiling.session() is before
    with _cpu_profile():
        on = _cub_steps(str(tmp_path / "on"), 3)
    assert on == off
    sess = profiling.session()
    names = [s.name for s in sess.spans]
    steps = [i for i, n in enumerate(names) if n == "cub.step"]
    assert len(steps) == 3 and names.count("cub.log") == 3
    for i in steps:
        step = sess.spans[i]
        assert step.parent is None and step.unit is not None
        inside = [s for s in sess.spans if s.unit == step.unit]
        assert [s.name for s in inside] == ["cub.step", *CUB_PHASES]
        assert all(sess.spans[s.parent] is step for s in inside[1:])
        log = sess.spans[i + len(CUB_PHASES) + 1]
        assert log.name == "cub.log" and log.parent is None
        assert log.host_start >= step.host_end
    assert sess.counters["cub.images"] == 3 * 32
    assert sess.counters["cub.upload_bytes"] == 3 * 32 * (20 * 20 * 3 * 4
                                                          + 8)
