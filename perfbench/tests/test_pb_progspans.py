"""The readers of the program's spans and counters: each kind's window
under a CPU profiler at tiny sizes (the host-side readers read numbers,
the card-side ones None), the reduction on hand-made spans, and a card
test that the phases of a unit add up to the traced window's time a
unit."""

import os
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT
from perfbench import harness, progspans

CELLS = ("mm_flagship.train_cached", "rtsn_base.retrieval_400k",
         "rtsn_base.extract_720p")
HOST_SIDE = {"flush_wait_ms.train", "host_ms.meta.query",
             "mined_row_share.train"}
# each cell's card-side phases, which tile its unit of work
CARD_PHASES = {
    "mm_flagship.train_cached": [
        f"phase_ms.{p}.train" for p in ("gather", "encode", "pddm", "mine",
                                        "forward", "backward", "adam")],
    "rtsn_base.retrieval_400k": [
        f"phase_ms.{p}.query" for p in ("upload", "product", "select",
                                        "readback")],
    "rtsn_base.extract_720p": [
        f"phase_ms.{p}.extract" for p in ("upload", "resize", "trunk",
                                          "readback")],
}
# the phases on the host alone, while the card idles: with the card's,
# they tile the unit
IDLE_PHASES = {"rtsn_base.retrieval_400k": ["host_ms.meta.query"]}
UNIT_SPAN = {"mm_flagship.train_cached": "trainer.step",
             "rtsn_base.retrieval_400k": "serving.query",
             "rtsn_base.extract_720p": "features.embed"}


def _reader(cell, name):
    return harness.load_module(
        os.path.join(cell.bench_root, "perfbench", "metrics", name + ".py"),
        "perfbench_metric_" + name.replace(".", "_"))


def _span_metrics(cell):
    return [m["name"] for m in cell.per_layer
            if m["name"] in HOST_SIDE or m["name"] in CARD_PHASES[cell.name]
            or m["name"] == "device_lag_ms.train"]


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_a_cpu_window(tiny_root, name):
    """A window under a CPU profiler: every reader of the program's spans
    that the cell lists is there; the host-side ones read numbers, the
    card-side ones, with no card stamps, None."""
    cell = harness.load_cell(name, bench_root=tiny_root)
    names = _span_metrics(cell)
    assert set(CARD_PHASES[name]) <= set(names)
    run = harness.Run(cell=cell, seed=2 ** 31 + 19,
                      device=torch.device("cpu"))
    state = cell.kind.setup(run)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            cell.kind.window(state, 0.3)
        run.trace = {"counters": dict(run.counters)}
        got = {m: _reader(cell, m).read(run) for m in names}
    finally:
        cell.kind.release(state)
    assert run.trace["counters"]["attempted"] > 0
    for m, value in got.items():
        if m in HOST_SIDE:
            assert value is not None and value >= 0, m
            if m != "mined_row_share.train":
                assert value > 0, m
        else:
            assert value is None, (m, value)
    if name == "mm_flagship.train_cached":
        assert got["mined_row_share.train"] <= 100


def test_readers_find_nothing_without_a_traced_window():
    run = SimpleNamespace(trace=None)
    assert progspans.session(run) is None
    assert progspans.card_ms(run, "cache.gather") is None
    assert progspans.host_ms(run, "serving.meta") is None


def test_reduction_on_hand_made_spans(monkeypatch):
    """Self time a unit, the exit lag and a counted share."""
    from multimodal_similarity_tpu_torch.utils.profiling import Session, Span
    spans = [
        Span("trainer.step", None, 1, 0.000, 0.010, 0.001, 0.014),
        Span("mm.embed", 0, 1, 0.001, 0.004, 0.002, 0.007),
        Span("mm.pddm", 0, 1, 0.004, 0.006, 0.007, 0.012),
        Span("trainer.step", None, 2, 0.020, 0.030, 0.021, 0.032),
        Span("mm.embed", 3, 2, 0.021, 0.025, 0.022, 0.026),
        Span("trainer.flush", None, None, 0.031, 0.036, None, None),
    ]
    sess = Session(spans, {"mm.semihard_fired": 150, "mm.hard_fired": 40,
                           "mm.struct_fired": 10, "mm.triplet_budget": 1000},
                   0.0, 0.0)
    monkeypatch.setattr(progspans, "session", lambda run: sess)
    run = SimpleNamespace(trace={"counters": {"attempted": 2}})
    # card: embed 5 + 4 ms over 2 steps; the steps' self 13 - 10 and
    # 11 - 4 ms; host: 10 - 5 and 10 - 4 ms
    assert progspans.card_ms(run, "mm.embed") == pytest.approx(4.5)
    assert progspans.card_ms(run, "mm.embed", "mm.pddm") == \
        pytest.approx(7.0)
    assert progspans.card_ms(run, "trainer.step") == pytest.approx(5.0)
    assert progspans.host_ms(run, "trainer.step") == pytest.approx(5.5)
    assert progspans.host_ms(run, "trainer.flush") == pytest.approx(2.5)
    # no card stamps, or no such span: nothing to read
    assert progspans.card_ms(run, "trainer.flush") is None
    assert progspans.card_ms(run, "serving.meta") is None
    # exits: 14 - 10 and 32 - 30 ms
    assert progspans.exit_lag_ms(run, "trainer.step") == pytest.approx(3.0)
    assert progspans.exit_lag_ms(run, "trainer.flush") is None
    assert progspans.counted_share(
        run, ("mm.semihard_fired", "mm.hard_fired", "mm.struct_fired"),
        "mm.triplet_budget") == pytest.approx(20.0)
    assert progspans.counted_share(run, ("mm.hard_fired",),
                                   "mm.no_such") is None
    run.trace = {"counters": {}}
    assert progspans.card_ms(run, "mm.embed") is None


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_card_phases_tile_the_unit(card, name):
    """On the card a unit's phases, the card's and those of the host alone
    while the card idles, add up to within 10% of the traced window's
    time a unit."""
    from multimodal_similarity_tpu_torch.utils import profiling
    harness._setup_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(name, bench_root=ROOT)
    res = harness.run_cell(cell, 2 ** 31 + 23, 2.0, True, "cuda")
    units = sum(s.name == UNIT_SPAN[name] for s in profiling.session().spans)
    per_unit_ms = 1e3 * res["device"]["window_s"] / units
    card_ms = sum(res["metrics"][m]["value"] for m in CARD_PHASES[name])
    idle_ms = sum(res["metrics"][m]["value"]
                  for m in IDLE_PHASES.get(name, []))
    print(f"{name}: {units} units, {per_unit_ms:.3f} ms a unit, card "
          f"phases {card_ms:.3f} ms, host alone {idle_ms:.3f} ms")
    assert card_ms + idle_ms == pytest.approx(per_unit_ms, rel=0.10)
