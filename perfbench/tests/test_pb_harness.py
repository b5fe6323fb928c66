"""The harness on the CPU at tiny sizes: discovery by name, the result's
line, a run that finds no card, and the guard on loaded modules."""

import json
import os
import sys

import pytest

from perfbench import harness

CELLS = ("mm_flagship.train_cached", "rtsn_base.retrieval_400k",
         "rtsn_base.extract_720p")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_result_line(tiny_root, name, trace):
    cell = harness.load_cell(name, bench_root=tiny_root)
    res = harness.run_cell(cell, 2 ** 31 + 11, 0.3, bool(trace), "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["device"]["count"] == 1
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # no card here: the idle shares find nothing to read
        want = {m for m in want if not m.startswith("device_idle_share")}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(res)


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[1], "--seed", "3",
                       "--seconds", "1"])
    assert rc == harness.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_unknown_workload_fails(capsys):
    rc = harness.main(["--workload", "no.such_cell", "--seed", "3",
                       "--seconds", "1"])
    assert rc == harness.EXIT_SPEC
    assert capsys.readouterr().out == ""


def test_forbidden_module_refuses_the_result(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    cell = harness.load_cell(CELLS[1], bench_root=tiny_root)
    with pytest.raises(harness.ForbiddenModules) as e:
        harness.run_cell(cell, 5, 0.2, False, "cpu")
    assert e.value.names == ["jax"]


def test_discovery_adds_a_cell_with_files_alone(tiny_root):
    """A configuration, a traffic mix, a metric reader and their entries
    make a new cell; no file of the harness changes."""
    pb = os.path.join(tiny_root, "perfbench")
    with open(os.path.join(pb, "configs", "rtsn_base.json")) as f:
        cfg = json.load(f)
    cfg.update(name="rtsn_wide", emb_dim=256)
    with open(os.path.join(pb, "configs", "rtsn_wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "retrieval_400k.json")) as f:
        mix = json.load(f)
    mix["params"].update(queries_per_call=16, k=5)
    with open(os.path.join(pb, "traffic", "retrieval_small.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run.counters['calls'] / run.window_s\n")
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "rtsn_wide", "source": "x",
                            "file": "perfbench/configs/rtsn_wide.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "rtsn_wide.retrieval_small",
                              "config": "rtsn_wide",
                              "traffic": "retrieval_small", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] in ("query_p95_ms", "queries_per_s"):
            m["workloads"].append("rtsn_wide.retrieval_small")
    spec["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "retrieval index",
                              "moves": "queries_per_s",
                              "workloads": ["rtsn_wide.retrieval_small"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cell = harness.load_cell("rtsn_wide.retrieval_small",
                             bench_root=tiny_root)
    assert cell.config["emb_dim"] == 256
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    res = harness.run_cell(cell, 17, 0.3, True, "cpu")
    assert res["correct"] is True
    assert res["metrics"]["calls_per_s"]["value"] > 0
    res = harness.run_cell(cell, 17, 0.3, False, "cpu")
    assert set(res["metrics"]) == {"query_p95_ms", "queries_per_s",
                                   "setup_s"}


def test_sub_seeds():
    seeds = [harness.sub_seed(2 ** 31 + 5, k) for k in range(4)]
    assert len(set(seeds)) == 4
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert seeds == [harness.sub_seed(2 ** 31 + 5, k) for k in range(4)]
    assert harness.sub_seed(-3, 0) != harness.sub_seed(3, 0)


def test_judge():
    got = harness.judge({"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 2.0})
    assert got["correct"] is False
    assert got["checks"]["b"] == {"value": 3.0, "limit": 2.0}
    assert harness.judge({"a": float("nan")}, {"a": 1.0})["correct"] is False
    assert harness.judge({"a": 0.5}, {})["correct"] is False
    assert harness.judge({"a": 0.5}, {"a": 1.0})["correct"] is True


def test_trace_reduction_counts_overlap_once():
    """Busy time is the union of the card's intervals (two overlapping
    kernels count once); the window is the host's; idle gaps go to the
    span the host was in, its clock tied to the trace's by the marker."""
    from perfbench import devtrace
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [{"ph": "X", "cat": "kernel", "name": mark, "ts": 1000, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "void k<int>(int)", "ts": 1025,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "void k<int>(int)", "ts": 1035,
           "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1075,
           "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 1000, "dur": 100}]
    # the host launched the marker at 2.0 s of its clock (trace time 1000
    # us) and closed the window at 2.0001 s; the call ran from 2.00001 s to
    # 2.00006 s
    out = devtrace.reduce_events(ev, 2.0, 2.0001,
                                 [(2.00001, 2.00006, "call")])
    assert out["marked"] is True
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(40e-6)
    assert out["n_device_events"] == 3
    assert [k for k, _ in out["device_ops"]] == ["k<int>(int)",
                                                  "Memcpy HtoD"]
    assert [v for _, v in out["device_ops"]] == pytest.approx([40e-6, 10e-6])
    # gaps [1000, 1025), [1055, 1075) and [1085, 1100), told by their
    # midpoints: 1012.5 in "call" [1010, 1060), 1065 and 1092.5 outside it
    idle = dict(out["idle_gaps"])
    assert set(idle) == {"call", devtrace.OUTSIDE}
    assert idle["call"] == pytest.approx(25e-6)
    assert idle[devtrace.OUTSIDE] == pytest.approx(35e-6)
    # without the marker the first operation is tied to the first span:
    # the same busy time, the gaps shifted by 15 us
    out = devtrace.reduce_events(ev[1:], 2.0, 2.0001,
                                 [(2.00001, 2.00006, "call")])
    assert out["marked"] is False
    assert out["busy_s"] == pytest.approx(40e-6)
    assert sum(v for _, v in out["idle_gaps"]) == pytest.approx(60e-6)


def test_trace_without_operations_fails():
    from perfbench import devtrace
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "k", "ts": 0, "dur": 5}]
    with pytest.raises(RuntimeError):
        devtrace.reduce_events(ev, 0.0, 1.0, [])


def test_idle_share_reads_the_measured_window():
    """The card's busy time a unit of work in the traced window over the
    measured window's time a unit."""
    from perfbench import devtrace
    run = harness.Run(cell=None, seed=0, device=None)
    run.counters, run.window_s = {"attempted": 100}, 2.0
    assert devtrace.idle_share(run) is None
    run.trace = {"n_device_events": 10, "busy_s": 0.6, "window_s": 1.0,
                 "counters": {"attempted": 40}}
    # 15 ms busy a unit against 20 ms a unit measured
    assert devtrace.idle_share(run) == pytest.approx(25.0)
