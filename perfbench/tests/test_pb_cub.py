"""The CUB cell (``cub_inception_v2.train_e2e``) on the CPU at a tiny size:
a whole run through ``harness.run_cell`` is correct, the TF32 control and
each fault of ``perfbench/calibrate_cub.py`` are not, the readers of the
program's spans read numbers, the FLOP count sums the port's
convolutions; and one card test that runs the cell for two seconds."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT, make_bench_root
from perfbench import calibrate, calibrate_cub, harness, progspans
from perfbench.reference import cub_inception_v2 as ref

CELL = "cub_inception_v2.train_e2e"
# every width kept, the images and crops cut to what a CPU test holds
TINY_CONFIG = dict(image_size=72, crop=64, train_classes=4,
                   images_per_class=28)
TINY_PARAMS = dict(warm_steps=3)
SPAN_METRICS = {"phase_ms.upload.cub", "phase_ms.tower.cub",
                "phase_ms.loss.cub", "phase_ms.backward.cub",
                "phase_ms.adam.cub", "host_ms.sample.cub",
                "flush_wait_ms.cub"}


@pytest.fixture
def cub_root(tmp_path):
    root = make_bench_root(str(tmp_path))
    for rel, change in (("configs/cub_inception_v2.json", TINY_CONFIG),
                        ("traffic/train_e2e.json", TINY_PARAMS)):
        path = os.path.join(root, "perfbench", rel)
        with open(path) as f:
            data = json.load(f)
        (data["params"] if rel.startswith("traffic") else data).update(
            change)
        with open(path, "w") as f:
            json.dump(data, f)
    return root


def _reader(cell, name):
    return harness.load_module(
        os.path.join(cell.bench_root, "perfbench", "metrics", name + ".py"),
        "perfbench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("trace", (0, 1))
def test_cell_is_correct(cub_root, trace):
    cell = harness.load_cell(CELL, bench_root=cub_root)
    assert cell.config["crop"] == 64 and cell.params["warm_steps"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["train_step_ms",
                                                     "setup_s"]
    assert {m["name"] for m in cell.per_layer} == SPAN_METRICS | {
        "cub_train_mfu", "device_idle_share.cub"}
    res = harness.run_cell(cell, 2 ** 31 + 11, 0.3, bool(trace), "cpu")
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "stat_gap"}
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert res["metrics"]["cub_train_mfu"]["value"] > 0
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_control_is_not_correct(cub_root):
    """The reference in the program's place at TF32 fails the cell's
    limits, held against the reference from its own states, where the
    program passes them."""
    cell = harness.load_cell(CELL, bench_root=cub_root)
    refs = {}
    readings, got, run = calibrate.program_readings(cell, 23, 0.2, "cpu",
                                                    refs)
    assert harness.judge(readings, cell.limits)["correct"] is True
    ctrl = cell.kind.control(run, got)
    readings = cell.kind.compare(run, ctrl, cell.kind.reference(run, ctrl))
    assert harness.judge(readings, cell.limits)["correct"] is False


@pytest.mark.parametrize("fault", calibrate_cub.FAULTS)
def test_fault_is_not_correct(cub_root, fault):
    """A whole run with the timed path broken underneath: ``correct``
    comes out false."""
    cell = harness.load_cell(CELL, bench_root=cub_root)
    remove = calibrate_cub.plant(fault)
    try:
        res = harness.run_cell(cell, 29, 0.2, False, "cpu")
    finally:
        remove()
    assert res["correct"] is False, res["checks"]


def test_span_readers_read_numbers(cub_root, monkeypatch):
    """A window under a CPU profiler: the host-side readers read numbers
    and the card-side ones None (no card stamps); with the host's stamps
    standing in for the card's, every reader reads a number, and the
    phases inside a step add up to no more than the step."""
    cell = harness.load_cell(CELL, bench_root=cub_root)
    run = harness.Run(cell=cell, seed=2 ** 31 + 19,
                      device=torch.device("cpu"))
    state = cell.kind.setup(run)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            cell.kind.window(state, 0.3)
        run.trace = {"counters": dict(run.counters), "n_device_events": 1,
                     "busy_s": 0.5 * run.window_s,
                     "window_s": run.window_s}
        got = {m: _reader(cell, m).read(run) for m in SPAN_METRICS}
        sess = progspans.session(run)
        stamped = sess.__class__(
            [s._replace(card_start=s.host_start, card_end=s.host_end)
             for s in sess.spans], sess.counters, sess.opened,
            sess.unix_offset)
        monkeypatch.setattr(progspans, "session", lambda run: stamped)
        card = {m: _reader(cell, m).read(run) for m in SPAN_METRICS}
        idle = _reader(cell, "device_idle_share.cub").read(run)
        mfu = _reader(cell, "cub_train_mfu").read(run)
    finally:
        cell.kind.release(state)
    steps = run.trace["counters"]["attempted"]
    assert steps > 0 and sess.counters["cub.images"] == 32 * steps
    for m, value in got.items():
        if m.startswith("phase_ms"):
            assert value is None, (m, value)
        else:
            assert value is not None and value > 0, m
    assert all(v is not None and v > 0 for v in card.values()), card
    per_step = 1e3 * sum(s.host_end - s.host_start for s in sess.spans
                         if s.name == "cub.step") / steps
    assert sum(v for m, v in card.items() if m != "flush_wait_ms.cub") \
        <= per_step * (1 + 1e-6)
    assert idle == pytest.approx(50.0) and 0 < mfu < 100


def test_images_and_weights_repeat_from_the_seed():
    a, la = ref.make_images(3, 4, 5, 16, "cpu")
    b, lb = ref.make_images(3, 4, 5, 16, "cpu")
    c, _ = ref.make_images(4, 4, 5, 16, "cpu")
    assert a.dtype == np.float32 and a.shape == (20, 16, 16, 3)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert list(la) == [c for c in range(4) for _ in range(5)]
    w = ref.make_weights(3, 8, "cpu")
    assert all(torch.equal(v, ref.make_weights(3, 8, "cpu")[k])
               for k, v in w.items())


def test_step_flops_sum_the_ports_convolutions():
    """The count from the reference's shapes equals the port's
    convolutions' forward products, their shapes read by forward hooks,
    three times less the first's input gradient, plus the head's and the
    Gram product; about 3.86 GFLOP a 224 crop forward, 370 GFLOP a step of
    32."""
    from multimodal_similarity_tpu_torch.models.inception_v2 import (
        Conv, InceptionV2)
    with torch.device("meta"):
        model = InceptionV2()
    convs = []

    def hook(mod, inputs, out):
        cout, cin, kh, kw = mod.weight.shape
        convs.append(2 * cout * cin * kh * kw * out.shape[2] * out.shape[3])
    for mod in model.modules():
        if isinstance(mod, Conv):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty(1, 224, 224, 3, device="meta"))
    assert len(convs) == len(ref.conv_shapes())
    b, e = 32, 64
    want = (b * (3 * sum(convs) - convs[0]) + 3 * 2 * b * 1024 * e
            + 2 * b * b * e)
    assert ref.step_flops(b, 224, e) == float(want)
    assert 3.85e9 < sum(convs) < 3.87e9
    assert 369e9 < ref.step_flops(b, 224, e) < 372e9


@pytest.mark.card
def test_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_graphed_steps_follow_the_steps_as_written(card, tmp_path):
    """On the card ``CUBTrainer`` replays its step from CUDA graphs
    (``base_CUB.GraphedCUBStep``: the first step as written, the capture
    at the second).  With cuDNN's deterministic algorithms, six such steps
    against six of the step as written, from the same weights and draws:
    the losses at rtol 1e-6, the parameters and the running statistics at
    1e-6 of their change.  The two then run the same kernels on the same
    operands; with the default algorithms the weight gradients are summed
    in no fixed order, and the semi-hard loss's choice of negatives turns
    those ulps into a different loss within a few steps."""
    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.trainers import base_CUB
    from multimodal_similarity_tpu_torch.utils.logging import MetricsLogger
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = TINY_CONFIG
    images, labels = ref.make_images(3, c["train_classes"],
                                     c["images_per_class"], c["image_size"],
                                     "cuda")
    weights = ref.make_weights(4, 64, "cuda")
    cfg = TrainConfig(name="graphs", silent_mode=True,
                      network="inception_v2", loss="triplet", emb_dim=64,
                      batch_size=32, learning_rate=1e-3, optimizer="ADAM",
                      keep_prob=1.0, alpha=0.2, seed=5).resolve()
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for graphs in (True, False):
            model = base_CUB.build_model(cfg, "cuda")
            model.load_state_dict(weights, strict=True)
            opt = build_optimizer("ADAM", model, cfg.learning_rate)
            trainer = base_CUB.CUBTrainer(
                cfg, model, opt, images, labels, c["crop"], "cuda",
                MetricsLogger(str(tmp_path / str(graphs))))
            if not graphs:
                trainer.step_fn = base_CUB.make_cub_step(
                    model, opt, cfg, c["crop"],
                    torch.Generator(device="cuda").manual_seed(cfg.seed + 2))
            losses = [float(trainer.step(cfg.learning_rate)["loss"])
                      for _ in range(6)]
            runs.append((losses, model, trainer))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (lg, mg, tg), (le, me, _) = runs
    assert isinstance(tg.step_fn, base_CUB.GraphedCUBStep)
    assert tg.step_fn.graphs is not None and tg.step_fn.calls == 6
    np.testing.assert_allclose(lg, le, rtol=1e-6)
    change = {k: float((p.detach() - weights[k]).norm())
              for k, p in me.named_parameters()}
    med = float(np.median(list(change.values())))
    assert med > 0
    got = dict(mg.named_parameters())
    for k, p in me.named_parameters():
        apart = float((got[k].detach() - p.detach()).double().norm())
        assert apart <= 1e-6 * max(change[k], med), k
    bufs = dict(mg.named_buffers())
    for k, s in me.named_buffers():
        moved = float((s - weights[k]).double().norm())
        assert moved > 0, k
        assert float((bufs[k] - s).double().norm()) <= 1e-6 * moved, k
