"""The yardstick's parts at tiny sizes on the CPU: the generators repeat
from a seed, the FLOP counters, the control and every fault come out not
correct, and one card test that runs each cell for two seconds."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfbench import calibrate, faults, flops, harness, honda_data
from perfbench.reference import flagship, inception_resnet_v2, topk

# each cell's kind of traffic, whose faults it can have
KINDS = {"mm_flagship.train_cached": "train_cached",
           "rtsn_base.retrieval_400k": "retrieval",
           "rtsn_base.extract_720p": "extract"}



def test_rows_repeat_from_the_seed():
    a = topk.make_rows(7, 500, 10, 16, 0.8, 3, 8, "cpu")
    b = topk.make_rows(7, 500, 10, 16, 0.8, 3, 8, "cpu")
    c = topk.make_rows(8, 500, 10, 16, 0.8, 3, 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert torch.allclose(a[0].norm(dim=1), torch.ones(500), atol=1e-5)


def test_weights_repeat_from_the_seed(tiny_root):
    with open(os.path.join(tiny_root, "perfbench", "configs",
                           "mm_flagship.json")) as f:
        cfg = json.load(f)
    a = flagship.make_weights(cfg, 3, "cpu")
    b = flagship.make_weights(cfg, 3, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = inception_resnet_v2.make_weights(3, "cpu")
    assert torch.equal(w["units.0.Conv2d_1a_3x3.weight"],
                       inception_resnet_v2.make_weights(3, "cpu")[
                           "units.0.Conv2d_1a_3x3.weight"])
    assert torch.equal(flagship.class_margins(4, 0.1, 0.5, "cpu"),
                       flagship.class_margins(4, 0.1, 0.5, "cpu"))


def test_honda_directory_repeats_from_the_seed(tiny_root, tmp_path):
    with open(os.path.join(tiny_root, "perfbench", "configs",
                           "mm_flagship.json")) as f:
        cfg = json.load(f)
    dirs = [str(tmp_path / d) for d in ("a", "b")]
    for d in dirs:
        honda_data.write(d, cfg, 9, "cpu")
    files = sorted(os.listdir(os.path.join(dirs[0], "features")))
    assert len(files) == 3 * (cfg["train_sessions"] + cfg["val_sessions"])
    for name in files:
        x, y = (np.load(os.path.join(d, "features", name)) for d in dirs)
        assert np.array_equal(x, y)
    assert np.load(os.path.join(dirs[0], "features", files[0])).dtype \
        == np.float16


def test_trunk_flops_sum_the_ports_convolutions():
    """The count from the reference trunk's shapes equals the sum over the
    port's convolution modules, their shapes read by forward hooks."""
    from multimodal_similarity_tpu_torch.models.inception_resnet_v2 import (
        InceptionResNetV2)
    from multimodal_similarity_tpu_torch.models.inception_v2 import Conv
    with torch.device("meta"):
        model = InceptionResNetV2()
    total = []

    def hook(mod, inputs, out):
        cout, cin, kh, kw = mod.weight.shape
        total.append(2 * cout * cin * kh * kw * out.shape[2] * out.shape[3])
    for mod in model.modules():
        if isinstance(mod, Conv):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty(1, 3, 299, 299, device="meta"))
    assert len(total) == len(inception_resnet_v2.conv_shapes())
    assert flops.trunk_frame(299) == float(sum(total))
    # about 13.2 G multiply-adds a frame, as published
    assert 13.0e9 < flops.trunk_frame(299) / 2 < 13.3e9


def test_convrtsn_flops_by_hand():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "mm_flagship.json")) as f:
        c = json.load(f)
    # 3 segments x (the 1x1 embedding 8x8 x 1536 -> 20, and the LSTM's
    # [1280 + 128] -> 512 gates)
    assert flops.convrtsn_forward(c) == 3 * (2 * 64 * 1536 * 20
                                             + 2 * 1408 * 512)
    # the budget's eval embedding, the 40 anchors' distances, both
    # branches, 200 x 1000 PDDM pairs a branch, 1500 rows forward and
    # backward
    sensors = 3 * (2 * 8 * 32 + 2 * 64 * 128)
    segment = 3 * (2 * 357 * 32 + 2 * 64 * 128)
    pddm = 2 * (32 * 32 * 2 + 64 * 32 + 32 * 2)
    want = (1000 * flops.convrtsn_forward(c) + 2 * 40 * 1000 * 128
            + 1000 * (sensors + segment) + 2 * 200 * 1000 * pddm
            + 3 * 1500 * flops.convrtsn_forward(c))
    assert flops.flagship_step(c) == want


@pytest.mark.parametrize("name", sorted(KINDS))
def test_control_is_not_correct(tiny_root, name):
    """The reference in the program's place at TF32 fails the cell's
    limits, where the program passes them."""
    cell = harness.load_cell(name, bench_root=tiny_root)
    refs = {}
    readings, got, run = calibrate.program_readings(cell, 23, 0.2, "cpu",
                                                    refs)
    assert harness.judge(readings, cell.limits)["correct"] is True
    ctrl = cell.kind.control(run, got)
    readings = cell.kind.compare(run, ctrl, refs[23])
    assert harness.judge(readings, cell.limits)["correct"] is False


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name, kind in KINDS.items()
    for fault in faults.FAULTS[kind]])
def test_fault_is_not_correct(tiny_root, name, fault):
    """A whole run with the timed path broken underneath: ``correct``
    comes out false."""
    cell = harness.load_cell(name, bench_root=tiny_root)
    remove = faults.plant(cell.traffic["kind"], fault)
    try:
        res = harness.run_cell(cell, 29, 0.2, False, "cpu")
    finally:
        remove()
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fold", ("mean_dropped", "var_not_rooted"))
def test_batch_norm_statistics_are_checked(tiny_root, monkeypatch, fold):
    """The trunk's batch-norm statistics come from the seed, so a program
    that drops the running mean, or divides by the variance in place of
    its root, is not correct."""
    import torch
    from multimodal_similarity_tpu_torch.models import inception_v2

    def wrong(self, x):
        mean, var = self.running_mean, self.running_var
        if fold == "mean_dropped":
            mean = torch.zeros_like(mean)
            mul = torch.rsqrt(var + self.eps)
        else:
            mul = 1.0 / (var + self.eps)
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])

    monkeypatch.setattr(inception_v2.BatchNorm, "forward", wrong)
    cell = harness.load_cell("rtsn_base.extract_720p", bench_root=tiny_root)
    res = harness.run_cell(cell, 31, 0.2, False, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(KINDS))
def test_cell_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
