"""The port's device feature cache (``data/device_cache.py``) and its TSN
samplers against the JAX package's, built with ``mesh=None`` on the same
small synthetic directory (a few sessions, 2x2x8 maps): the budget
estimate and its errors, the resident arrays and the label table bit for
bit (multimodal, 1 and 4 workers), the epoch plans index for index over
two epochs, the gather under the JAX cache's uniforms (bit-equal; the
mean-pooled modality within 1e-6 relative), the budget decline and its
notice."""

import jax
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import device_cache as jdc
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.data import tsn as jax_tsn
from multimodal_similarity_tpu.data.datasets import (
    prepare_multimodal_dataset)
from multimodal_similarity_tpu_torch.data import device_cache, tsn
from multimodal_similarity_tpu_torch.parallel import create_mesh
from multimodal_similarity_tpu_torch.utils import profiling

N_SEG = 3
MODALITIES = ["resnet", "sensors", "segment"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Six train sessions of three modalities, events of 4-39 frames: the
    cache trims its frame axis below 45."""
    root = str(tmp_path_factory.mktemp("cache"))
    generate_synthetic_honda(
        root, n_sessions=8, frames_per_session=260,
        modal_dims={"resnet": (2, 2, 8), "sensors": (8,), "segment": (12,)},
        seed=3, splits=(0.8, 0.1), length_range=(4, 40))
    cfg = JaxTrainConfig(DATA_ROOT=root).resolve()
    return prepare_multimodal_dataset(cfg.feature_root, cfg.train_session,
                                      MODALITIES, cfg.label_root, "goal")


def _builds(dataset, workers=1, **kw):
    kw = dict(dict(n_seg=N_SEG, sess_per_batch=2, event_budget=40, seed=7,
                   verbose=False), **kw)
    want = jdc.DeviceFeatureCache.build(dataset, workers=workers, **kw)
    got = device_cache.DeviceFeatureCache.build(dataset, device="cpu",
                                                workers=workers, **kw)
    return got, want


def jax_gather_uniforms(key, modes):
    """A stand-in for the port's uniform draw that gives, call after call,
    the JAX gather's uniforms under ``key``: uniform(fold_in(key, m)) for
    each TSN modality m in order."""
    pending = [m for m, mode in enumerate(modes) if mode == "tsn"]

    def draw(generator, b, n_seg, device):
        m = pending.pop(0)
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, m), (b, n_seg)))).to(device)

    return draw


def test_tsn_offsets_match_jax(monkeypatch, rng):
    """The device TSN samplers on lengths from 1 to 45 frames (shorter
    than n_seg included): index-equal under the same uniforms."""
    lens = rng.randint(1, 46, size=200).astype(np.int32)
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(tsn, "draw_tsn_uniforms", jax_gather_uniforms(
        key, ["tsn"]))
    got = tsn.tsn_sample_offsets(None, torch.from_numpy(lens), N_SEG)
    want = jax_tsn.tsn_sample_offsets(jax.random.fold_in(key, 0), lens,
                                      N_SEG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tsn.tsn_center_offsets(torch.from_numpy(lens), N_SEG).numpy(),
        np.asarray(jax_tsn.tsn_center_offsets(lens, N_SEG)))


def test_draw_tsn_uniforms_is_seeded():
    a = tsn.draw_tsn_uniforms(torch.Generator().manual_seed(1), 4, 3, "cpu")
    b = tsn.draw_tsn_uniforms(torch.Generator().manual_seed(1), 4, 3, "cpu")
    assert a.shape == (4, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and float(a.min()) >= 0.0 and \
        float(a.max()) < 1.0


def test_estimate_matches_jax(dataset, tmp_path):
    """Equal estimates (one and three modalities, 45 and 10 frames), and
    the same ValueError for a session of other dims."""
    for rows in (dataset, [[r[1], r[-1]] for r in dataset]):
        assert device_cache.estimate_cache_bytes(rows) == \
            jdc.estimate_cache_bytes(rows)
        assert device_cache.estimate_cache_bytes(rows, 10) == \
            jdc.estimate_cache_bytes(rows, 10)
    odd = str(tmp_path / "odd.npy")
    np.save(odd, np.zeros((260, 9), np.float32))
    rows = [[r[1], r[-1]] for r in dataset]
    rows[2] = [odd, rows[2][1]]
    with pytest.raises(ValueError, match="heterogeneous") as got:
        device_cache.estimate_cache_bytes(rows)
    with pytest.raises(ValueError, match="heterogeneous") as want:
        jdc.estimate_cache_bytes(rows)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("workers,max_frames", [(1, 45), (4, 45), (4, 12)])
def test_resident_arrays_match_jax(dataset, workers, max_frames):
    """q, scale, seq_len and the label table bit for bit, the frame trim,
    row count and resident bytes equal, for 1 and 4 staging workers and
    with windows cut at 12 frames; the build is counted."""
    device_cache.reset_counts()
    got, want = _builds(dataset, workers=workers, max_frames=max_frames)
    assert profiling.counters("cache.")["build"] == 1
    assert got.max_frames == want.max_frames == min(
        max_frames, int(got.seq_len.max()))
    assert got.max_frames < 40
    assert got.shard_rows == want.shard_rows
    assert got.batches_per_epoch == want.batches_per_epoch == 3
    for m in range(3):
        np.testing.assert_array_equal(got.q[m].numpy(),
                                      np.asarray(want.q[m]))
        np.testing.assert_array_equal(got.scale[m].numpy(),
                                      np.asarray(want.scale[m]))
    np.testing.assert_array_equal(got.seq_len.numpy(),
                                  np.asarray(want.seq_len))
    np.testing.assert_array_equal(got.label_dev.numpy(),
                                  np.asarray(want.label_dev))
    np.testing.assert_array_equal(got.label_table, want.label_table)
    assert got.device_bytes == want.device_bytes
    ops, wops = got.step_operands(), want.step_operands()
    assert len(ops) == len(wops) == 8
    for a, b in zip(ops, wops):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    plan = np.arange(3, dtype=np.int32)
    assert got.put_plans((plan,))[0] is plan
    assert [len(s) for s in got._shard_sessions[0]] == \
        [len(s) for s in want._shard_sessions[0]]


def test_plans_match_jax_over_two_epochs(dataset):
    """Every plan of two epochs index-equal (the packed ids and count,
    labels, mask), budget cuts and padding both occurring."""
    for budget in (8, 400):
        got, want = _builds(dataset, event_budget=budget)
        for _ in range(2):
            plans = list(got.epoch_plans())
            wplans = list(want.epoch_plans())
            assert len(plans) == len(wplans) == 3
            for p, w in zip(plans, wplans):
                np.testing.assert_array_equal(p["packed"], w["packed"][0])
                np.testing.assert_array_equal(p["labels_host"],
                                              w["labels_host"])
                np.testing.assert_array_equal(p["mask_host"], w["mask_host"])
                assert p["num_events"] == w["num_events"]
        # 8 cuts every group of two sessions; 400 pads every one
        assert all((p["num_events"] < budget) == (budget == 400)
                   for p in plans)


def test_gather_matches_jax(dataset, monkeypatch):
    """The gather of a plan under the JAX cache's uniforms: the TSN
    modalities' q and scale, labels and mask bit-equal, the mean-pooled
    one within 1e-6 relative; a row take equals the same rows of the
    whole batch; gathers are counted."""
    modes = ("tsn", "meanpool", "tsn")
    got, want = _builds(dataset, event_budget=400, modality_modes=modes)
    key = jax.random.PRNGKey(5)
    device_cache.reset_counts()
    for plan in got.epoch_plans():
        jpacked = jax.numpy.asarray(plan["packed"])
        wg, wlab, wmask = want.gather_fn(key, jpacked, *want.step_operands())
        monkeypatch.setattr(tsn, "draw_tsn_uniforms",
                            jax_gather_uniforms(key, modes))
        gg, glab, gmask = got.gather(torch.from_numpy(plan["packed"]), None)
        np.testing.assert_array_equal(glab.numpy(), np.asarray(wlab))
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        for m in (0, 2):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(gg[m][part].numpy(),
                                              np.asarray(wg[m][part]))
        np.testing.assert_allclose(gg[1].numpy(), np.asarray(wg[1]),
                                   rtol=1e-6, atol=1e-7)
        rows = torch.tensor([3, 0, 7, 7])
        monkeypatch.setattr(tsn, "draw_tsn_uniforms",
                            jax_gather_uniforms(key, modes))
        rg, rlab, rmask = got.gather(torch.from_numpy(plan["packed"]), None,
                                     rows=rows)
        assert torch.equal(rlab, glab[rows]) and torch.equal(rmask,
                                                             gmask[rows])
        assert torch.equal(rg[0]["q"], gg[0]["q"][rows])
        assert torch.equal(rg[2]["scale"], gg[2]["scale"][rows])
        assert torch.equal(rg[1], gg[1][rows])
    assert profiling.counters("cache.")["gather"] == 6


def test_epoch_batches_two_call_path(dataset):
    """``epoch_batches`` gives every plan of an epoch gathered, with the
    plan's host labels and ids beside the device ones."""
    got, _ = _builds(dataset)
    batches = list(got.epoch_batches(torch.Generator().manual_seed(0)))
    assert len(batches) == got.batches_per_epoch
    for b in batches:
        assert set(b) >= {"events", "events2", "events3", "labels", "mask",
                          "labels_host", "mask_host", "num_events",
                          "global_indices"}
        assert b["events"]["q"].shape == (40, N_SEG, 2, 2, 8)
        assert b["events2"]["scale"].shape == (40, N_SEG, 1)
        np.testing.assert_array_equal(b["labels"].numpy(),
                                      b["labels_host"] * (b["mask_host"] > 0))


def test_budget_decline_and_errors_match_jax(dataset, capsys, tmp_path):
    """Over budget both builds return None with the same notice; bad
    modality modes raise the same errors; a build over a one-rank mesh has
    the resident arrays and plans of one without; the budget helpers and
    the window notice."""
    est = device_cache.estimate_cache_bytes(dataset)
    kw = dict(n_seg=N_SEG, sess_per_batch=2, event_budget=40, seed=0,
              budget_bytes=est - 1)
    assert jdc.DeviceFeatureCache.build(dataset, **kw) is None
    want = capsys.readouterr().out
    assert device_cache.DeviceFeatureCache.build(dataset, device="cpu",
                                                 **kw) is None
    assert capsys.readouterr().out == want
    assert "falling back to the streaming feed" in want
    for modes, match in ((("tsn",), "does not match"),
                         (("tsn", "max", "tsn"), "unknown modality")):
        with pytest.raises(ValueError, match=match):
            device_cache.DeviceFeatureCache.build(
                dataset, n_seg=N_SEG, sess_per_batch=2, event_budget=40,
                seed=0, device="cpu", modality_modes=modes, verbose=False)
    kw = dict(n_seg=N_SEG, sess_per_batch=2, event_budget=40, seed=0,
              device="cpu", verbose=False)
    alone = device_cache.DeviceFeatureCache.build(dataset, **kw)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        on_mesh = device_cache.DeviceFeatureCache.build(
            dataset, mesh=create_mesh(1), **kw)
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(on_mesh.step_operands(), alone.step_operands()):
        assert torch.equal(a, b)
    for a, b in zip(on_mesh.epoch_plans(), alone.epoch_plans()):
        np.testing.assert_array_equal(a["packed"], b["packed"])
    assert device_cache.cache_budget_bytes(6.0) == jdc.cache_budget_bytes(
        6.0) == 6_000_000_000
    got, _ = _builds(dataset)
    device_cache.notice_window_shortfall(got, 4, "t", silent=False)
    jdc.notice_window_shortfall(got, 4, "t", silent=False)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and "exceeds 3 batches/epoch" in out[0]
