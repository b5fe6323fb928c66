"""The port's host preprocessing (``…_torch/preprocess/``) against the JAX
package's: the frame resize of the feature extractor against
``jax.image.resize`` in both directions, sensor normalisation and its
statistics, segmentation features, run-length labels, annotation rules
and the minimal ELAN reader (with deviation D7: a tier it cannot read
raises where the JAX reader gives all-background labels), the CLIs
through the dispatcher, and ``frames``' call-time ffmpeg gate.  The same
numpy inputs go to both packages; tolerances at each assertion."""

import os
import pickle

import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.preprocess import annotations as jax_ann
from multimodal_similarity_tpu.preprocess import frames as jax_frames
from multimodal_similarity_tpu.preprocess import segmentation as jax_seg
from multimodal_similarity_tpu.preprocess import sensors as jax_sensors
from multimodal_similarity_tpu_torch import __main__ as port_main
from multimodal_similarity_tpu_torch.preprocess import annotations as ann
from multimodal_similarity_tpu_torch.preprocess import features, frames
from multimodal_similarity_tpu_torch.preprocess import segmentation as seg
from multimodal_similarity_tpu_torch.preprocess import sensors
from test_torch_backbones import jax_pre


@pytest.mark.parametrize("hw,size", [
    ((480, 640), 299), ((720, 1280), 299),      # shrink (antialiased)
    ((40, 52), 75), ((60, 20), 64),             # enlarge; one axis each way
    ((75, 75), 75)])
def test_resize_matches_jax_image_resize(hw, size):
    """uint8 frames -> the tower's input: within 1e-4 of
    ``jax.image.resize(..., "bilinear")`` (whose downscale low-passes)
    on the [-1, 1] scale, NCHW here and NHWC there."""
    frames_u8 = np.random.RandomState(0).randint(
        0, 256, (2,) + hw + (3,)).astype(np.uint8)
    got = features.make_preprocess(size)(torch.from_numpy(frames_u8))
    assert tuple(got.shape) == (2, 3, size, size)
    assert got.dtype == torch.float32
    want = np.asarray(jax_pre(frames_u8, size))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)


def test_sensor_normalization_matches_jax(tmp_path):
    """Statistics over all sessions, the per-channel recipe, and the
    batch CLI through the dispatcher: bit-equal to JAX."""
    rng = np.random.RandomState(1)
    raws = []
    for i in range(3):
        raw = rng.randn(50 + 10 * i, 8) * 3 + 5
        raw[:, 5] = rng.randint(0, 2, raw.shape[0])
        raw[:, 6] = rng.randint(0, 2, raw.shape[0])
        raws.append(raw)
    mu, std = sensors.compute_sensor_stats(raws)
    jmu, jstd = jax_sensors.compute_sensor_stats(raws)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(std, jstd)
    for raw in raws:
        np.testing.assert_array_equal(sensors.normalize_sensors(raw, mu, std),
                                      jax_sensors.normalize_sensors(raw, mu,
                                                                    std))
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        for i, raw in enumerate(raws):
            np.save(str(d / f"s{i}_sensors.npy"), raw)
        (d / "sessions.txt").write_text("s0\ns1\ns2\n")
    jax_sensors.main(["--feature_root", str(tmp_path / "jax"),
                      "--session_file", str(tmp_path / "jax/sessions.txt")])
    assert port_main.main([
        "preprocess.sensors", "--feature_root", str(tmp_path / "port"),
        "--session_file", str(tmp_path / "port/sessions.txt")]) == 0
    for i in range(3):
        name = f"s{i}_sensors_normalized.npy"
        np.testing.assert_array_equal(np.load(str(tmp_path / "port" / name)),
                                      np.load(str(tmp_path / "jax" / name)))


def test_segmentation_features_match_jax(tmp_path):
    """Spatial-pyramid histograms and the max-pooled softmax maps equal
    JAX's, and so do the CLI's files in both modes."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 12, 17).astype(np.float32)
    for levels in (1, 3):
        np.testing.assert_array_equal(
            seg.spatial_pyramid_features(x, levels),
            jax_seg.spatial_pyramid_features(x, levels))
    big = rng.randn(2, 23, 31, 17).astype(np.float32)
    np.testing.assert_array_equal(seg.downsample_seg(big),
                                  jax_seg.downsample_seg(big))
    assert seg.spatial_pyramid_features(x).shape == (4, 21 * 17)
    for mode in ("pyramid", "down"):
        outs = {}
        for tag, run in (("jax", jax_seg.main),
                         ("port", lambda a: port_main.main(
                             ["preprocess.segmentation"] + a))):
            src, dst = tmp_path / f"{tag}_{mode}_in", tmp_path / f"{tag}_{mode}"
            src.mkdir()
            dst.mkdir()
            np.save(str(src / "s1_seg.npy"), big)
            run(["--seg_root", str(src), "--feature_root", str(dst),
                 "--mode", mode])
            outs[tag] = sorted(os.listdir(dst))
            assert len(outs[tag]) == 1
            outs[tag] = np.load(str(dst / outs[tag][0]))
        np.testing.assert_array_equal(outs["port"], outs["jax"])


def test_run_length_labels_match_jax():
    """Frame labels from (start_ms, end_ms, name) events: the reference's
    drops (empty, park, short), clipping and first-seen ids, then the RLE,
    equal to JAX's."""
    events = [(1000, 4000, "left turn"), (5000, 5400, "right turn"),
              (6000, 9000, "car park"), (8000, 20000, "u-turn"),
              (0, 0, ""), (-3000, 2000, "merge"), (12000, 13000, "left turn")]
    for n in (40, 7):
        got_d, want_d = {"background": 0}, {"background": 0}
        got = ann.annotations_to_frame_labels(events, n, got_d)
        want = jax_ann.annotations_to_frame_labels(events, n, want_d)
        np.testing.assert_array_equal(got, want)
        assert got_d == want_d
        assert ann.convert_seg(got) == jax_ann.convert_seg(want)


def _slot(i, ms):
    return f'<TIME_SLOT TIME_SLOT_ID="ts{i}" TIME_VALUE="{ms}"/>'


def _align(i, s_ref, e_ref, name):
    return (f'<ANNOTATION><ALIGNABLE_ANNOTATION ANNOTATION_ID="a{i}" '
            f'TIME_SLOT_REF1="ts{s_ref}" TIME_SLOT_REF2="ts{e_ref}">'
            f'<ANNOTATION_VALUE>{name}</ANNOTATION_VALUE>'
            f'</ALIGNABLE_ANNOTATION></ANNOTATION>')


def _ref(i, parent, name):
    return (f'<ANNOTATION><REF_ANNOTATION ANNOTATION_ID="r{i}" '
            f'ANNOTATION_REF="a{parent}"><ANNOTATION_VALUE>{name}'
            f'</ANNOTATION_VALUE></REF_ANNOTATION></ANNOTATION>')


def _eaf(path, stimuli, goal=""):
    slots = [_slot(1, 1000), _slot(2, 5000), _slot(3, 6000), _slot(4, 7000),
             _slot(5, 8000), _slot(6, 8200), _slot(7, 9000),
             _slot(8, 12000), _slot(9, 15000), _slot(10, 25000)]
    path.write_text(
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<ANNOTATION_DOCUMENT AUTHOR="t" FORMAT="3.0" VERSION="3.0">'
        f'<TIME_ORDER>{"".join(slots)}</TIME_ORDER>'
        f'<TIER TIER_ID="{ann.TIER_STIMULI}">{stimuli}</TIER>'
        f'<TIER TIER_ID="{ann.TIER_GOAL}">{goal}</TIER>'
        '</ANNOTATION_DOCUMENT>', encoding="utf-8")


def test_eaf_sessions_match_jax(tmp_path):
    """An ELAN file with kept, short, empty, park and clipped events (the
    JAX fixture of tests/test_data.py): ``parse_eaf`` and the CLI's label
    pickle and num -> label map equal JAX's; a missing tier and a
    value-less time slot raise in both."""
    stim = "".join([_align(1, 1, 2, "intersection passing"),
                    _align(2, 3, 4, "short u-turn"), _align(3, 5, 6, ""),
                    _align(4, 7, 8, "garage park"),
                    _align(5, 9, 10, "right turn")])
    eaf = tmp_path / "202103010000-event.eaf"
    _eaf(eaf, stim, _align(6, 1, 2, "goal-only event"))
    for tier in (ann.TIER_STIMULI, ann.TIER_GOAL):
        assert ann.parse_eaf(str(eaf), tier) == \
            jax_ann.parse_eaf(str(eaf), tier)
    feat = tmp_path / "features"
    feat.mkdir()
    np.save(str(feat / "202103010000_sensors.npy"),
            np.zeros((60, 8), np.float32))
    maps, labels = {}, {}
    for tag, mod in (("jax", jax_ann), ("port", ann)):
        out = tmp_path / f"labels_{tag}"
        maps[tag] = mod.parse_sessions(str(tmp_path) + "/{session}*.eaf",
                                       str(feat), str(out))
        with open(out / "202103010000_stimuli.pkl", "rb") as f:
            labels[tag] = pickle.load(f)
    assert maps["port"] == maps["jax"]
    np.testing.assert_array_equal(labels["port"]["label"],
                                  labels["jax"]["label"])
    assert labels["port"]["s"] == labels["jax"]["s"] == [0, 3, 16, 45, 60]
    assert labels["port"]["G"] == labels["jax"]["G"]
    assert port_main.main([
        "preprocess.annotations", "--eaf_template",
        str(tmp_path) + "/{session}*.eaf", "--feature_root", str(feat),
        "--label_root", str(tmp_path / "cli"), "--tier", "stimuli"]) == 0
    with open(tmp_path / "cli" / "202103010000_stimuli.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["label"],
                                      labels["jax"]["label"])
    for mod in (ann, jax_ann):
        with pytest.raises(KeyError, match="tier"):
            mod.parse_eaf(str(eaf), "nope")
    bad = tmp_path / "bad.eaf"
    bad.write_text(
        '<ANNOTATION_DOCUMENT><TIME_ORDER>'
        '<TIME_SLOT TIME_SLOT_ID="ts1" TIME_VALUE="0"/>'
        '<TIME_SLOT TIME_SLOT_ID="ts2"/></TIME_ORDER>'
        f'<TIER TIER_ID="{ann.TIER_STIMULI}">{_align(9, 1, 2, "x")}</TIER>'
        '</ANNOTATION_DOCUMENT>', encoding="utf-8")
    for mod in (ann, jax_ann):
        with pytest.raises(ValueError, match="pympi"):
            mod._parse_eaf_minimal(str(bad), ann.TIER_STIMULI)


@pytest.mark.parametrize("tier", ["ref_only", "empty", "aligned_and_ref"])
def test_d7_unreadable_tier_raises_where_jax_labels_background(tmp_path,
                                                               tier):
    """Deviation D7.  A tier of REF_ANNOTATIONs only, a tier with no
    annotation, or time-aligned events beside REF_ANNOTATIONs: the JAX
    minimal reader drops what it cannot read, so the session's labels
    come out all background (or short of the referring events); the
    port's raises ValueError naming pympi-ling."""
    stim = {"ref_only": _ref(1, 7, "left turn"),
            "empty": "",
            "aligned_and_ref": _align(1, 1, 2, "merge")
            + _ref(2, 1, "left turn")}[tier]
    eaf = tmp_path / "202103010000-event.eaf"
    _eaf(eaf, stim, _align(7, 3, 4, "parent"))
    got = jax_ann._parse_eaf_minimal(str(eaf), jax_ann.TIER_STIMULI)
    assert got == ([(1000, 5000, "merge")] if tier == "aligned_and_ref"
                   else [])
    if tier != "aligned_and_ref":
        labels = jax_ann.annotations_to_frame_labels(got, 60,
                                                     {"background": 0})
        assert not labels.any()
    with pytest.raises(ValueError, match="pympi-ling"):
        ann._parse_eaf_minimal(str(eaf), ann.TIER_STIMULI)
    with pytest.raises(ValueError, match="pympi-ling"):
        ann.parse_eaf(str(eaf), ann.TIER_STIMULI)


def test_frames_gate_ffmpeg_at_call_time(tmp_path, monkeypatch, capsys):
    """Without ffmpeg on PATH ``extract_frames`` raises RuntimeError in
    both packages (the module imports without it); a session with no
    video is skipped with the JAX message."""
    monkeypatch.setenv("PATH", str(tmp_path))
    for mod in (frames, jax_frames):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            mod.extract_frames(str(tmp_path / "v.mp4"), str(tmp_path / "o"))
    (tmp_path / "sessions.txt").write_text("s1\n")
    assert port_main.main([
        "preprocess.frames", "--video_template",
        str(tmp_path) + "/{session}/*.mp4", "--frame_dir",
        str(tmp_path / "frames"), "--session_file",
        str(tmp_path / "sessions.txt")]) == 0
    assert "no video for s1, skipping" in capsys.readouterr().out


class _TinyNet(torch.nn.Module):
    """A stand-in torchvision model: conv, global pool, [B, 4]."""

    def __init__(self, weights=None):
        super().__init__()
        assert weights is None          # the port never asks for a download
        self.conv = torch.nn.Conv2d(3, 4, 3)

    def forward(self, x):
        return self.conv(x).mean((2, 3))


def test_torch_backbone_loads_local_weights_on_its_device(tmp_path,
                                                          monkeypatch):
    """``torch_backbone`` (torchvision stood in by a module holding one
    small model) builds the model with no download, fills it from the
    local state dict, runs on the device asked for, and returns the
    model's output on frames / 255 as f32 numpy; without weights it
    raises; ``features.main`` passes ``--torch_weights`` and ``--device``
    through."""
    import sys
    import types
    vision = types.ModuleType("torchvision")
    vision.models = types.SimpleNamespace(tinynet=_TinyNet)
    monkeypatch.setitem(sys.modules, "torchvision", vision)
    ref = _TinyNet()
    torch.nn.init.normal_(ref.conv.weight, generator=torch.Generator()
                          .manual_seed(0))
    weights = str(tmp_path / "tiny.pt")
    torch.save(ref.state_dict(), weights)
    frames_u8 = np.random.RandomState(9).randint(
        0, 256, (3, 10, 12, 3)).astype(np.uint8)
    fn = features.torch_backbone("tinynet", weights, device="cpu")
    got = fn(frames_u8)
    with torch.no_grad():
        want = ref(torch.from_numpy(frames_u8).permute(0, 3, 1, 2).float()
                   / 255.0).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="--torch_weights"):
        features.torch_backbone("tinynet", device="cpu")

    seen = {}
    real = features.torch_backbone

    def spy(name, weights_path=None, device=None):
        seen.update(name=name, weights=weights_path, device=device)
        return real(name, weights_path, device)

    monkeypatch.setattr(features, "torch_backbone", spy)
    sessions = tmp_path / "sessions.txt"
    sessions.write_text("none\n")
    features.main(["--frame_root", str(tmp_path / "frames"),
                   "--feature_root", str(tmp_path / "feats"),
                   "--session_file", str(sessions), "--backbone", "tinynet",
                   "--torch_weights", weights, "--device", "cpu"])
    assert seen == {"name": "tinynet", "weights": weights, "device": "cpu"}
