"""The port's feature-extraction towers against the flax ones: the
Inception-ResNet-v2 trunk (``…_torch/models/inception_resnet_v2.py``) and
InceptionV1 (``inception_v1.py``), their parameter counts and endpoint
shapes at the slim sizes, the eval-mode forward and endpoints on the same
grafted variables, the unit form; ``slim_backbone`` against
``flax_backbone`` on uint8 frames that each tower shrinks and enlarges;
``extract_sessions`` on a directory of JPEG frames.  The graft itself is
held in test_torch_slim_graft.py.  Tolerances at each assertion.

The JAX variables come from ``jax.eval_shape`` filled with seeded numpy
(an eager ``init`` of these towers takes 40 s on the CPU).  Where
``flax_backbone`` itself runs, its ``init`` is patched to return the
same zero-filled shapes: the slim graft then replaces every leaf, and
raises if one is left.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.models import inception_resnet_v2 as jax_irv2
from multimodal_similarity_tpu.models import inception_v1 as jax_iv1
from multimodal_similarity_tpu.models import slim_graft as jax_graft
from multimodal_similarity_tpu.preprocess import features as jax_features
from multimodal_similarity_tpu_torch.models import (
    InceptionResNetV2, InceptionV1)
from multimodal_similarity_tpu_torch.models import inception_resnet_v2 \
    as irv2
from multimodal_similarity_tpu_torch.models import inception_v1 as iv1
from multimodal_similarity_tpu_torch.models import slim_graft
from multimodal_similarity_tpu_torch.preprocess import features

# eval-mode forward, port against flax on the same variables: every
# element within this fraction of the tensor's largest magnitude
EVAL_TOL = 1e-5
# slim_backbone against flax_backbone: the same, on the tower's output
# from uint8 frames (the resize adds up to 7e-6 of an input's scale)
BACKBONE_TOL = 1e-4

TOWERS = {
    # name: (jax class, port class, slim prefix, test input size)
    "inception_resnet_v2": (jax_irv2.InceptionResNetV2, InceptionResNetV2,
                            "InceptionResnetV2", 75),
    "inception_v1": (jax_iv1.InceptionV1, InceptionV1, "InceptionV1", 32),
}


def _close(got, want, tol, err_msg=""):
    """Every element within ``tol`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, err_msg
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _shapes(name, size):
    cls = TOWERS[name][0]
    return jax.eval_shape(cls().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))


def fake_slim(shapes, prefix, seed):
    """A slim checkpoint dict for every leaf of the flax ``shapes``:
    kernels of variance 1 / fan-in, betas, biases and moving means of a
    tenth to a fifth, moving variances in [0.5, 2]; plus variables the
    graft must skip.  Each name maps back to its leaf by the JAX
    ``slim_to_flax``."""
    rng = np.random.RandomState(seed)
    stats = {"mean": "moving_mean", "var": "moving_variance"}
    slim = {}
    for coll in ("params", "batch_stats"):
        for mod, leaves in shapes.get(coll, {}).items():
            for leaf, s in leaves.items():
                shape = tuple(s.shape)
                if coll == "batch_stats":
                    name = f"{mod[:-10]}/BatchNorm/{stats[leaf]}"
                    arr = (0.2 * rng.randn(*shape) if leaf == "mean"
                           else rng.uniform(0.5, 2.0, shape))
                elif mod.endswith("_BatchNorm"):
                    name, arr = (f"{mod[:-10]}/BatchNorm/beta",
                                 0.1 * rng.randn(*shape))
                elif leaf == "bias":
                    name, arr = f"{mod}/biases", 0.1 * rng.randn(*shape)
                elif mod.endswith("_depthwise"):
                    h, w, _, cm = shape
                    name = f"{mod[:-10]}/depthwise_weights"
                    arr = rng.randn(h, w, 3, cm // 3) / np.sqrt(h * w)
                else:
                    stem = (f"{mod[:-10]}/pointwise_weights"
                            if mod.endswith("_pointwise") else
                            f"{mod}/weights")
                    name = stem
                    arr = rng.randn(*shape) / np.sqrt(np.prod(shape[:3]))
                full = f"{prefix}/{name}"
                assert jax_graft.slim_to_flax(full, prefix) == (
                    coll, mod, leaf), full
                slim[full] = arr.astype(np.float32)
    for skipped in ("Logits/Conv2d_0c_1x1/weights", "global_step",
                    "AuxLogits/Conv2d_1b_1x1/biases",
                    "Conv2d_1a_7x7/weights/ExponentialMovingAverage",
                    "Conv2d_1a_7x7/weights/Adam"):
        slim[f"{prefix}/{skipped}"] = np.zeros(2, np.float32)
    return slim


@functools.lru_cache(maxsize=None)
def _slim(name, size):
    return fake_slim(_shapes(name, size), TOWERS[name][2], seed=3)


def _jax_grafted(name, size):
    """The JAX graft of the fake checkpoint, as numpy."""
    out = jax_graft.graft_slim_variables(_shapes(name, size),
                                         _slim(name, size), TOWERS[name][2])
    return jax.tree.map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def jax_forward(name):
    """The flax tower's eval forward with its endpoints, jitted once a
    tower, the variables an argument (not constants folded into the
    program): one compile a tower and batch shape."""
    return jax.jit(TOWERS[name][0](capture_endpoints=True).apply)


def jax_pre(batch, size):
    """flax_backbone's preprocessing (preprocess/features.py:79-82)."""
    x = jnp.asarray(batch).astype(jnp.float32) / 255.0
    x = jax.image.resize(x, (x.shape[0], size, size, 3), "bilinear")
    return (x - 0.5) * 2.0


@pytest.fixture(scope="module")
def grafted():
    """Per tower: (JAX grafted variables, the port tower grafted from the
    same checkpoint)."""
    out = {}
    for name, (_, cls, prefix, size) in TOWERS.items():
        with torch.device("meta"):
            model = cls()
        model = model.to_empty(device="cpu")
        slim_graft.graft_slim_variables(model, _slim(name, size), prefix)
        out[name] = (_jax_grafted(name, size), model.eval())
    return out


def test_irv2_contract_shapes_and_params():
    """At 299 (on the meta device): the conv endpoint is [B, 1536, 8, 8],
    each endpoint has the slim channels and the JAX spatial size, and the
    trunk has the slim parameter count, JAX's."""
    assert irv2.ENDPOINT_CHANNELS == jax_irv2.ENDPOINT_CHANNELS
    assert irv2.N_PIPELINE_UNITS == jax_irv2.N_PIPELINE_UNITS == 44
    with torch.device("meta"):
        model = InceptionResNetV2(capture_endpoints=True)
        out, eps = model(torch.zeros(2, 3, 299, 299))
    assert tuple(out.shape) == (2, 1536, 8, 8)
    spatial = {"Conv2d_1a_3x3": 149, "Conv2d_2a_3x3": 147,
               "Conv2d_2b_3x3": 147, "Conv2d_3b_1x1": 73,
               "Conv2d_4a_3x3": 71, "Mixed_5b": 35, "Mixed_6a": 17,
               "Mixed_7a": 8, "Conv2d_7b_1x1": 8}
    assert eps.keys() == irv2.ENDPOINT_CHANNELS.keys()
    for k, ch in irv2.ENDPOINT_CHANNELS.items():
        assert tuple(eps[k].shape) == (2, ch, spatial[k], spatial[k]), k
    n = sum(p.numel() for p in model.parameters())
    jax_n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
        _shapes("inception_resnet_v2", 75)["params"]))
    assert n == jax_n == 54_276_192
    assert len(model.units) == 44


def test_iv1_contract_shapes_and_params():
    assert iv1.ENDPOINT_CHANNELS == jax_iv1.ENDPOINT_CHANNELS
    with torch.device("meta"):
        model = InceptionV1(capture_endpoints=True)
        pool, eps = model(torch.zeros(2, 3, 224, 224))
    assert tuple(pool.shape) == (2, 1024)
    for k, ch in iv1.ENDPOINT_CHANNELS.items():
        assert eps[k].shape[1] == ch, k
    assert tuple(eps["Mixed_5c"].shape) == (2, 1024, 7, 7)
    n = sum(p.numel() for p in model.parameters())
    jax_n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
        _shapes("inception_v1", 32)["params"]))
    assert n == jax_n == 5_592_624


@pytest.mark.parametrize("name", list(TOWERS))
def test_eval_forward_and_endpoints_match_flax(name, grafted):
    """Eval mode on the grafted variables, batch 4 at the test size: the
    output and every endpoint (Mixed_5b, Mixed_6a, Mixed_7a among them)
    within EVAL_TOL of each tensor's scale (the port tower holds the same
    state as convert.py makes of the flax variables:
    test_graft_matches_jax_graft_leaf_by_leaf)."""
    size = TOWERS[name][3]
    variables, model = grafted[name]
    x = np.random.RandomState(5).uniform(-1, 1, (4, size, size, 3)) \
        .astype(np.float32)
    want, want_eps = jax_forward(name)(variables, jnp.asarray(x))
    model.capture_endpoints = True
    try:
        with torch.no_grad():
            got, got_eps = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        model.capture_endpoints = False
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    _close(got, want, EVAL_TOL, name)
    assert got_eps.keys() == want_eps.keys()
    for k, v in want_eps.items():
        _close(got_eps[k].permute(0, 2, 3, 1), v, EVAL_TOL, f"{name} {k}")


def test_irv2_unit_ranges_compose(grafted):
    """The unit form run as contiguous segments [0, 1), [1, 13), [13,
    34), [34, 43), [43, 44), each on the previous one's output, is the
    whole forward bit for bit; capture_endpoints needs the full range."""
    _, model = grafted["inception_resnet_v2"]
    x = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (2, 3, 75, 75)).astype(np.float32))
    with torch.no_grad():
        h = x
        for lo, hi in ((0, 1), (1, 13), (13, 34), (34, 43), (43, 44)):
            h = model(h, unit_lo=lo, unit_hi=hi)
        assert torch.equal(h, model(x))
    with torch.device("meta"):
        meta = InceptionResNetV2(capture_endpoints=True)
    with pytest.raises(ValueError, match="full unit range"):
        meta(x.to("meta"), unit_hi=3)


def _patched_init(cls, size):
    """flax ``init`` returning the zero-filled shapes (the graft fills
    every leaf; see the module docstring)."""
    shapes = _shapes({v[0]: k for k, v in TOWERS.items()}[cls], size)
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return lambda self, key, x: zeros


@pytest.fixture
def jax_backbone(monkeypatch):
    def make(name, npz, size, **kw):
        cls = TOWERS[name][0]
        monkeypatch.setattr(cls, "init", _patched_init(cls, size))
        return jax_features.flax_backbone(name, npz, image_size=size, **kw)
    return make


@pytest.mark.parametrize("name", list(TOWERS))
def test_slim_backbone_matches_flax_backbone(name, tmp_path, grafted):
    """The same slim .npz in both packages; uint8 frames that the resize
    shrinks and ones it enlarges; 3 frames.  The JAX side is
    ``flax_backbone``'s body, ``apply(variables, _pre(batch))`` on the
    batch padded to 4, with the JAX graft of the .npz passed to the
    shared ``jax_forward`` (``flax_backbone`` itself folds the variables
    into one program a frame shape, 10 s a compile for this trunk; it
    runs in test_extract_sessions_on_jpeg_frames_matches_jax).  Port
    against JAX within BACKBONE_TOL of the output's scale; Inception-
    ResNet-v2 returns NHWC [B, 1, 1, 1536] at 75, InceptionV1 [B, 1024],
    f32.  An unknown tower raises."""
    _, _, prefix, size = TOWERS[name]
    npz = str(tmp_path / "slim.npz")
    np.savez(npz, **_slim(name, size))
    port = features.slim_backbone(name, npz, image_size=size, device="cpu")
    variables = grafted[name][0]
    rng = np.random.RandomState(7)
    for hw in ((2 * size + 6, 2 * size - 10), (size // 2 + 3, size - 9)):
        frames = rng.randint(0, 256, (3,) + hw + (3,)).astype(np.uint8)
        padded = np.concatenate([frames, np.zeros_like(frames[:1])])
        want = np.asarray(jax_forward(name)(
            variables, jax_pre(padded, size))[0])[:3]
        got = port(frames)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == ((3, 1, 1, 1536) if name.endswith("v2")
                             else (3, 1024))
        _close(got, want, BACKBONE_TOL, f"{name} {hw}")
    with pytest.raises(NotImplementedError):
        features.slim_backbone("nosuchnet", device="cpu")


def test_extract_sessions_on_jpeg_frames_matches_jax(tmp_path, jax_backbone,
                                                     capsys):
    """JPEG frame directories from a seed (5 and 3 frames, and one with
    none): the port's extract_sessions writes one f32 .npy a session with
    the JAX one's values (InceptionV1 at 32, batch 4: a full batch and a
    padded tail), skips the frameless session with its message and a
    session whose file exists."""
    from PIL import Image
    name, size = "inception_v1", 32
    npz = str(tmp_path / "slim.npz")
    np.savez(npz, **_slim(name, size))
    rng = np.random.RandomState(8)
    frame_root = tmp_path / "frames"
    for sess, n in (("s1", 5), ("s2", 3), ("empty", 0)):
        d = frame_root / sess
        d.mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
            Image.fromarray(img).save(str(d / f"frame_{i:04d}.jpg"))
    sessions = ["s1", "s2", "empty"]
    out = {}
    for tag, mod, fn in (
            ("jax", jax_features, jax_backbone(name, npz, size)),
            ("port", features, features.slim_backbone(
                name, npz, image_size=size, device="cpu"))):
        root = str(tmp_path / tag)
        mod.extract_sessions(sessions, str(frame_root), root, fn,
                             batch_size=4)
        out[tag] = root
        assert sorted(os.listdir(root)) == ["s1.npy", "s2.npy"]
    assert "empty: no frame_*.jpg" in capsys.readouterr().out
    for sess, n in (("s1", 5), ("s2", 3)):
        got = np.load(os.path.join(out["port"], sess + ".npy"))
        want = np.load(os.path.join(out["jax"], sess + ".npy"))
        assert got.shape == (n, 1024) and got.dtype == np.float32
        _close(got, want, BACKBONE_TOL, sess)
    before = os.path.getmtime(os.path.join(out["port"], "s1.npy"))
    features.extract_sessions(["s1"], str(frame_root), out["port"],
                              lambda b: 1 / 0)
    assert os.path.getmtime(os.path.join(out["port"], "s1.npy")) == before


def test_text_features_match_jax():
    wv = {"riding": np.arange(4, dtype=np.float32),
          "a": 2 * np.ones(4, np.float32)}
    args = (["riding_a_horse", "unknownword", "a"], wv)
    kw = dict(counts=[3, 2, 1], dim=4, noise=0.01)
    got = features.text_features(*args, rng=np.random.RandomState(0), **kw)
    want = jax_features.text_features(*args, rng=np.random.RandomState(0),
                                      **kw)
    np.testing.assert_array_equal(got, want)
