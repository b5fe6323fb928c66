"""The port's pipelined backbone (``…_torch/parallel/pipeline.py``) against
the JAX one (``parallel/pipeline.py``): the stage split's bounds, the
stage machinery on a torch twin of the JAX tests' unit-segmented stub
trunk (output against the single forward and against the flax stub on the
same variables, disjoint stages, microbatch remainder, empty input,
errors, FLOP profile, sharing a device with a training step), and on the
real Inception-ResNet-v2 trunk the stage ranges and per-stage counts
against the JAX pipeline's and the output against the whole forward; then
``preprocess.features`` with ``--pipeline_stages 2`` through the
dispatcher.  Stages run on the CPU here (``devices=["cpu", ...]``); the
card's streams run in chip_smoke.py.  Tolerances at each assertion."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from multimodal_similarity_tpu.models.inception_resnet_v2 import (
    InceptionResNetV2 as JaxIRv2)
from multimodal_similarity_tpu.parallel import pipeline as jax_pipeline
from multimodal_similarity_tpu_torch import __main__ as port_main
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.models.inception_v2 import (
    BatchNorm, Conv)
from multimodal_similarity_tpu_torch.parallel import (
    INCEPTION_RESNET_V2_UNIT_COSTS, PipelinedBackbone, profile_unit_costs,
    split_units_balanced)
from multimodal_similarity_tpu_torch.preprocess.features import build_tower
from test_torch_backbones import _slim

N_STUB_UNITS = 6
CPU3 = ["cpu"] * 3


class JaxStub(flax_nn.Module):
    """The JAX tests' stub trunk (tests/test_pipeline.py:20-52)."""

    width: int = 8

    @flax_nn.compact
    def __call__(self, x, train: bool = False, unit_lo: int = 0,
                 unit_hi: int = N_STUB_UNITS):
        def stem(h):
            h = flax_nn.Conv(self.width, (3, 3), strides=(2, 2),
                             use_bias=False, name="stem")(h)
            h = flax_nn.BatchNorm(use_running_average=not train,
                                  use_scale=False, name="stem_BatchNorm")(h)
            return flax_nn.relu(h)

        def block(i):
            def f(h):
                up = flax_nn.Conv(self.width, (3, 3), name=f"block_{i}")(h)
                return flax_nn.relu(h + 0.2 * up)
            return f

        def head(h):
            return flax_nn.Conv(2 * self.width, (1, 1), name="head")(h)

        units = [stem] + [block(i) for i in range(4)] + [head]
        h = x
        for fn in units[unit_lo:unit_hi]:
            h = fn(h)
        return h


class _Stem(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.stem = Conv(3, width, 3, 2)
        # flax's BatchNorm defaults: momentum 0.99, epsilon 1e-5
        self.stem_BatchNorm = BatchNorm(width, 0.99, 1e-5)

    def forward(self, h):
        return torch.relu(self.stem_BatchNorm(self.stem(h)))


class _Block(torch.nn.Module):
    def __init__(self, i, width):
        super().__init__()
        self.name = f"block_{i}"
        self.add_module(self.name, Conv(width, width, 3, bias=True))

    def forward(self, h):
        return torch.relu(h + 0.2 * getattr(self, self.name)(h))


class _Head(torch.nn.Module):
    def __init__(self, width):
        super().__init__()
        self.head = Conv(width, 2 * width, 1, bias=True)

    def forward(self, h):
        return self.head(h)


class StubTrunk(torch.nn.Module):
    """The stub in the port's unit protocol: NCHW, ``units`` a ModuleList
    holding the flax scopes, and the scope table ``convert.py`` reads."""

    def __init__(self, width=8):
        super().__init__()
        self.units = torch.nn.ModuleList(
            [_Stem(width)] + [_Block(i, width) for i in range(4)]
            + [_Head(width)])

    def flax_scopes(self):
        return {name: f"units.{i}.{name}"
                for i, unit in enumerate(self.units)
                for name, _ in unit.named_children()}

    def forward(self, x, unit_lo=0, unit_hi=N_STUB_UNITS):
        for unit in self.units[unit_lo:unit_hi]:
            x = unit(x)
        return x


@pytest.fixture(scope="module")
def trunk_npz(tmp_path_factory):
    """A slim .npz of the whole Inception-ResNet-v2 trunk, from a seed
    (grafting it costs less than a random init of 54M weights)."""
    path = str(tmp_path_factory.mktemp("slim") / "irv2.npz")
    np.savez(path, **_slim("inception_resnet_v2", 75))
    return path


@pytest.fixture(scope="module")
def stub():
    """(port stub holding the flax stub's variables, input NCHW, the flax
    stub's output NCHW)."""
    x = np.random.RandomState(0).randn(4, 16, 16, 3).astype(np.float32)
    jm = JaxStub()
    variables = jax.tree.map(np.asarray,
                             jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(1)
    stats = {"mean": 0.2 * rng.randn(8).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    variables["batch_stats"]["stem_BatchNorm"] = stats
    variables["params"]["stem_BatchNorm"]["bias"] = \
        0.1 * rng.randn(8).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, x)).transpose(0, 3, 1, 2)
    model = StubTrunk()
    load_flax_params(model, variables["params"], variables["batch_stats"])
    return model.eval(), np.ascontiguousarray(x.transpose(0, 3, 1, 2)), want


def test_split_units_balanced_gives_the_jax_bounds():
    """The same bounds as JAX for skewed, uniform, random and the trunk's
    own costs at 1-8 stages; the same error for too many stages."""
    cases = [([1, 1, 1, 10, 1, 1], 3), ([1.0] * 7, 3)]
    cases += [(INCEPTION_RESNET_V2_UNIT_COSTS, s) for s in range(1, 9)]
    rng = np.random.RandomState(2)
    cases += [(list(rng.rand(n)), s) for n, s in ((12, 4), (44, 5), (5, 5))]
    for costs, s in cases:
        assert split_units_balanced(costs, s) == \
            jax_pipeline.split_units_balanced(costs, s), (costs, s)
    assert INCEPTION_RESNET_V2_UNIT_COSTS == \
        jax_pipeline.INCEPTION_RESNET_V2_UNIT_COSTS
    for bad in (0, 4):
        with pytest.raises(ValueError, match="n_stages"):
            split_units_balanced([1.0] * 3, bad)


def test_pipeline_matches_single_forward_and_flax(stub):
    """Three stages, microbatch 2: the single port forward bit for bit,
    and the flax stub within 1e-5 of its scale."""
    model, x, want = stub
    pipe = PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], n_stages=3,
                             devices=CPU3, microbatch=2)
    assert len(pipe.stage_ranges) == 3
    out = pipe(x)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_pipeline_partitions_parameters_disjointly(stub):
    """The stages hold copies of the units, disjoint, together every
    parameter and buffer once, on their devices; the model is not
    moved; the counts add up to the model's."""
    model, x, _ = stub
    pipe = PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], n_stages=3,
                             devices=CPU3, microbatch=2)
    assert pipe.devices == [torch.device("cpu")] * 3
    own = {id(t) for t in list(model.parameters()) + list(model.buffers())}
    seen = []
    for stage, (lo, hi) in zip(pipe.stages, pipe.stage_ranges):
        names = [n for n, _ in stage.units.named_parameters()]
        want = [n for u in range(lo, hi)
                for n, _ in model.units[u].named_parameters()]
        assert sorted(n.split(".", 1)[1] for n in names) == sorted(want)
        tensors = list(stage.parameters()) + list(stage.buffers())
        assert not own & {id(t) for t in tensors}
        seen += [id(t) for t in tensors]
    assert len(seen) == len(set(seen))
    total = sum(t.numel() for t in list(model.parameters())
                + list(model.buffers()))
    assert sum(pipe.stage_parameter_counts()) == total


def test_pipeline_microbatch_remainder_and_empty(stub):
    model, x, _ = stub
    pipe = PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], n_stages=2,
                             devices=["cpu", "cpu"], microbatch=3)
    # B=4 with microbatch 3: the last microbatch is padded, then trimmed
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    out = pipe(x)
    assert out.shape[0] == 4
    np.testing.assert_array_equal(out, ref)
    empty = pipe(np.zeros((0, 3, 16, 16), np.float32))
    assert empty.shape == (0,) + ref.shape[1:]


def test_pipeline_errors(stub, monkeypatch):
    """As in JAX: more stages than visible devices, ranges that do not
    tile, unit_costs of the wrong length; and units that leave a
    parameter out or share one."""
    model, x, _ = stub
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="are visible"):
        PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], n_stages=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="at least one device"):
        PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:])
    with pytest.raises(ValueError, match="do not tile"):
        PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], devices=CPU3[:2],
                          stage_ranges=[(0, 2), (3, N_STUB_UNITS)])
    with pytest.raises(ValueError, match="unit_costs"):
        PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:], devices=CPU3[:2],
                          unit_costs=[1.0] * 3)
    extra = StubTrunk()
    extra.scale = torch.nn.Parameter(torch.ones(1))
    with pytest.raises(ValueError, match="not claimed"):
        PipelinedBackbone(extra, N_STUB_UNITS, x.shape[1:], devices=CPU3[:2])
    shared = StubTrunk()
    shared.units[2].block_1.weight = shared.units[1].block_0.weight
    with pytest.raises(ValueError, match="re-claims"):
        PipelinedBackbone(shared, N_STUB_UNITS, x.shape[1:], devices=CPU3[:2])


def test_profile_unit_costs_counts_conv_flops(stub):
    """FlopCounterMode's count a unit: the convolutions' 2 x MACs (the
    3x3 blocks at full width cost more than the 1x1 head, as in JAX)."""
    model, x, _ = stub
    costs = profile_unit_costs(model, N_STUB_UNITS, x.shape[1:])
    hw = 8 * 8                      # the stem halves 16 x 16
    assert costs == [2.0 * hw * 8 * 3 * 9] + [2.0 * hw * 8 * 8 * 9] * 4 \
        + [2.0 * hw * 16 * 8]
    assert costs[1] > costs[5]


def test_pipeline_shares_its_device_with_training(stub):
    """Co-tenancy (tests/test_pipeline.py:206): two stages on one device,
    a training step of another model issued between extraction calls;
    each extraction equals the single forward and training steps."""
    from multimodal_similarity_tpu_torch.models import build_encoder
    model, x, _ = stub
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    pipe = PipelinedBackbone(model, N_STUB_UNITS, x.shape[1:],
                             devices=["cpu", "cpu"], microbatch=2)
    gen = torch.Generator().manual_seed(0)
    enc = build_encoder("convrtsn", num_seg=3, emb_dim=8, n_input=8,
                        n_h=2, n_w=2, n_C=4, generator=gen)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01)
    feats = torch.randn(16, 3, 2, 2, 8, generator=gen)
    before = [p.detach().clone() for p in enc.parameters()]
    for _ in range(3):
        opt.zero_grad()
        loss = enc(feats).pow(2).mean()
        loss.backward()
        opt.step()
        np.testing.assert_array_equal(pipe(x), ref)
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, enc.parameters()))


def test_real_trunk_stages_match_jax_pipeline(trunk_npz):
    """Inception-ResNet-v2 at 75 x 75 over 4 stages with the FLOP costs:
    the JAX pipeline's stage ranges and per-stage counts (its variables
    from eval_shape), and the port's output equal to the whole forward."""
    size = 75
    shapes = jax.eval_shape(JaxIRv2().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jpipe = jax_pipeline.PipelinedBackbone(
        JaxIRv2(), variables, n_units=44, input_shape=(size, size, 3),
        n_stages=4, microbatch=2,
        unit_costs=jax_pipeline.INCEPTION_RESNET_V2_UNIT_COSTS)
    model, _ = build_tower("inception_resnet_v2", trunk_npz, device="cpu")
    pipe = PipelinedBackbone(model, 44, (3, size, size), devices=["cpu"] * 4,
                             microbatch=2,
                             unit_costs=INCEPTION_RESNET_V2_UNIT_COSTS)
    assert pipe.stage_ranges == [tuple(r) for r in jpipe.stage_ranges]
    assert pipe.stage_parameter_counts() == jpipe.stage_parameter_counts()
    assert min(pipe.stage_parameter_counts()) > 0
    x = np.random.RandomState(1).uniform(-1, 1, (3, 3, size, size)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(pipe(x), ref)


def test_features_cli_pipeline_matches_single_device(tmp_path, capsys,
                                                    trunk_npz, monkeypatch):
    """``python -m multimodal_similarity_tpu_torch preprocess.features
    --pipeline_stages 2 --frame_shape 24x40 --slim_checkpoint ... --device
    cpu`` writes the same NHWC features as the single-device run, within
    1e-6 of their scale (the stages' copies run the same CPU kernels; 0
    observed).  ``slim_backbone`` is wrapped to the 75 x 75 input of the
    other tests and microbatches of 2 (the CLI has no flag for either);
    the flags the CLI passes reach it unchanged."""
    from PIL import Image
    from multimodal_similarity_tpu_torch.preprocess import features
    calls = []
    slim_backbone = features.slim_backbone

    def small(*args, **kw):
        calls.append(kw)
        return slim_backbone(*args, image_size=75, pipeline_microbatch=2,
                             **kw)

    monkeypatch.setattr(features, "slim_backbone", small)
    frames = tmp_path / "frames" / "s1"
    frames.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)) \
            .save(str(frames / f"frame_{i:04d}.jpg"))
    (tmp_path / "sessions.txt").write_text("s1\n")
    out = {}
    for tag, extra in (("one", []), ("pipe", ["--pipeline_stages", "2",
                                              "--frame_shape", "24x40"])):
        root = str(tmp_path / tag)
        assert port_main.main([
            "preprocess.features", "--frame_root",
            str(tmp_path / "frames"), "--feature_root", root,
            "--session_file", str(tmp_path / "sessions.txt"),
            "--slim_checkpoint", trunk_npz, "--device", "cpu"] + extra) == 0
        out[tag] = np.load(os.path.join(root, "s1.npy"))
    assert calls[1] == {"pipeline_stages": 2, "frame_shape": (24, 40),
                        "device": "cpu"}
    assert out["one"].shape == (3, 1, 1, 1536)
    assert out["one"].dtype == np.float32
    np.testing.assert_allclose(out["pipe"], out["one"], rtol=0,
                               atol=1e-6 * np.abs(out["one"]).max())
    assert "s1: 3 frames embedded" in capsys.readouterr().out
