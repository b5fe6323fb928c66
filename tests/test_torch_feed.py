"""The port's device feed (``data/device_feed.py``) against the JAX
package's: int8 quantizing, the bf16 host cast, dequantizing and the
placer bit for bit on the CPU; the prefetch thread's order, hand-over and
errors; and the batch-hard trainer with each feature flag against the JAX
trainer with the same flag."""

import sys
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_trainer import _one_epoch_pair

from multimodal_similarity_tpu.data.device_feed import (
    make_batch_placer as jax_make_batch_placer,
    quantize_features as jax_quantize)
from multimodal_similarity_tpu.train.steps import (
    dequant_features as jax_dequant, take_features as jax_take)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_feed import (
    BatchPlacer, dequant_features, device_prefetch, feature_keys,
    quantize_features, take_features)
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_batchhard)

# flat [N, S, D], conv [N, S, h, w, C], and the short forms
SHAPES = [(37, 3, 24), (20, 3, 4, 4, 16), (9, 7), (12, 3, 5, 6)]


def _features(shape, seed=0):
    """Features spanning magnitudes, with an all-zero event (scale floor)
    and a hot channel."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape) * rng.choice([1e-4, 1.0, 300.0], size=shape)
    a[0] = 0.0
    a[..., -1] *= 50.0
    return a.astype(np.float32)


def _bits(x):
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_features_bit_equal(shape):
    """q and scale equal the JAX package's bit for bit (tolerance 0), and
    dequantized rows lie within scale / 2 of the input (plus 1e-4 scale
    for the f32 roundings of x / scale and q * scale)."""
    a = _features(shape)
    q, scale = quantize_features(a)
    want_q, want_scale = jax_quantize(a)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(want_scale))
    err = np.abs(q.numpy() * scale.numpy() - a)
    assert np.all(err <= scale.numpy() * (0.5 + 1e-4))


def _bf16_specials():
    """f32 values around bf16's rounding: ties to even both ways, values
    just off a tie, subnormals, the largest finites, infinities."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)                     # bf16 spacing at 1
    vals = [one + ulp / 2,                          # tie -> 1 (even)
            one + ulp * 1.5,                        # tie -> 1 + 2 ulp
            np.nextafter(one + ulp / 2, np.float32(2)),   # just above a tie
            np.nextafter(one + ulp / 2, np.float32(0)),   # just below
            -(one + ulp * 1.5),
            np.float32(1e-40), np.float32(-3e-39), np.float32(1.4e-45),
            np.float32(1.1754942e-38),              # largest subnormal
            np.finfo(np.float32).max, -np.finfo(np.float32).max,
            np.float32(3.3961776e38),               # rounds to bf16 max
            np.inf, -np.inf, 0.0, -0.0, 65504.5, 1e20]
    rng = np.random.RandomState(3)
    return np.concatenate([np.asarray(vals, np.float32),
                           (rng.randn(500) * 10.0 ** rng.randint(
                               -30, 30, 500)).astype(np.float32)])


def test_bf16_host_cast_matches_ml_dtypes():
    """The placer's bf16 cast (round to nearest even) equals ml_dtypes bit
    for bit, ties, subnormals and infinities included; NaN stays NaN."""
    vals = _bf16_specials()
    events = np.resize(vals, (40, 3, 2, 2, 8)).astype(np.float32)
    events[5, 0, 0, 0, :3] = np.nan
    out = BatchPlacer("cpu", ("events",), bf16_keys=("events",))(
        {"events": events})["events"]
    want = events.astype(ml_dtypes.bfloat16)
    got = out.view(torch.int16).numpy()
    nan = np.isnan(events)
    assert out.dtype == torch.bfloat16
    assert np.isnan(out.float().numpy()[nan]).all()
    np.testing.assert_array_equal(got[~nan], want.view(np.int16)[~nan])


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_dequant_and_take_features_bit_equal(shape):
    """bf16 q * scale and the int8 row gather equal the JAX steps' bit for
    bit; a dense tensor passes through."""
    a = _features(shape, seed=1)
    q, scale = quantize_features(a)
    idx = np.array([3, 0, 3, 8, 1])
    got = dequant_features(take_features({"q": q, "scale": scale},
                                         torch.from_numpy(idx)))
    want = jax_dequant(jax_take({"q": jnp.asarray(q.numpy()),
                                 "scale": jnp.asarray(scale.numpy())},
                                jnp.asarray(idx)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    dense = torch.from_numpy(a)
    assert dequant_features(dense) is dense


@pytest.mark.parametrize("kind", ["plain", "bf16", "int8"])
def test_cpu_placer_matches_jax_placer(kind):
    """The CPU placer with a row selection gives the arrays the JAX placer
    gives for the pre-gathered batch (tolerance 0), keeps host entries, and
    gathers labels and mask by the same rows."""
    events = _features((30, 3, 2, 2, 8), seed=2)
    labels = np.arange(30, dtype=np.int32)
    mask = (np.arange(30) % 4 != 0).astype(np.float32)
    rows = np.array([29, 2, 2, 17, 0, 11, 5, 23, 8, 14, 1, 26, 19, 3, 7,
                     21, 9, 12, 4, 27])        # 20 rows: two cast chunks
    casts = {"plain": {}, "bf16": {"bf16_keys": ("events",)},
             "int8": {"int8_keys": ("events",)}}[kind]
    keys = ("events", "labels", "mask")
    got = BatchPlacer("cpu", keys, **casts)(
        {"events": events, "labels": labels, "mask": mask, "rows": rows,
         "num_events": 30})
    want = jax_make_batch_placer(keys, **casts)(
        {"events": events[rows], "labels": labels[rows],
         "mask": mask[rows]})
    assert got["num_events"] == 30 and "rows" not in got
    for key in ("labels", "mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    if kind == "int8":
        for part in ("q", "scale"):
            np.testing.assert_array_equal(
                _bits(got["events"][part].numpy()),
                _bits(np.asarray(want["events"][part])))
    elif kind == "bf16":
        np.testing.assert_array_equal(
            got["events"].view(torch.int16).numpy(),
            np.asarray(want["events"]).view(np.int16))
    else:
        np.testing.assert_array_equal(got["events"].numpy(),
                                      np.asarray(want["events"]))


def test_prefetch_order_handover_and_errors():
    """Under a short switch interval: every batch arrives once, in order,
    with its values, None passes through; a failure in the source and a
    change of batch shape raise in the consumer; closing early stops the
    feed thread (each wait bounded)."""
    rng = np.random.RandomState(4)
    batches = [None if i % 7 == 3 else
               {"events": rng.randn(6, 3, 4).astype(np.float32),
                "rows": rng.randint(0, 6, 4)} for i in range(60)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(device_prefetch(iter(batches), "cpu", ("events",),
                                   int8_keys=("events",)))
        assert len(got) == len(batches)
        for b, g in zip(batches, got):
            if b is None:
                assert g is None
                continue
            q, scale = quantize_features(b["events"][b["rows"]])
            assert torch.equal(g["events"]["q"], q)
            assert torch.equal(g["events"]["scale"], scale)

        def failing():
            yield {"events": np.zeros((2, 3), np.float32)}
            raise OSError("disk gone")

        stream = device_prefetch(failing(), "cpu", ("events",))
        assert next(stream)["events"].shape == (2, 3)
        with pytest.raises(OSError, match="disk gone"):
            next(stream)

        def changing():
            for n in (4, 4, 3):
                yield {"events": np.zeros((n, 3), np.float32)}

        stream = device_prefetch(changing(), "cpu", ("events",))
        next(stream), next(stream)
        with pytest.raises(ValueError, match="layout changed"):
            next(stream)

        before = threading.active_count()
        endless = ({"events": np.full((2, 2), i, np.float32)}
                   for i in range(10 ** 9))
        stream = device_prefetch(endless, "cpu", ("events",))
        assert next(stream)["events"][0, 0] == 0
        stream.close()
        assert threading.active_count() <= before
    finally:
        sys.setswitchinterval(old)


def test_feature_keys_follow_the_flags():
    base = TrainConfig(name="t").resolve()
    assert feature_keys(base) == {"bf16_keys": (), "int8_keys": ()}
    assert feature_keys(TrainConfig(name="t", bf16_features=True).resolve()
                        ) == {"bf16_keys": ("events",), "int8_keys": ()}
    assert feature_keys(TrainConfig(name="t", int8_features=True).resolve()
                        ) == {"bf16_keys": (), "int8_keys": ("events",)}


@pytest.mark.parametrize("flag,pin,rtol", [
    pytest.param("bf16_features", True, 1e-4, id="bf16_features"),
    pytest.param("int8_features", True, 1e-4, id="int8_features"),
    pytest.param("int8_features", False, 3e-3,
                 id="int8_features-unpinned")])
def test_batchhard_feature_flag_matches_jax_trainer(tmp_path, monkeypatch,
                                                    flag, pin, rtol):
    """The batch-hard trainer with --bf16_features or --int8_features, one
    epoch from the same initial params: the loss trace at ``rtol`` (f32
    stats, as the JAX ring pass) and val mAP at atol 1e-3.  XLA's compiled
    step keeps the dequantized product q * scale in f32 (it may skip the
    bf16 rounding, allow_excess_precision), 9.7e-4 relative off in the loss
    at this size; ``pin`` holds the JAX dequantization to the bf16 rounding
    it states and the port does (rtol 1e-4), and the unpinned case holds
    the JAX trainer as it is (rtol 3e-3), so a drift of the real JAX path
    still shows."""
    import jax
    from multimodal_similarity_tpu.train import steps as jax_steps
    from multimodal_similarity_tpu.train.trainers import (
        base_model_batchhard as jax_trainer)

    def rounded_dequant(x):
        if isinstance(x, dict) and "q" in x:
            return jax.lax.reduce_precision(
                x["q"].astype(jnp.float32)
                * x["scale"].astype(jnp.bfloat16).astype(jnp.float32),
                exponent_bits=8, mantissa_bits=7).astype(jnp.bfloat16)
        return x

    if pin:
        monkeypatch.setattr(jax_steps, "dequant_features", rounded_dequant)
    real_step = base_model_batchhard.make_balanced_batch_step
    monkeypatch.setattr(
        base_model_batchhard, "make_balanced_batch_step",
        lambda *a, **k: real_step(*a, **dict(k, precision="f32")))
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, base_model_batchhard.train, jax_trainer.train,
        **{flag: True})
    assert steps == len(want_loss) == 3
    np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)
