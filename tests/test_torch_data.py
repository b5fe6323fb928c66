"""The port's host data path and config against the JAX package's: the same
seed gives the same loader batches and balanced indices, and the same argv
gives the same config.  All comparisons are exact."""

import dataclasses
import pathlib
import random
import re

import numpy as np
import pytest

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import (
    SessionBatchLoader as JaxLoader,
    generate_synthetic_honda as jax_generate,
    load_validation_set as jax_load_val,
    prepare_dataset as jax_prepare,
    tsn_prepare_input as jax_tsn,
    tsn_prepare_input_test as jax_tsn_test,
)
from multimodal_similarity_tpu.ops.mining import (
    select_batch_balanced as jax_select)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data import (
    SessionBatchLoader,
    generate_synthetic_honda,
    load_validation_set,
    prepare_dataset,
    tsn_prepare_input,
    tsn_prepare_input_test,
)
from multimodal_similarity_tpu_torch.ops.mining import select_batch_balanced

PKG = pathlib.Path(__file__).resolve().parents[1] / \
    "multimodal_similarity_tpu_torch"


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("honda_port_data"))
    generate_synthetic_honda(root, n_sessions=6, frames_per_session=200,
                             modal_dims={"resnet": (2, 2, 4)}, seed=3)
    return root


def test_synthetic_generator_writes_the_same_files(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    split_a = generate_synthetic_honda(a, n_sessions=3, frames_per_session=50,
                                       modal_dims={"sensors": (8,)}, seed=1)
    split_b = jax_generate(b, n_sessions=3, frames_per_session=50,
                           modal_dims={"sensors": (8,)}, seed=1)
    assert split_a == split_b
    for f in sorted((tmp_path / "a").rglob("*.npy")):
        other = tmp_path / "b" / f.relative_to(tmp_path / "a")
        np.testing.assert_array_equal(np.load(f), np.load(other))


def test_loader_batches_identical(synth_root):
    sessions = [f"2017{i:08d}" for i in range(6)]
    feat, lab = synth_root + "/features", synth_root + "/labels"
    import functools
    port = SessionBatchLoader(
        prepare_dataset(feat, sessions, "resnet", lab), sess_per_batch=2,
        event_budget=40, prepare_funcs=[functools.partial(
            tsn_prepare_input, 3)], seed=7)
    ref = JaxLoader(
        jax_prepare(feat, sessions, "resnet", lab), sess_per_batch=2,
        event_budget=40, prepare_funcs=[functools.partial(jax_tsn, 3)],
        seed=7)
    for _ in range(2):  # two epochs: the rng carries across them
        got, want = list(port.epoch()), list(ref.epoch())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]),
                                              np.asarray(w[key]))


def test_validation_set_identical(synth_root):
    sessions = ["201700000004", "201700000005"]
    feat, lab = synth_root + "/features", synth_root + "/labels"
    import functools
    got = load_validation_set(prepare_dataset(feat, sessions, "resnet", lab),
                              functools.partial(tsn_prepare_input_test, 3))
    want = jax_load_val(jax_prepare(feat, sessions, "resnet", lab),
                        functools.partial(jax_tsn_test, 3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("batch_size", [7, 64])
def test_balanced_indices_identical(batch_size):
    labels = np.random.RandomState(0).randint(0, 5, size=90)
    got = select_batch_balanced(labels, batch_size, rng=random.Random(3))
    want = jax_select(labels, batch_size, rng=random.Random(3))
    np.testing.assert_array_equal(got, want)
    assert got.size == batch_size and (labels[got] != 0).all()


@pytest.mark.parametrize("argv", [
    [],
    ["--name", "bh", "--network", "convrtsn", "--feat", "resnet",
     "--batch_size", "512", "--event_per_batch", "1000", "--emb_dim", "128",
     "--learning_rate", "1e-2", "--keep_prob", "0.5", "--no_normalized",
     "--no_soft", "--train_session", "a,b,c", "--val_session", "d",
     "--log_flush_every", "4"],
])
def test_config_parsing_parity(argv, tmp_path):
    argv = ["--DATA_ROOT", str(tmp_path)] + argv
    got, want = TrainConfig.parse(argv), JaxTrainConfig.parse(argv)
    names = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert {f.name for f in dataclasses.fields(TrainConfig)} == names
    for name in sorted(names):
        assert getattr(got, name) == getattr(want, name), name


def test_package_imports_no_jax():
    """The port and chip_smoke.py import neither JAX nor any module of the
    JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
        r"multimodal_similarity_tpu)(\.|\s|$)", re.M)
    files = list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders
    assert len(files) > 20
