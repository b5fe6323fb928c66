"""The port's multimodal flagship (``multimodal_model`` on the host miners
and under ``--device_mining``, ``multimodal_model_hardonly``,
``multimodal_model_weak``) against the JAX package: the multimodal data
path, the hard + structure miners fed the JAX Gumbel draws, the host
selectors, one epoch of each trainer from the same initial variables
(dropout off), the branch restore, the frozen scopes, the CLIs and the
option errors.  Small sizes: budget 48, ConvRTSN 2 x 2 x 8 with n_C 4 and
emb_dim 16.  Tolerances at each assertion."""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_base_model import rounded_dequant
from test_torch_trainer import _cfg

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import datasets as jax_datasets
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.models import PDDM as JaxPDDM
from multimodal_similarity_tpu.models import RTSN as JaxRTSN
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.ops import mining as jax_mining
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import _honda as jax_honda
from multimodal_similarity_tpu.train.trainers import (
    multimodal_model as jax_mm, multimodal_model_hardonly as jax_hardonly,
    multimodal_model_weak as jax_weak)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.data import datasets
from multimodal_similarity_tpu_torch.models import PDDM, RTSN
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.trainers import (
    multimodal_model, multimodal_model_hardonly, multimodal_model_weak)
from multimodal_similarity_tpu_torch.train.trainers._honda import (
    HondaExperiment)

CONV = dict(network="convrtsn", n_input=8, n_h=2, n_w=2, n_C=4, num_seg=3,
            emb_dim=16)
DIMS = {"resnet": (2, 2, 8), "sensors": (8,), "segment": (12,)}
BUDGET = 48
MM = dict(triplet_per_batch=24, num_negative=3, lambda_multimodal=0.5,
          sess_per_batch=1, max_epochs=1, log_flush_every=1)
BRANCHES = ("modality_sensors", "modality_segment")
# the PDDM output layer's weights are multiplied by PDDM_SCALE, and its
# similar-class bias moved by PDDM_SHIFT, in the trainer runs: the
# pseudo-similarities then spread over [0, 1] (random heads give about 0.5
# everywhere), so the hard, structure and confident pseudo-label miners
# all find triplets
PDDM_SCALE, PDDM_SHIFT = 100.0, -3.0


def _data(tmp_path, modalities=("resnet", "sensors", "segment")):
    """5 sessions of short events (4-15 frames) in the given modalities."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={m: DIMS[m] for m in modalities},
                             seed=0, length_range=(4, 16))
    return root


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _column(recs, key):
    return [r[key] for r in recs if key in r]


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------

def test_multimodal_experiment_matches_jax(tmp_path):
    """``prepare_multimodal_dataset`` and the multimodal HondaExperiment
    give the JAX package's rows, validation arrays (``val_feats``,
    ``val_extra``, labels), ``labeled_sessions``, and one epoch of loader
    batches (events, events2, events3, labels, mask, sessions), all
    equal."""
    root = _data(tmp_path)
    feats = ["resnet", "sensors", "segment"]
    kw = dict(DATA_ROOT=root, feat=",".join(feats), sess_per_batch=1,
              label_num=2, **CONV)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    assert datasets.prepare_multimodal_dataset(
        pcfg.feature_root, pcfg.train_session, feats, pcfg.label_root) == \
        jax_datasets.prepare_multimodal_dataset(
            jcfg.feature_root, jcfg.train_session, feats, jcfg.label_root)

    jexp = jax_honda.HondaExperiment(jcfg, modalities=feats,
                                     event_budget=BUDGET,
                                     result_dir=str(tmp_path / "jax"),
                                     limit_label_num=False)
    pexp = HondaExperiment(pcfg, modalities=feats, event_budget=BUDGET,
                           result_dir=str(tmp_path / "port"),
                           limit_label_num=False)
    try:
        assert pexp.train_set == [list(r) for r in jexp.train_set]
        assert pexp.labeled_sessions == jexp.labeled_sessions
        assert len(pexp.labeled_sessions) == 2
        np.testing.assert_array_equal(pexp.val_feats, jexp.val_feats)
        np.testing.assert_array_equal(pexp.val_labels, jexp.val_labels)
        assert len(pexp.val_extra) == len(jexp.val_extra) == 2
        for got, want in zip(pexp.val_extra, jexp.val_extra):
            np.testing.assert_array_equal(got, want)
        batches = list(zip(pexp.loader.epoch(), jexp.loader.epoch()))
        assert len(batches) == pexp.batch_per_epoch == 3
        for got, want in batches:
            assert got["num_events"] == want["num_events"]
            for key in ("events", "events2", "events3", "labels", "mask",
                        "sessions"):
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
    finally:
        jexp.close()
        pexp.close()


# ---------------------------------------------------------------------------
# the hard + structure miners
# ---------------------------------------------------------------------------

def jax_structure_draws(key):
    """A stand-in for the port's structure draw that returns the JAX
    miner's Gumbel values for ``key``: split(key, 4) into the anchor,
    hard-positive, hard-negative and far-negative keys."""
    def draw(hard_budget, struct_rows, n, generator, device):
        k_a, k_p, k_n, k_f = jax.random.split(key, 4)

        def gumbel(k, rows):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (rows, n), jnp.float32))).to(device)

        return (gumbel(k_a, hard_budget), gumbel(k_p, hard_budget),
                gumbel(k_n, hard_budget), gumbel(k_f, struct_rows))

    return draw


def _miner_inputs(seed):
    """48 rows: labels 0-9 (9 beyond the 0-7 margin classes of a
    validation set, 8 a class with one member), 5 invalid rows, a
    similarity matrix spread over [0, 1]."""
    rs = np.random.RandomState(seed)
    n = 48
    labels = rs.randint(0, 8, size=n).astype(np.int32)
    labels[labels == 7] = 6
    labels[3] = 8
    labels[10:13] = 9
    valid = np.ones(n, np.float32)
    valid[rs.choice(n, 5, replace=False)] = 0.0
    sim = rs.rand(n, n).astype(np.float32)
    sim = 0.5 * (sim + sim.T)
    margins = np.concatenate([rs.rand(8), np.zeros(2)]).astype(np.float32)
    return labels, valid, sim, margins


@pytest.mark.parametrize("rowwise", [False, True], ids=["matrix", "rowwise"])
@pytest.mark.parametrize("seed", [0, 1])
def test_structure_miner_matches_jax(monkeypatch, rowwise, seed):
    """Fed the JAX Gumbel draws, the port's miner (matrix or row-wise)
    picks the JAX miner's hard and structure triplets, index-equal, with
    equal masks and margins; the row-wise miner equals the port's matrix
    miner.  The cases cover invalid rows, a class with one member, labels
    beyond the validation classes (margin 0), and structure triplets that
    fire."""
    labels, valid, sim, margins = _miner_inputs(seed)
    key = jax.random.PRNGKey(seed + 7)
    want = (jax_mining.mine_hard_structure_triplets_rowwise(
        lambda rows: jnp.asarray(sim)[rows], jnp.asarray(labels),
        jnp.asarray(margins), key, 24, 12, valid=jnp.asarray(valid))
        if rowwise else jax_mining.mine_hard_structure_triplets(
            jnp.asarray(sim), jnp.asarray(labels), jnp.asarray(margins),
            key, 24, 12, valid=jnp.asarray(valid)))
    monkeypatch.setattr(mining, "_draw_structure_gumbels",
                        jax_structure_draws(key))
    t_sim, t_lab, t_marg, t_valid = (torch.from_numpy(a) for a in
                                     (sim, labels, margins, valid))
    matrix = mining.mine_hard_structure_triplets(
        t_sim, t_lab, t_marg, None, 24, 12, valid=t_valid)
    got = (mining.mine_hard_structure_triplets_rowwise(
        lambda rows: t_sim[rows], t_lab, t_marg, None, 24, 12,
        valid=t_valid) if rowwise else matrix)
    for field in ("hard", "hard_mask", "struct", "struct_mask", "margins"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
        assert torch.equal(getattr(got, field), getattr(matrix, field))
    assert 0 < float(got.struct_mask.sum()) < 12
    assert 0 < float(got.hard_mask.sum())


def test_structure_miner_reads_nothing_back(monkeypatch):
    """The miner asks for no data-sized result (``torch.unique``,
    ``nonzero`` and their kin raise here), so on the card it queues
    without waiting for the device."""
    def boom(*a, **k):
        raise AssertionError("a data-sized result in the miner")

    for name in ("unique", "unique_consecutive", "nonzero", "masked_select",
                 "argwhere"):
        monkeypatch.setattr(torch, name, boom)
    monkeypatch.setattr(torch.Tensor, "nonzero", boom)
    monkeypatch.setattr(torch.Tensor, "tolist", boom)
    monkeypatch.setattr(torch.Tensor, "item", boom)
    labels, valid, sim, margins = _miner_inputs(0)
    out = mining.mine_hard_structure_triplets(
        torch.from_numpy(sim), torch.from_numpy(labels),
        torch.from_numpy(margins), torch.Generator().manual_seed(0), 24, 12,
        valid=torch.from_numpy(valid))
    assert out.hard.shape == (24, 3) and out.struct.shape == (12, 3)


# ---------------------------------------------------------------------------
# the host selectors
# ---------------------------------------------------------------------------

def _selector_inputs(seed):
    rs = np.random.RandomState(seed)
    n = 40
    labels = rs.randint(0, 5, size=n).astype(np.int32)
    sim = rs.rand(n, n).astype(np.float32)
    sim = 0.5 * (sim + sim.T)
    np.fill_diagonal(sim, np.nan)
    idx, _ = jax_mining.select_triplets_facenet(
        labels, rs.rand(n, n), 12, 0.2, 3, rng=random.Random(seed))
    dist_dict = {c: [float(c) + 0.5, float(c) + 0.25] for c in range(5)}
    return labels, sim, idx, dist_dict


SELECTORS = {
    "mul": lambda m, lab, sim, idx, dd, rng: m.select_triplets_mul(
        list(idx), lab, sim, dd, 12, 3, 0.8, 0.2, rng=rng),
    "mul_hard": lambda m, lab, sim, idx, dd, rng: m.select_triplets_mul_hard(
        list(idx), lab.reshape(-1, 1), sim, 12, 3, 0.8, 0.2, rng=rng),
    "confidence": lambda m, lab, sim, idx, dd, rng:
        m.select_triplets_multimodal(sim, 0.9, 30, rng=rng),
    "random": lambda m, lab, sim, idx, dd, rng:
        m.random_triplets_multimodal(sim, 30, rng=rng),
    "nopos": lambda m, lab, sim, idx, dd, rng:
        m.nopos_triplets_multimodal(sim, 30, rng=rng),
}


@pytest.mark.parametrize("name", list(SELECTORS))
@pytest.mark.parametrize("seed", [0, 3])
def test_host_selectors_match_jax(name, seed):
    """Each host selector gives the JAX package's indices, margins and
    counts for the same ``RandomState``, and leaves it in the same
    state."""
    labels, sim, idx, dist_dict = _selector_inputs(seed)
    port_mod = (multimodal_model if name.startswith("mul")
                else multimodal_model_weak)
    jax_mod = jax_mm if name.startswith("mul") else jax_weak
    p_rng, j_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = SELECTORS[name](port_mod, labels, sim, idx, dist_dict, p_rng)
    want = SELECTORS[name](jax_mod, labels, sim, idx, dist_dict, j_rng)
    assert repr(got) == repr(want)
    assert p_rng.randint(1 << 30) == j_rng.randint(1 << 30)
    assert len(got[0]) > (len(idx) if name.startswith("mul") else 0)


def test_dist_dict_and_padding_match_jax():
    """``init_dist_dict`` within rtol 1e-5 of the JAX one (f32 means of
    exact differences, classes 0..max with an empty one at 0.0), and
    ``_pad_triplets`` equal, over- and under-full."""
    rs = np.random.RandomState(0)
    emb = rs.randn(30, 16).astype(np.float32)
    labels = rs.choice([0, 1, 2, 4], size=30)
    for metric in ("squaredeuclidean", "euclidean"):
        got = multimodal_model.init_dist_dict(torch.from_numpy(emb),
                                              labels, metric)
        want = jax_mm.init_dist_dict(emb, labels, metric)
        assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4]
        assert got[3] == want[3] == [0.0]
        for c in want:
            np.testing.assert_allclose(got[c], want[c], rtol=1e-5)
    idx = list(rs.randint(0, 40, size=3 * 17))
    margins = list(rs.rand(5))
    for counts, cap in (((8, 4, 5), 24), ((8, 4, 5), 12), ((3, 0, 0), 24)):
        for g, w in zip(multimodal_model._pad_triplets(idx, margins, counts,
                                                       cap),
                        jax_mm._pad_triplets(idx, margins, counts, cap)):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# one epoch of each trainer
# ---------------------------------------------------------------------------

def jax_flagship_draws(seed: int, init_splits: int):
    """Stand-ins for the port's two Gumbel draws that replay the JAX
    flagship's key sequence: PRNGKey(seed), ``init_splits`` splits for the
    initial variables, then one split a step, the step key split into
    (k_mine, k_mul, k_drop); the semi-hard draw (first in a step) takes
    split(k_mine, 3), the structure draw split(k_mul, 4)."""
    state = {"rng": jax.random.PRNGKey(seed)}
    for _ in range(init_splits):
        state["rng"], _ = jax.random.split(state["rng"])

    def gumbel(k, shape, device):
        return torch.from_numpy(np.array(jax.random.gumbel(
            k, shape, jnp.float32))).to(device)

    def semihard(num_pairs, n, num_negative, generator, device):
        state["rng"], key = jax.random.split(state["rng"])
        state["k_mine"], state["k_mul"], _ = jax.random.split(key, 3)
        k_a, k_p, k_n = jax.random.split(state["k_mine"], 3)
        return gumbel(k_a, (num_pairs, n), device), gumbel(
            k_p, (num_pairs, n), device), [
            gumbel(k, (num_pairs, n), device)
            for k in jax.random.split(k_n, num_negative)]

    def structure(hard_budget, struct_rows, n, generator, device):
        return jax_structure_draws(state["k_mul"])(
            hard_budget, struct_rows, n, generator, device)

    return semihard, structure


def _jax_params(jcfg, keys, branches):
    """The JAX trainers' initial variables from ``keys`` (core, then each
    branch's encoder and PDDM), PDDM output layers scaled and shifted."""
    keys = iter(keys)
    core = jax_build(jcfg.network, num_seg=jcfg.num_seg,
                     emb_dim=jcfg.emb_dim, n_input=jcfg.n_input,
                     n_h=jcfg.n_h, n_w=jcfg.n_w, n_C=jcfg.n_C)
    params = {"modality_core": core.init(
        next(keys), jnp.zeros((2, jcfg.num_seg) + DIMS["resnet"]))["params"]}
    e32 = jnp.zeros((2, 32), jnp.float32)
    for name in branches:
        enc = JaxRTSN(n_seg=jcfg.num_seg, emb_dim=32,
                      n_input=DIMS[name][0]).init(
            next(keys), jnp.zeros((2, jcfg.num_seg) + DIMS[name]))["params"]
        pddm = jax.tree.map(np.asarray, JaxPDDM(n_input=32).init(
            next(keys), e32, e32, method="score")["params"])
        pddm["score"]["s"]["kernel"] = (pddm["score"]["s"]["kernel"]
                                        * PDDM_SCALE)
        pddm["score"]["s"]["bias"] = (pddm["score"]["s"]["bias"]
                                      + np.float32([0.0, PDDM_SHIFT]))
        params[f"modality_{name}"] = {"encoder": enc, "pddm": pddm}
    return jax.tree.map(np.asarray, params)


def _port_model(pcfg, params, branches):
    model = multimodal_model.build_model(
        pcfg, torch.device("cpu"), **{b: DIMS[b][0] for b in branches})
    return load_flax_params(model, params)


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_frozen(model, before, frozen, changed):
    """Parameters under ``frozen`` scopes kept their values; those under
    ``changed`` moved."""
    after = model.state_dict()
    for scope in frozen:
        for k in before:
            if k.startswith(scope + "."):
                assert torch.equal(after[k], before[k]), k
    for scope in changed:
        assert any(not torch.equal(after[k], before[k]) for k in before
                   if k.startswith(scope + ".")), scope


MM_CASES = {
    # name: (JAX train, port train, extra config, device_mining, pinned)
    "host": (jax_mm.train, multimodal_model.train,
             dict(no_joint=True), False, False),
    "device-f32": (jax_mm.train, multimodal_model.train, {}, True, False),
    "device-int8": (jax_mm.train, multimodal_model.train,
                    dict(int8_features=True, no_joint=True), True, True),
    "hardonly": (jax_hardonly.train, multimodal_model_hardonly.train, {},
                 False, False),
}


@pytest.mark.parametrize("case", list(MM_CASES))
def test_one_epoch_matches_jax_trainer(tmp_path, monkeypatch, case):
    """One epoch of the flagship on the host miners, under
    --device_mining (f32, and int8 with the JAX dequantization pinned to
    its stated bf16 rounding, ROADMAP D1) and of the hard-only ablation,
    against the JAX trainers from the same initial variables (carried in
    through --model_path): the loss trace within rtol 1e-4, the triplet,
    hard and structure counts of every step equal, val mAP within atol
    1e-3; the device miners draw the JAX trainer's Gumbel values, the host
    miners the same seeded streams.  Afterwards the frozen scopes kept
    their values (both branches, with and without --no_joint: the PDDM
    heads take no gradient on this trainer) and the core moved."""
    jtrain, ptrain, extra, device_mining, pinned = MM_CASES[case]
    kw = dict(MM, **CONV, **extra, DATA_ROOT=_data(tmp_path),
              feat="resnet,sensors,segment")
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    branches = ("sensors", "segment")
    rng = jax.random.PRNGKey(jcfg.seed)
    keys = []
    for _ in range(5):
        rng, k = jax.random.split(rng)
        keys.append(k)
    params = _jax_params(jcfg, keys, branches)
    frozen = BRANCHES if jcfg.no_joint else tuple(
        f"{b}/encoder" for b in BRANCHES)
    jcfg.model_path = str(tmp_path / "init.msgpack")
    save_pytree(jcfg.model_path, TrainState.create(
        jax.tree.map(jnp.asarray, params), jax_build_optimizer(
            jcfg.optimizer, jcfg.learning_rate, frozen_scopes=frozen)))
    model = _port_model(pcfg, params, branches)
    before = _snapshot(model)
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    semihard, structure = jax_flagship_draws(jcfg.seed, 5)
    monkeypatch.setattr(mining, "_draw_gumbels", semihard)
    monkeypatch.setattr(mining, "_draw_structure_gumbels", structure)
    if pinned:
        monkeypatch.setattr(jax_steps, "dequant_features", rounded_dequant)
    _, _, jax_dir = jtrain(jcfg, device_mining=device_mining,
                           event_budget=BUDGET,
                           result_dir=str(tmp_path / "jax"))
    res = ptrain(pcfg, device_mining=device_mining, event_budget=BUDGET,
                 result_dir=str(tmp_path / "port"), device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)

    got_loss, want_loss = _column(got, "loss"), _column(want, "loss")
    assert res.step == len(want_loss) == 3
    assert all(np.isfinite(got_loss))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    for key in ("triplet_count", "hard_count", "struct_count"):
        assert _column(got, key) == _column(want, key), key
    assert sum(_column(got, "hard_count")) > 0
    if case != "hardonly":
        assert sum(_column(got, "struct_count")) > 0
    for key in ("metric_loss2", "metric_loss3"):
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert len(_column(got, "val_mAP")) == 1
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)
    _assert_frozen(res.model, before, BRANCHES, ("modality_core",))
    scales = {name: g["grad_scale"] for g in res.optimizer.param_groups
              for name, p in res.model.named_parameters()
              if any(p is q for q in g["params"])}
    for name, scale in scales.items():
        want_scale = (1.0 if name.startswith("modality_core") else
                      0.0 if jcfg.no_joint or ".encoder." in name else 0.1)
        assert scale == want_scale, name


@pytest.mark.parametrize("no_joint,select", [(False, "confidence"),
                                             (True, "random")])
def test_weak_one_epoch_matches_jax_trainer(tmp_path, no_joint, select):
    """One epoch of ``multimodal_model_weak`` against the JAX trainer: its
    initial variables (PRNGKey(seed), three splits) carried into the port
    through --model_path (the JAX trainer has none), the sensors branch
    restored from a checkpoint of each package's own format
    (--sensors_path), two labeled sessions of three: the loss trace within
    rtol 1e-4, the step of each record equal, val mAP within atol 1e-3.
    With --no_joint the sensors branch kept its values; without it, the
    weighted loss moved it."""
    kw = dict(MM, **CONV, DATA_ROOT=_data(tmp_path, ("resnet", "sensors")),
              feat="resnet,sensors", label_num=2, no_joint=no_joint,
              multimodal_select=select)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    rng = jax.random.PRNGKey(jcfg.seed)
    keys = []
    for _ in range(3):
        rng, k = jax.random.split(rng)
        keys.append(k)
    # the state after the JAX trainer's restore of the branch checkpoint:
    # its core init, and the branch as saved (the encoder of its init, the
    # PDDM head scaled)
    params = _jax_params(jcfg, keys, ("sensors",))
    jcfg.sensors_path = str(tmp_path / "sensors.msgpack")
    save_pytree(jcfg.sensors_path, {"params": params["modality_sensors"]})
    model = _port_model(pcfg, params, ("sensors",))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)
    saved = model["modality_sensors"]
    pcfg.sensors_path = str(tmp_path / "sensors.pt")
    save_checkpoint(pcfg.sensors_path, saved, None, 0)
    before = _snapshot(saved)

    _, _, jax_dir = jax_weak.train(jcfg, event_budget=BUDGET,
                                   result_dir=str(tmp_path / "jax"))
    res = multimodal_model_weak.train(pcfg, event_budget=BUDGET,
                                      result_dir=str(tmp_path / "port"),
                                      device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    got_loss, want_loss = _column(got, "loss"), _column(want, "loss")
    assert len(want_loss) >= 3 and res.step > len(want_loss)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)
    sensors = res.model["modality_sensors"]
    after = sensors.state_dict()
    moved = [k for k in before if not torch.equal(after[k], before[k])]
    assert (not moved) if no_joint else moved


@pytest.mark.parametrize("full", [True, False], ids=["full", "encoder-only"])
def test_branch_restore_matches_jax_graft(tmp_path, full):
    """Restoring a port ``pddm_model`` checkpoint (groups ``encoder`` and
    ``pddm``, or the encoder alone) into a branch gives the JAX
    ``_graft`` of the same params: keys in both are copied, the template
    keeps the rest."""
    jcfg = _cfg(JaxTrainConfig, **CONV)
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    template = _jax_params(jcfg, keys[:3], ("sensors",))["modality_sensors"]
    source = _jax_params(jcfg, keys[3:], ("sensors",))["modality_sensors"]
    ckpt = source if full else {"encoder": source["encoder"]}
    want = jax_mm._graft(template, ckpt)

    def port_branch(tree):
        branch = torch.nn.ModuleDict({"encoder": RTSN(3, 32, 8),
                                      "pddm": PDDM(32)})
        return load_flax_params(branch, tree)

    saved = (port_branch(source) if full
             else torch.nn.ModuleDict({"encoder": port_branch(
                 source)["encoder"]}))
    path = str(tmp_path / "pddm.ckpt-3")
    save_checkpoint(path, saved, None, 3)
    got = port_branch(template)
    multimodal_model.restore_branch(got, path)
    for k, v in port_branch(want).state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# CLIs and options
# ---------------------------------------------------------------------------

CLIS = {
    "multimodal_model": ["--feat", "resnet,sensors,segment"],
    "multimodal_model-device_mining": ["--feat", "resnet,sensors,segment",
                                       "--device_mining"],
    "multimodal_model_hardonly": ["--feat", "resnet,sensors,segment"],
    "multimodal_model_weak": ["--feat", "resnet,sensors", "--label_num",
                              "2"],
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs_on_cpu(tmp_path, name):
    """``python -m ...<trainer> --device cpu`` trains an epoch and logs
    finite losses, a val mAP and a checkpoint."""
    args = ["--device", "cpu", "--DATA_ROOT", _data(tmp_path), "--name",
            "cli", "--event_per_batch", str(BUDGET), "--sess_per_batch",
            "1", "--max_epochs", "1", "--triplet_per_batch", "12",
            "--lambda_multimodal", "0.1", "--silent_mode", *CLIS[name]]
    for key, value in CONV.items():
        args += [f"--{key}", str(value)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    module = name.split("-")[0]
    subprocess.run([sys.executable, "-m",
                    f"multimodal_similarity_tpu_torch.train.trainers.{module}",
                    *args], check=True, env=env, cwd=str(tmp_path),
                   timeout=300)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    recs = _records(str(run_dir))
    losses = _column(recs, "loss")
    assert losses and all(np.isfinite(losses))
    assert len(_column(recs, "val_mAP")) == 1
    assert any(n.startswith("cli.ckpt-") for n in os.listdir(run_dir))


def test_options_and_missing_gpu_raise(tmp_path, monkeypatch):
    """On the flagship: --multihost without --device_mining raises JAX's
    NotImplementedError, and with it but no process group JAX's
    RuntimeError; --model_parallel 2 raises JAX's ValueErrors (without
    --device_mining: it requires it; with it and no process group: the
    model axis does not divide the one visible device).  --multihost
    raises D6's ValueError on the weak trainer (no multi-process path in
    JAX);
    --device_cache without --device_mining, or with --bf16_features, and
    --int8_features without --device_mining raise ValueError on the
    flagship, --device_cache (D5) and --int8_features on the weak trainer;
    the default device raises when no card is visible."""
    root = _data(tmp_path)

    def cfg(**kw):
        return _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1,
                    feat="resnet,sensors,segment", **CONV, **kw)

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(NotImplementedError,
                       match="--multihost requires --device_mining"):
        multimodal_model.train(cfg(multihost=True), device="cpu")
    with pytest.raises(RuntimeError, match="needs >= 2 devices"):
        multimodal_model.train(cfg(multihost=True), device="cpu",
                               device_mining=True)
    for device_mining, match in (
            (False, "--model_parallel requires --device_mining"),
            (True, "--model_parallel 2 does not divide the 1 visible "
             "devices")):
        with pytest.raises(ValueError, match=match):
            multimodal_model.train(cfg(model_parallel=2), device="cpu",
                                   device_mining=device_mining)
    with pytest.raises(ValueError, match="--multihost: multimodal_model_weak "
                       "has no multi-process path"):
        multimodal_model_weak.train(cfg(multihost=True), device="cpu")
    with pytest.raises(ValueError, match="device_cache requires "
                       "--device_mining"):
        multimodal_model.train(cfg(device_cache=True, steps_per_dispatch=2),
                               device="cpu")
    with pytest.raises(ValueError, match="excludes --bf16_features"):
        multimodal_model.train(cfg(device_cache=True, bf16_features=True),
                               device="cpu", device_mining=True)
    with pytest.raises(ValueError, match="multimodal_model_weak has no "
                       "cached feed"):
        multimodal_model_weak.train(cfg(device_cache=True), device="cpu")
    with pytest.raises(ValueError, match="int8_features requires"):
        multimodal_model.train(cfg(int8_features=True), device="cpu")
    with pytest.raises(ValueError, match="int8_features is not supported"):
        multimodal_model_weak.train(cfg(int8_features=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for train in (multimodal_model.train, multimodal_model_hardonly.train,
                  multimodal_model_weak.train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg())
