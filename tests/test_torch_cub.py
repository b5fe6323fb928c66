"""The port's CUB track against the JAX package on the same numpy inputs:
the data module, CUBLayer, PDDM, ``masked_self_distance``, the semi-hard
triplet, n-pairs and cluster losses, and the trainers ``base_model_CUB``,
``pddm_CUB``, ``base_CUB`` (ConvBackbone) and ``debug_CUB`` over a short
run from the same initial params (carried by convert.py) with dropout off,
and their CLIs.  Tolerances at each assertion."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_base_model import jax_gumbel_draws

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import cub as jax_cub
from multimodal_similarity_tpu.models import (
    CUBLayer as JaxCUBLayer, PDDM as JaxPDDM, OutputLayer as JaxOutputLayer)
from multimodal_similarity_tpu.ops import losses as jl
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu.train.trainers import (
    base_CUB as jax_base_CUB, base_model_CUB as jax_base_model_CUB,
    debug_CUB as jax_debug_CUB, pddm_CUB as jax_pddm_CUB)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.data import cub
from multimodal_similarity_tpu_torch.models import PDDM, CUBLayer
from multimodal_similarity_tpu_torch.ops import losses as tl
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.steps import masked_self_distance
from multimodal_similarity_tpu_torch.train.trainers import (
    base_CUB, base_model_CUB, debug_CUB, pddm_CUB)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_classes,per_class,batch", [
    (10, 12, 64), (3, 7, 40), (100, 59, 64)])
def test_sample_cub_batch_is_index_equal(n_classes, per_class, batch):
    """The same RandomState seed gives the same batch indices, draw after
    draw, including the re-sampling of a class set smaller than a
    batch."""
    labels = np.repeat(np.arange(n_classes), per_class)
    classes = {}
    for i, label in enumerate(labels):
        classes.setdefault(int(label), []).append(i)
    got_rng, want_rng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(4):
        got = cub.sample_cub_batch(classes, batch, got_rng)
        want = jax_cub.sample_cub_batch(classes, batch, want_rng)
        assert len(got) == batch
        np.testing.assert_array_equal(got, want)


def test_synthetic_and_load_cub_are_the_same_arrays(tmp_path):
    """``generate_synthetic_cub`` writes the same files from the same seed,
    and ``load_cub`` reads them the same way: train labels 0-based, test
    labels left 1-based."""
    kw = dict(n_classes=6, per_class=5, feat_dim=16, att_dim=8, seed=3)
    got = cub.generate_synthetic_cub(str(tmp_path / "port"), **kw)
    want = jax_cub.generate_synthetic_cub(str(tmp_path / "jax"), **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    for attributes in (False, True):
        got = cub.load_cub(str(tmp_path / "jax"), attributes=attributes)
        want = jax_cub.load_cub(str(tmp_path / "jax"), attributes=attributes)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["label_train"].min() == 0 and got["label_test"].min() == 1


def test_prepare_attribute_is_the_same_array(tmp_path):
    """Certainty-weighted attributes from an image_attribute_labels file,
    short lines and absent attributes included."""
    rng = np.random.RandomState(0)
    path = tmp_path / "image_attribute_labels.txt"
    lines = ["7 3"]
    for img in range(1, 9):
        for att in range(1, 13):
            lines.append(f"{img} {att} {rng.randint(0, 2)} "
                         f"{rng.randint(1, 6)} 0.0")
    path.write_text("\n".join(lines) + "\n")
    got = cub.prepare_attribute(str(path), 8, 12)
    want = jax_cub.prepare_attribute(str(path), 8, 12)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.any()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_cub_layer_matches_flax(rng):
    """CUBLayer (eval mode) from mapped params, atol 1e-6."""
    x = rng.randn(9, 24).astype(np.float32)
    jm = JaxCUBLayer(n_output=7)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = load_flax_params(CUBLayer(24, 7), _np(params)).eval()
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))), atol=1e-6)


def test_pddm_score_matches_flax(rng):
    """PDDM's ``score`` and its [B, 2, d] call, logits and probabilities,
    atol 1e-6; a self-pair's near-zero u branch stays near zero (the eps
    floor on the squared sum)."""
    a = rng.randn(11, 16).astype(np.float32)
    b = rng.randn(11, 16).astype(np.float32)
    b[0] = a[0]                                    # a self-pair
    jm = JaxPDDM(n_input=16)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(a), jnp.asarray(b),
                     method="score")["params"]
    params = jax.tree.map(lambda p: p + 0.05, params)  # nonzero biases
    tm = load_flax_params(PDDM(16), _np(params))
    want = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b),
                    method="score")
    got = tm.score(torch.from_numpy(a), torch.from_numpy(b))
    pairs = np.stack([a, b], axis=1)
    got_pairs = tm(torch.from_numpy(pairs))
    want_pairs = jm.apply({"params": params}, jnp.asarray(pairs))
    for g, w in zip(got + got_pairs, want + want_pairs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6)


@pytest.mark.parametrize("metric", ["squaredeuclidean", "euclidean", "l1"])
def test_masked_self_distance_matches_jax(rng, metric):
    """Zero diagonal, padding rows and columns at +1e30: atol 1e-6 (rtol
    1e-6 for the padded entries)."""
    emb = rng.randn(13, 6).astype(np.float32)
    mask = (rng.rand(13) > 0.3).astype(np.float32)
    got = masked_self_distance(torch.from_numpy(emb), torch.from_numpy(mask),
                               metric).numpy()
    want = np.asarray(jax_steps.masked_self_distance(
        jnp.asarray(emb), jnp.asarray(mask), metric))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(np.diag(got)[mask > 0] == 0.0)


# ---------------------------------------------------------------------------
# losses: values and gradients
# ---------------------------------------------------------------------------

def _clusters(rng, n=40, n_classes=5, d=8, spread=1.0):
    labels = rng.randint(0, n_classes, size=n)
    centers = rng.randn(n_classes, d) * 0.7
    emb = centers[labels] + spread * rng.randn(n, d)
    return emb.astype(np.float32), labels


def _value_and_grad(port_fn, jax_fn, emb, *args):
    """(port loss, port grad, JAX loss, JAX grad) of a loss of embeddings."""
    x = _t(emb, grad=True)
    got = port_fn(x, *args)
    got.backward()
    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(emb), *args)
    return float(got.detach()), x.grad.numpy(), float(want), np.asarray(
        want_g)


def _close(got, got_g, want, want_g, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_g, want_g, rtol=tol, atol=tol)


@pytest.mark.parametrize("case,margin", [
    ("clusters", 0.2), ("clusters", 5.0), ("no_outside", 0.2)])
def test_triplet_semihard_loss_matches_jax(rng, case, margin):
    """Value and gradient at 1e-5, at the scripts' margin and at one that
    makes every pair active.  ``no_outside``: row 0's positive lies beyond
    every negative, so that pair takes the furthest negative."""
    emb, labels = _clusters(rng)
    if case == "no_outside":
        emb[1] = emb[0] + 50.0                    # a far positive of row 0
        labels[1] = labels[0]
    lab = labels.astype(np.int32)
    got, got_g, want, want_g = _value_and_grad(
        lambda x: tl.triplet_semihard_loss(torch.from_numpy(lab), x, margin),
        lambda x: jl.triplet_semihard_loss(jnp.asarray(lab), x, margin), emb)
    _close(got, got_g, want, want_g)
    assert got > 0


def test_npairs_loss_matches_jax(rng):
    """Value and gradients (anchors and positives) at 1e-5, with repeated
    labels."""
    a = rng.randn(16, 8).astype(np.float32)
    p = rng.randn(16, 8).astype(np.float32)
    labels = rng.randint(0, 6, size=16)
    ta, tp = _t(a, True), _t(p, True)
    got = tl.npairs_loss(torch.from_numpy(labels), ta, tp)
    got.backward()
    want, (ga, gp) = jax.value_and_grad(
        lambda x, y: jl.npairs_loss(jnp.asarray(labels), x, y),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(p))
    _close(float(got.detach()), ta.grad.numpy(), float(want),
           np.asarray(ga))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5,
                               atol=1e-5)


def test_normalized_mutual_information_matches_jax(rng):
    for a, b in ((rng.randint(0, 5, 30), rng.randint(0, 4, 30)),
                 (np.zeros(10, int), np.zeros(10, int)),
                 (np.zeros(10, int), np.arange(10))):
        got = float(tl.normalized_mutual_information(
            torch.from_numpy(a), torch.from_numpy(b), 30))
        want = float(jl.normalized_mutual_information(
            jnp.asarray(a), jnp.asarray(b), 30))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pam", [True, False])
@pytest.mark.parametrize("mm", [1.0, 0.0])
def test_cluster_loss_matches_jax(rng, pam, mm):
    """Value and gradient at 1e-5 at batch 24, with and without the PAM
    sweep and the NMI margin."""
    emb, labels = _clusters(rng, n=24, n_classes=4, spread=0.8)
    got, got_g, want, want_g = _value_and_grad(
        lambda x: tl.cluster_loss(torch.from_numpy(labels), x, mm, pam),
        lambda x: jl.cluster_loss(jnp.asarray(labels), x, mm, pam), emb)
    _close(got, got_g, want, want_g)


@pytest.mark.parametrize("mm", [0.0, 1.0])
def test_cluster_loss_ties_resolve_to_the_same_index(rng, mm):
    """Duplicated rows tie exactly in the facility choice: both sides take
    the lowest index, which shows in the gradient (the distance to the
    chosen duplicate is what takes it), at 1e-5."""
    base, labels = _clusters(rng, n=8, n_classes=3, spread=0.5)
    emb = np.concatenate([base, base])            # rows i and i + 8 tie
    lab = np.concatenate([labels, labels])
    got, got_g, want, want_g = _value_and_grad(
        lambda x: tl.cluster_loss(torch.from_numpy(lab), x, mm),
        lambda x: jl.cluster_loss(jnp.asarray(lab), x, mm), emb)
    _close(got, got_g, want, want_g)
    assert np.abs(got_g[:8] - got_g[8:]).max() > 1e-4  # the tie shows


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def _cfgs(tmp_path, **kw):
    d = dict(name="t", silent_mode=True, emb_dim=16, learning_rate=1e-3,
             keep_prob=1.0, DATA_ROOT=str(tmp_path / "data"), **kw)
    return JaxTrainConfig(**d).resolve(), TrainConfig(**d).resolve()


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    vals = [(r["val_mAP"], r["val_recall@1"]) for r in recs
            if "val_mAP" in r]
    return losses, vals


def _port_init(tmp_path, model, params, batch_stats=None):
    """A port checkpoint at step 0 holding the JAX initial params."""
    load_flax_params(model, _np(params), batch_stats and _np(batch_stats))
    path = str(tmp_path / "init.pt")
    save_checkpoint(path, model, build_optimizer("ADAM", model, 1e-3), 0)
    return path


def _same_run(got_dir, want_dir, steps):
    (got_loss, got_val), (want_loss, want_val) = (_records(got_dir),
                                                  _records(want_dir))
    assert len(got_loss) == len(want_loss) == steps
    assert all(np.isfinite(got_loss)) and any(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert len(got_val) == len(want_val) >= 1
    np.testing.assert_allclose(got_val, want_val, atol=1e-3)


@pytest.fixture
def cub_features(tmp_path):
    return jax_cub.generate_synthetic_cub(
        str(tmp_path / "data"), n_classes=10, per_class=12, feat_dim=48,
        att_dim=20, seed=0)


def test_base_model_cub_matches_jax_trainer(tmp_path, monkeypatch,
                                            cub_features):
    """10 steps from the JAX initial params, the miner fed the JAX
    trainer's Gumbel draws: the loss trace at rtol 1e-4, val mAP and
    recall@1 at every validation at atol 1e-3."""
    jcfg, pcfg = _cfgs(tmp_path, max_epochs=10, triplet_per_batch=30,
                       batch_size=64)
    params = JaxCUBLayer(n_output=16).init(
        jax.random.PRNGKey(jcfg.seed),
        jnp.asarray(cub_features["feat_train"][:2]))["params"]
    pcfg.model_path = _port_init(tmp_path, CUBLayer(48, 16), params)
    monkeypatch.setattr(mining, "_draw_gumbels", jax_gumbel_draws(
        pcfg.seed))
    _, _, want_dir = jax_base_model_CUB.train(
        jcfg, data=cub_features, result_dir=str(tmp_path / "jax"))
    res = base_model_CUB.train(pcfg, data=cub_features,
                               result_dir=str(tmp_path / "port"),
                               device="cpu")
    assert res.step == 10 and set(res.metrics) == {
        "val_mAP", "val_recall@1", "val_recall@2", "val_recall@4",
        "val_recall@8"}
    _same_run(res.result_dir, want_dir, 10)
    assert any(n.startswith("t.ckpt-") for n in os.listdir(res.result_dir))


def test_pddm_cub_matches_jax_trainer(tmp_path, monkeypatch, cub_features):
    """10 steps of the PDDM trainer from the JAX initial params (both
    groups), the miner fed the JAX Gumbel draws: loss trace rtol 1e-4, val
    mAP and recall@1 atol 1e-3."""
    jcfg, pcfg = _cfgs(tmp_path, max_epochs=10, triplet_per_batch=30)
    a0 = jnp.asarray(cub_features["att_train"][:2])
    e0 = jnp.zeros((2, 16), jnp.float32)
    params = {
        "encoder": JaxOutputLayer(n_output=16).init(
            jax.random.PRNGKey(jcfg.seed), a0)["params"],
        "pddm": JaxPDDM(n_input=16).init(
            jax.random.PRNGKey(jcfg.seed + 1), e0, e0,
            method="score")["params"]}
    pcfg.model_path = _port_init(tmp_path, pddm_CUB.PDDMModel(20, pcfg),
                                 params)
    monkeypatch.setattr(mining, "_draw_gumbels", jax_gumbel_draws(
        pcfg.seed))
    _, _, want_dir = jax_pddm_CUB.train(jcfg, data=cub_features,
                                        result_dir=str(tmp_path / "jax"))
    res = pddm_CUB.train(pcfg, data=cub_features,
                         result_dir=str(tmp_path / "port"), device="cpu")
    assert res.step == 10
    _same_run(res.result_dir, want_dir, 10)
    recs = [json.loads(line) for line in
            open(os.path.join(res.result_dir, "metrics.jsonl"))]
    assert any(r.get("pddm_loss", 0) > 0 for r in recs)


def _images(rng, n_classes=8, per_class=6, size=16, n_test=16):
    """Class-tinted images in [0, 1]; train labels 0-based, test labels
    1-based, as the on-disk contract gives them."""
    tint = rng.rand(n_classes, 1, 1, 3)
    lab = np.repeat(np.arange(n_classes), per_class)
    img = np.clip(tint[lab] + 0.3 * rng.rand(len(lab), size, size, 3), 0, 1)
    lab_te = np.repeat(np.arange(1, n_test // 4 + 1), 4)
    img_te = np.clip(tint[lab_te - 1]
                     + 0.3 * rng.rand(n_test, size, size, 3), 0, 1)
    return {"image_train": img.astype(np.float32), "label_train": lab,
            "image_test": img_te.astype(np.float32), "label_test": lab_te}


def _conv_backbone_init(seed, data, crop):
    """The JAX trainer's initial params for the ConvBackbone network."""
    key = jax.random.PRNGKey(seed)
    x0 = jnp.asarray(data["image_train"][:2, :crop, :crop])
    return {"InceptionV2": jax_base_CUB.ConvBackbone().init(key,
                                                            x0)["params"],
            "CUBLayer": JaxCUBLayer(n_output=16).init(
                key, jnp.zeros((2, 1024)))["params"]}


@pytest.mark.parametrize("loss", ["triplet", "mylifted", "lifted",
                                  "batchhard"])
def test_base_cub_conv_backbone_matches_jax_trainer(tmp_path, monkeypatch,
                                                    rng, loss):
    """5 steps of the end-to-end trainer with the ConvBackbone on images as
    large as the crop (every random offset is 0 on both sides): loss trace
    rtol 1e-4, val mAP and recall@1 atol 1e-3.  ``batchhard`` runs the
    fused stats' plain version on the CPU against the JAX Pallas kernel in
    interpret mode, both pinned to f32 here (bf16 is the next test)."""
    data = _images(rng)
    jcfg, pcfg = _cfgs(tmp_path, max_epochs=5, loss=loss, network="conv")
    pcfg.model_path = _port_init(
        tmp_path, base_CUB.build_model(pcfg, "cpu"),
        _conv_backbone_init(jcfg.seed, data, 16))
    if loss == "batchhard":
        real_j, real_p = jax_base_CUB.batch_hard_pallas, \
            base_CUB.batch_hard_fused
        monkeypatch.setattr(jax_base_CUB, "batch_hard_pallas",
                            lambda *a, **k: real_j(*a, precision="f32", **k))
        monkeypatch.setattr(base_CUB, "batch_hard_fused",
                            lambda *a, **k: real_p(*a, precision="f32", **k))
    _, _, want_dir = jax_base_CUB.train(jcfg, data=data, crop=16,
                                        result_dir=str(tmp_path / "jax"))
    res = base_CUB.train(pcfg, data=data, crop=16,
                         result_dir=str(tmp_path / "port"), device="cpu")
    assert res.step == 5
    _same_run(res.result_dir, want_dir, 5)


def test_base_cub_batchhard_bf16_matches_jax_trainer(tmp_path, rng):
    """``--loss batchhard`` at the trainer's default bf16: the port's plain
    stats run their epilogue in f32 where the TPU kernel runs it in bf16
    (ROADMAP §2), so the trace holds at rtol 3e-3 (8.3e-4 observed); val
    mAP and recall@1 atol 1e-3."""
    data = _images(rng)
    jcfg, pcfg = _cfgs(tmp_path, max_epochs=5, loss="batchhard",
                       network="conv")
    pcfg.model_path = _port_init(
        tmp_path, base_CUB.build_model(pcfg, "cpu"),
        _conv_backbone_init(jcfg.seed, data, 16))
    _, _, want_dir = jax_base_CUB.train(jcfg, data=data, crop=16,
                                        result_dir=str(tmp_path / "jax"))
    res = base_CUB.train(pcfg, data=data, crop=16,
                         result_dir=str(tmp_path / "port"), device="cpu")
    (got_loss, got_val), (want_loss, want_val) = (
        _records(res.result_dir), _records(want_dir))
    assert len(got_loss) == len(want_loss) == 5
    np.testing.assert_allclose(got_loss, want_loss, rtol=3e-3)
    np.testing.assert_allclose(got_val, want_val, atol=1e-3)


def test_debug_cub_takes_two_steps_as_jax(tmp_path, rng):
    """``debug_CUB`` stops after 2 steps whatever --max_epochs says, with
    the JAX harness's losses (rtol 1e-4) and validations (atol 1e-3)."""
    data = _images(rng)
    jcfg, pcfg = _cfgs(tmp_path, max_epochs=50, network="conv")
    pcfg.model_path = _port_init(
        tmp_path, base_CUB.build_model(pcfg, "cpu"),
        _conv_backbone_init(jcfg.seed, data, 16))
    _, _, want_dir = jax_debug_CUB.train(jcfg, data=data, crop=16,
                                         result_dir=str(tmp_path / "jax"))
    res = debug_CUB.train(pcfg, data=data, crop=16,
                          result_dir=str(tmp_path / "port"), device="cpu")
    assert res.step == 2
    _same_run(res.result_dir, want_dir, 2)


def test_random_crop_offsets_cover_both_ends():
    """Offsets come from [0, h - crop] inclusive on each axis, and the
    window is (x - 0.5) * 2 of the image there; the centre crop sits at
    (h - crop) // 2."""
    h, w, crop = 6, 5, 4
    img = torch.arange(64 * h * w, dtype=torch.float32).reshape(64, h, w, 1)
    gen = torch.Generator().manual_seed(0)
    out = base_CUB.random_crop(img, crop, gen) / 2.0 + 0.5
    ox = (out[:, 0, 0, 0] - img[:, 0, 0, 0]) // w
    oy = (out[:, 0, 0, 0] - img[:, 0, 0, 0]) % w
    assert set(ox.long().tolist()) == {0, 1, 2}
    assert set(oy.long().tolist()) == {0, 1}
    for i in range(64):
        a, b = int(ox[i]), int(oy[i])
        assert torch.equal(out[i], img[i, a:a + crop, b:b + crop])
    centre = base_CUB.center_crop(img, crop) / 2.0 + 0.5
    assert torch.equal(centre, img[:, 1:5, 1:5])


def test_base_cub_options_raise(tmp_path, monkeypatch):
    """A slim checkpoint that leaves a tower parameter unset raises (the
    graft's coverage check), an unknown --loss raises before any data is
    read, the tower's parameters take the 0.1x branch scale, and the
    default device raises when no card is visible."""
    _, cfg = _cfgs(tmp_path, loss="triplet", network="inception_v2")
    npz = str(tmp_path / "partial.npz")
    np.savez(npz, **{"InceptionV2/Conv2d_1a_7x7/BatchNorm/beta":
                     np.zeros(64, np.float32)})
    images = np.zeros((4, 8, 8, 3), np.float32)
    data = {"image_train": images, "label_train": np.arange(4) % 2,
            "image_test": images, "label_test": np.arange(4) % 2}
    with pytest.raises(KeyError, match="unset"):
        base_CUB.train(cfg, data=data, crop=8, slim_checkpoint=npz,
                       result_dir=str(tmp_path / "r"), device="cpu")
    _, bad = _cfgs(tmp_path, loss="npairs")
    with pytest.raises(NotImplementedError, match="npairs"):
        base_CUB.train(bad, device="cpu")
    for network in ("inception_v2", "conv"):
        _, c = _cfgs(tmp_path, network=network)
        model = base_CUB.build_model(c, "cpu")
        opt = build_optimizer("ADAM", model, 1e-3)
        scales = {id(p): g["grad_scale"] for g in opt.param_groups
                  for p in g["params"]}
        for name, p in model.named_parameters():
            assert scales[id(p)] == (0.1 if name.startswith("InceptionV2.")
                                     else 1.0), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for trainer in (base_model_CUB, pddm_CUB, base_CUB, debug_CUB):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.train(cfg)


@pytest.mark.parametrize("trainer", ["base_model_CUB", "pddm_CUB",
                                     "base_CUB", "debug_CUB"])
def test_cli_runs_on_cpu(tmp_path, rng, trainer):
    """``python -m ...<trainer> --device cpu`` on a synthetic directory:
    finite losses, a validation and a checkpoint."""
    root = tmp_path / "data"
    args = ["--device", "cpu", "--DATA_ROOT", str(root), "--name", "cli",
            "--emb_dim", "8", "--max_epochs", "3", "--triplet_per_batch",
            "12", "--network", "conv", "--silent_mode"]
    if trainer in ("base_model_CUB", "pddm_CUB"):
        jax_cub.generate_synthetic_cub(str(root), n_classes=8, per_class=10,
                                       feat_dim=32, att_dim=12, seed=1)
    else:
        root.mkdir()
        for k, v in _images(rng, size=64).items():
            np.save(root / f"{k}.npy", v)
        args += ["--crop", "56"]       # the default, 224, needs 224 pixels
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m",
                    f"multimodal_similarity_tpu_torch.train.trainers."
                    f"{trainer}", *args],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    (run_dir,) = list((root / "results").iterdir())
    losses, vals = _records(str(run_dir))
    assert len(losses) == (2 if trainer == "debug_CUB" else 3)
    assert all(np.isfinite(losses)) and vals
    assert all(np.isfinite(v).all() for v in vals)
    assert any(n.startswith("cli.ckpt-") for n in os.listdir(run_dir))


@pytest.mark.parametrize("trainer", ["base_CUB", "debug_CUB"])
def test_cli_crop_defaults_to_the_references(monkeypatch, trainer):
    """``--crop`` reaches ``train`` as given, and is the reference's 224
    when it is left out; ``--device`` beside it, the rest a
    ``TrainConfig``."""
    mod = base_CUB if trainer == "base_CUB" else debug_CUB
    seen = []
    monkeypatch.setattr(mod, "train" if trainer == "base_CUB" else "_train",
                        lambda cfg, **kw: seen.append((cfg, kw)))
    mod.main(["--network", "inception_v2", "--emb_dim", "64"])
    mod.main(["--crop", "96", "--device", "cpu", "--batch_size", "32"])
    (cfg0, kw0), (cfg1, kw1) = seen
    assert base_CUB.CROP == 224 and kw0["crop"] == 224
    assert kw0.get("device") is None
    assert cfg0.network == "inception_v2" and cfg0.emb_dim == 64
    assert kw1["crop"] == 96 and kw1["device"] == "cpu"
    assert cfg1.batch_size == 32


def test_port_modules_import_no_jax():
    """The CUB modules of the port import neither JAX nor the JAX
    package."""
    code = ("import sys\n"
            "import multimodal_similarity_tpu_torch.train.trainers."
            "base_CUB, multimodal_similarity_tpu_torch.train.trainers."
            "base_model_CUB, multimodal_similarity_tpu_torch.train."
            "trainers.pddm_CUB, multimodal_similarity_tpu_torch.train."
            "trainers.debug_CUB\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'multimodal_similarity_tpu' or "
            "m.startswith('multimodal_similarity_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
