"""The port's DCCA and classification losses, ``mean_pool_input``,
``ConvTSNClassifier``, and the ``cross_prediction`` and
``base_model_classifier`` trainers against the JAX package: the same
seeded inputs through both, flax variables converted, one epoch of each
trainer from the JAX trainer's initial draws (carried into the port
through --model_path), the CLIs and the option errors.  Tolerances at
each assertion."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trainer import _cfg

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.data import mean_pool_input as jax_mean_pool
from multimodal_similarity_tpu.models import (
    ConvTSNClassifier as JaxClassifier)
from multimodal_similarity_tpu.models import OutputLayer as JaxOutputLayer
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.ops import losses as jax_losses
from multimodal_similarity_tpu.train.trainers import (
    base_model_classifier as jax_classifier,
    cross_prediction as jax_cross)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.data import mean_pool_input
from multimodal_similarity_tpu_torch.models import ConvTSNClassifier
from multimodal_similarity_tpu_torch.ops import losses
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_classifier, cross_prediction)

CONV = dict(n_input=8, n_h=2, n_w=2, n_C=4, num_seg=3, emb_dim=16)
BUDGET = 48


# ---------------------------------------------------------------------------
# the DCCA loss
# ---------------------------------------------------------------------------

def _views(kind, seed):
    """Two views of 64 rows: ``well`` (16 and 8 columns, correlated, full
    rank) or ``rankdef`` (the second view of rank 3 in 8 columns, so its
    covariance has five eigenvalues at rcov)."""
    rs = np.random.RandomState(seed)
    x1 = rs.randn(64, 16).astype(np.float32)
    if kind == "well":
        x2 = x1[:, :8] @ rs.randn(8, 8) * 0.5 + rs.randn(64, 8)
    else:
        x2 = rs.randn(64, 3) @ rs.randn(3, 8)
    return x1, x2.astype(np.float32)


def _dcca_both(x1, x2, k, dtype):
    jv, jg = jax.value_and_grad(
        lambda a, b: jax_losses.dcca_loss(a, b, k), argnums=(0, 1))(
        jnp.asarray(x1, dtype), jnp.asarray(x2, dtype))
    t1, t2 = (torch.from_numpy(x.astype(dtype)).requires_grad_()
              for x in (x1, x2))
    v = losses.dcca_loss(t1, t2, k)
    v.backward()
    return (float(v.detach()), t1.grad.numpy(), t2.grad.numpy(),
            float(jv), np.asarray(jg[0]), np.asarray(jg[1]))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("kind", ["well", "rankdef"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dcca_loss_matches_jax(kind, k, seed):
    """``dcca_loss`` in f32 against JAX: the value within atol 5e-5 (1.3e-5
    observed), the gradient of each full-rank view within 1e-4 of its
    largest entry (5e-5 observed).  The rank-deficient view's f32 gradient
    is ill-conditioned in both packages (eigh's gradient divides by the
    gaps of the eigenvalues clustered at rcov; each package was up to 1.7x
    its largest entry off the float64 gradient on these inputs), so it is
    held finite in f32 and compared in float64: value and both gradients
    within 1e-5 relative (2e-8 / 1e-6 observed)."""
    x1, x2 = _views(kind, seed)
    v, g1, g2, jv, jg1, jg2 = _dcca_both(x1, x2, k, np.float32)
    assert abs(v - jv) <= 5e-5
    assert -min(16, 8) <= v < 0
    assert _rel(g1, jg1) <= 1e-4
    for g in (g1, g2, jg1, jg2):
        assert np.isfinite(g).all()
    if kind == "well":
        assert _rel(g2, jg2) <= 1e-4
        return
    with jax.enable_x64(True):
        v, g1, g2, jv, jg1, jg2 = _dcca_both(x1, x2, k, np.float64)
    assert jg1.dtype == np.float64
    assert abs(v - jv) <= 1e-5 * abs(jv)
    assert _rel(g1, jg1) <= 1e-5 and _rel(g2, jg2) <= 1e-5


def test_dcca_loss_drops_directions_under_the_floor():
    """Eigenvalues at or under 1e-12 get a zero inverse-square-root weight,
    with a finite gradient, as in JAX: a zero second view with rcov2 = 0
    has a zero covariance, so the loss is 0 in both."""
    x1, _ = _views("well", 0)
    x2 = np.zeros((64, 4), np.float32)
    t1 = torch.from_numpy(x1).requires_grad_()
    v = losses.dcca_loss(t1, torch.from_numpy(x2), rcov2=0.0)
    v.backward()
    jv = jax_losses.dcca_loss(jnp.asarray(x1), jnp.asarray(x2), rcov2=0.0)
    assert float(v.detach()) == float(jv) == 0.0
    assert np.isfinite(t1.grad.numpy()).all()


# ---------------------------------------------------------------------------
# classification loss, mean pooling, ConvTSNClassifier
# ---------------------------------------------------------------------------

def test_classification_loss_matches_jax():
    """Mean cross entropy and accuracy within 1e-6, the logits' gradient
    within atol 1e-7."""
    rs = np.random.RandomState(0)
    logits = rs.randn(20, 7).astype(np.float32) * 3
    labels = rs.randint(0, 7, size=20).astype(np.int32)
    t = torch.from_numpy(logits).requires_grad_()
    ce, acc = losses.classification_loss(t, torch.from_numpy(labels))
    ce.backward()
    jce, jacc = jax_losses.classification_loss(jnp.asarray(logits),
                                               jnp.asarray(labels))
    jg = jax.grad(lambda x: jax_losses.classification_loss(
        x, jnp.asarray(labels))[0])(jnp.asarray(logits))
    np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=1e-6)
    assert float(acc) == float(jacc) > 0
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("flatten", [True, False])
def test_mean_pool_input_matches_jax(flatten):
    feat = np.random.RandomState(1).randn(11, 2, 3).astype(np.float32)
    got, want = mean_pool_input(feat, flatten), jax_mean_pool(feat, flatten)
    assert got.shape == want.shape == ((1, 6) if flatten else (1, 2, 3))
    np.testing.assert_array_equal(got, want)


def test_conv_tsn_classifier_matches_flax():
    """``ConvTSNClassifier`` with the flax variables converted (``embed``,
    ``fc``, ``head``): features and logits within atol 1e-5, and the
    gradients of a loss on both within atol 1e-5; dropout off."""
    rs = np.random.RandomState(2)
    x = rs.randn(6, 3, 2, 2, 8).astype(np.float32)
    w = rs.randn(7).astype(np.float32)
    jm = JaxClassifier(n_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2, n_C=4,
                       n_output=7)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]

    def jloss(p):
        feat, logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(feat ** 2) + jnp.sum(logits * w), (feat, logits)

    (_, (jfeat, jlogits)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        params)
    model = ConvTSNClassifier(n_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2,
                              n_C=4, n_output=7)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    feat, logits = model(torch.from_numpy(x))
    ((feat ** 2).sum() + (logits * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat),
                               atol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5)
    want = jax.tree.map(np.asarray, jgrad)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    np.testing.assert_allclose(got["head.weight"], want["head"]["kernel"].T,
                               atol=1e-5)
    np.testing.assert_allclose(got["fc.weight"], want["fc"]["kernel"].T,
                               atol=1e-5)
    np.testing.assert_allclose(got["embed.conv1x1.weight"],
                               want["embed"]["conv1x1"]["kernel"].T,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the two trainers
# ---------------------------------------------------------------------------

def _data(tmp_path, modalities=("resnet",)):
    root = str(tmp_path / "data")
    dims = {"resnet": (2, 2, 8), "sensors": (8,)}
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={m: dims[m] for m in modalities},
                             seed=0, length_range=(4, 16))
    return root


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _column(recs, key):
    return [r[key] for r in recs if key in r]


def _keys(seed, count):
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(count):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return keys


def _kw(tmp_path, network, modalities, **extra):
    return dict(CONV, network=network, DATA_ROOT=_data(tmp_path, modalities),
                feat=",".join(modalities), sess_per_batch=1, max_epochs=2,
                log_flush_every=1, **extra)


def test_cross_prediction_matches_jax_trainer(tmp_path):
    """Two epochs of ``cross_prediction`` (ConvRTSN on resnet maps, the
    sensors windows mean-pooled as the target) against the JAX trainer
    from its initial draws (``encoder``, ``head``): the loss and MSE
    traces within rtol 1e-4, ``train_mse`` (the last step's) within rtol
    1e-4, a checkpoint an epoch, both parts moved."""
    kw = _kw(tmp_path, "convrtsn", ("resnet", "sensors"))
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    k_enc, k_head = _keys(jcfg.seed, 2)
    enc = jax_build("convrtsn", **CONV).init(
        k_enc, jnp.zeros((2, 3, 2, 2, 8)))["params"]
    head = JaxOutputLayer(n_output=8).init(k_head, jnp.zeros((2, 16)))[
        "params"]
    model = cross_prediction.build_model(pcfg, torch.device("cpu"), 8)
    load_flax_params(model, jax.tree.map(np.asarray,
                                         {"encoder": enc, "head": head}))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    _, jmetrics, jax_dir = jax_cross.train(jcfg, event_budget=BUDGET,
                                           result_dir=str(tmp_path / "jax"))
    res = cross_prediction.train(pcfg, event_budget=BUDGET,
                                 result_dir=str(tmp_path / "port"),
                                 device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "mse")) == 6
    for key in ("loss", "mse"):
        assert all(np.isfinite(_column(got, key)))
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(res.metrics["train_mse"],
                               jmetrics["train_mse"], rtol=1e-4)
    assert res.metrics["train_mse"] > 0
    ckpts = [n for n in os.listdir(res.result_dir) if ".ckpt-" in n]
    assert sorted(ckpts) == ["t.ckpt-3", "t.ckpt-6"]
    after = res.model.state_dict()
    for scope in ("encoder", "head"):
        assert any(not torch.equal(after[k], before[k]) for k in before
                   if k.startswith(scope + ".")), scope


def test_classifier_matches_jax_trainer(tmp_path):
    """Two epochs of ``base_model_classifier`` (ConvTSN, 7 outputs)
    against the JAX trainer from its initial draw: the loss, cross-entropy
    and accuracy traces within rtol 1e-4, each epoch's val accuracy
    equal."""
    kw = _kw(tmp_path, "convtsn", ("resnet",), label_num=3)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    (key,) = _keys(jcfg.seed, 1)
    params = JaxClassifier(n_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2,
                           n_C=4, n_output=7).init(
        key, jnp.zeros((2, 3, 2, 2, 8)))["params"]
    model = base_model_classifier.build_model(pcfg, torch.device("cpu"))
    load_flax_params(model, jax.tree.map(np.asarray, params))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    _, jmetrics, jax_dir = jax_classifier.train(
        jcfg, event_budget=BUDGET, result_dir=str(tmp_path / "jax"))
    res = base_model_classifier.train(pcfg, event_budget=BUDGET,
                                      result_dir=str(tmp_path / "port"),
                                      device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "ce")) == 6
    for key in ("loss", "ce", "accuracy"):
        assert all(np.isfinite(_column(got, key)))
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    assert _column(got, "val_accuracy") == _column(want, "val_accuracy")
    assert res.metrics["val_accuracy"] == jmetrics["val_accuracy"]


# ---------------------------------------------------------------------------
# CLIs and options
# ---------------------------------------------------------------------------

CLIS = {
    "cross_prediction": (cross_prediction, "convrtsn", ("resnet", "sensors"),
                         "train_mse"),
    "base_model_classifier": (base_model_classifier, "convtsn", ("resnet",),
                              "val_accuracy"),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs_on_cpu(tmp_path, name):
    """``main([... --device cpu])`` trains an epoch, logs finite losses and
    writes a checkpoint."""
    module, network, modalities, _ = CLIS[name]
    args = ["--device", "cpu", "--DATA_ROOT", _data(tmp_path, modalities),
            "--name", "cli", "--feat", ",".join(modalities), "--network",
            network, "--event_per_batch", str(BUDGET), "--sess_per_batch",
            "1", "--max_epochs", "1", "--silent_mode"]
    for key, value in CONV.items():
        args += [f"--{key}", str(value)]
    module.main(args)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    losses_ = _column(_records(str(run_dir)), "loss")
    assert losses_ and all(np.isfinite(losses_))
    assert any(n.startswith("cli.ckpt-") for n in os.listdir(run_dir))


@pytest.mark.parametrize("name", list(CLIS))
def test_options_and_missing_gpu_raise(tmp_path, monkeypatch, name):
    """--multihost raises D6's ValueError (the JAX trainers have no
    multi-process path) and --profile_dir writes a step-window trace;
    --device_cache raises D5's ValueError on the classifier (no cached
    feed) and the reference's on cross_prediction under --bf16_features
    (the cache stores int8); --int8_features raises ValueError, and the
    default device and ``--device cuda`` raise when no card is visible."""
    module, network, modalities, _ = CLIS[name]
    root = _data(tmp_path, modalities)

    def cfg(**kw):
        return _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1,
                    feat=",".join(modalities), **dict(CONV, network=network),
                    **kw)

    with pytest.raises(ValueError, match=f"--multihost: {name} has no "
                       "multi-process path"):
        module.train(cfg(multihost=True), device="cpu")
    prof = tmp_path / "prof"
    module.train(cfg(profile_dir=str(prof), profile_steps=1, max_epochs=1),
                 device="cpu")
    assert len(list(prof.glob("trace_steps*.pt.trace.json"))) == 1
    with pytest.raises(ValueError, match=(
            "excludes --bf16_features" if name == "cross_prediction"
            else f"{name} has no cached feed")):
        module.train(cfg(device_cache=True, steps_per_dispatch=2,
                         bf16_features=True), device="cpu")
    with pytest.raises(ValueError, match="int8_features is not supported"):
        module.train(cfg(int8_features=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.train(cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device", "cuda", "--DATA_ROOT", root, "--feat",
                     ",".join(modalities), "--sess_per_batch", "1"])
