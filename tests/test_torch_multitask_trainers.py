"""The port's multitask trainers (``multitask_dcca``,
``multitask_cross_prediction``, ``modality_hallucination`` and
``modality_hallucination_weak``) against the JAX package: one epoch of each
from the same initial variables (dropout off; the JAX trainers' own draws,
carried into the port through --model_path), the facenet triplet counts of
every step, the frozen and trained scopes, the branch restore, the CLIs
and the option errors.  Small sizes: budget 48, ConvRTSN 2 x 2 x 8 with n_C
4 and emb_dim 16.  Tolerances at each assertion."""

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
from multimodal_similarity_tpu.models import OutputLayer as JaxOutputLayer
from multimodal_similarity_tpu.models import RTSN as JaxRTSN
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.trainers import (
    modality_hallucination as jax_hal,
    modality_hallucination_weak as jax_hal_weak, multitask_dcca as jax_dcca)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.models import RTSN
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.utils.watchdog import StepWatchdog
from multimodal_similarity_tpu_torch.train.trainers import (
    modality_hallucination, modality_hallucination_weak,
    multitask_cross_prediction, multitask_dcca)
from multimodal_similarity_tpu_torch.train.trainers.multimodal_model import (
    restore_branch)

CONV = dict(network="convrtsn", n_input=8, n_h=2, n_w=2, n_C=4, num_seg=3,
            emb_dim=16)
DIMS = {"resnet": (2, 2, 8), "sensors": (8,), "segment": (12,)}
BUDGET = 48
BASE = dict(triplet_per_batch=24, num_negative=3, lambda_multimodal=0.5,
            sess_per_batch=1, max_epochs=1, log_flush_every=1)
FEATS = "resnet,sensors,segment"
FROZEN = ("modality_sensors", "modality_segment")


def _data(tmp_path, modalities=("resnet", "sensors", "segment")):
    """5 sessions (3 train, 1 validation, 1 test) of short events (4-15
    frames) in the given modalities."""
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


def _keys(seed, count):
    """The JAX HondaExperiment's first ``count`` ``next_key()`` draws."""
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(count):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return keys


def _video(cfg, emb_dim, key):
    enc = jax_build(cfg.network, num_seg=cfg.num_seg, emb_dim=emb_dim,
                    n_input=cfg.n_input, n_h=cfg.n_h, n_w=cfg.n_w,
                    n_C=cfg.n_C)
    return enc.init(key, jnp.zeros((2, cfg.num_seg) + DIMS["resnet"]))[
        "params"]


def _rtsn(cfg, name, key):
    return JaxRTSN(n_seg=cfg.num_seg, emb_dim=32,
                   n_input=DIMS[name][0]).init(
        key, jnp.zeros((2, cfg.num_seg) + DIMS[name]))["params"]


def _head(cfg, key):
    return JaxOutputLayer(n_output=32).init(
        key, jnp.zeros((2, cfg.emb_dim)))["params"]


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _record_counts(monkeypatch, module, sink):
    """Record the triplet count of each facenet draw of ``module``."""
    real = module.select_triplets_facenet

    def wrapped(*a, **k):
        idx, active = real(*a, **k)
        sink.append(len(idx) // 3)
        return idx, active

    monkeypatch.setattr(module, "select_triplets_facenet", wrapped)


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _moved(before, after, scope):
    return any(not torch.equal(after[k], before[k]) for k in before
               if k.startswith(scope + "."))


def _unchanged(before, after, scope):
    return all(torch.equal(after[k], before[k]) for k in before
               if k.startswith(scope + "."))


# ---------------------------------------------------------------------------
# multitask_dcca and multitask_cross_prediction
# ---------------------------------------------------------------------------

MULTITASK_CASES = {
    # name: (use_mse, --multimodal_epochs, --max_epochs)
    "dcca": (False, 0, 1),
    "mse": (True, 0, 1),
    # lambda_mul is 0 in the first epoch: the heads take zero gradients,
    # and Adam steps them (its bias correction counts those steps)
    "mse-staged": (True, 1, 2),
}


@pytest.mark.parametrize("case", list(MULTITASK_CASES))
def test_multitask_one_epoch_matches_jax_trainer(tmp_path, monkeypatch,
                                                 case):
    """``multitask_dcca`` and its MSE variant against the JAX trainer from
    the same initial variables (the JAX trainer's draws: core, sensors,
    segment, and the two heads, with both towers then restored from a
    ``pddm_model``-style checkpoint of each package's format): the loss,
    metric-loss and mul-loss traces within rtol 1e-4, the facenet triplet
    counts of every step equal, val mAP within atol 1e-3.  Afterwards the
    frozen towers kept their values, the core moved, and the heads moved
    and took an Adam step at every step, also the steps before
    --multimodal_epochs, where lambda_mul is 0."""
    use_mse, mm_epochs, max_epochs = MULTITASK_CASES[case]
    kw = dict(BASE, **CONV, DATA_ROOT=_data(tmp_path), feat=FEATS,
              label_num=2, multimodal_epochs=mm_epochs,
              max_epochs=max_epochs)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    keys = _keys(jcfg.seed, 5 if use_mse else 3)
    params = {"modality_core": _video(jcfg, jcfg.emb_dim, keys[0]),
              "modality_sensors": _rtsn(jcfg, "sensors", keys[1]),
              "modality_segment": _rtsn(jcfg, "segment", keys[2])}
    if use_mse:
        params["modality_core_heads"] = {"sensors": _head(jcfg, keys[3]),
                                         "segment": _head(jcfg, keys[4])}
    # the towers as pretrained elsewhere: other draws, restored by both
    for i, (scope, name) in enumerate(zip(FROZEN, ("sensors", "segment"))):
        enc = _to_np(_rtsn(jcfg, name, jax.random.PRNGKey(100 + i)))
        params[scope] = enc
        path = str(tmp_path / f"{name}.msgpack")
        save_pytree(path, {"params": {"encoder": enc}})
        setattr(jcfg, f"{name}_path", path)
        tower = torch.nn.ModuleDict({"encoder": RTSN(3, 32, DIMS[name][0])})
        load_flax_params(tower["encoder"], enc)
        setattr(pcfg, f"{name}_path", str(tmp_path / f"{name}.pt"))
        save_checkpoint(getattr(pcfg, f"{name}_path"), tower, None, 0)
    params = _to_np(params)
    model = multitask_dcca.build_model(pcfg, torch.device("cpu"), 8, 12,
                                       use_mse)
    load_flax_params(model, params)
    before = _snapshot(model)
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    got_counts, want_counts = [], []
    _record_counts(monkeypatch, jax_dcca, want_counts)
    _record_counts(monkeypatch, multitask_dcca, got_counts)
    _, _, jax_dir = jax_dcca.train(jcfg, use_mse=use_mse,
                                   event_budget=BUDGET,
                                   result_dir=str(tmp_path / "jax"))
    port_train = (multitask_cross_prediction.train if use_mse
                  else multitask_dcca.train)
    res = port_train(pcfg, event_budget=BUDGET,
                     result_dir=str(tmp_path / "port"), device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)

    want_loss = _column(want, "loss")
    assert res.step == len(want_loss) >= 3 * max_epochs - 1
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for key in ("loss", "metric_loss", "mul_loss"):
        assert all(np.isfinite(_column(got, key))), key
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    mul = _column(got, "mul_loss")
    assert all(m > 0 for m in mul) if use_mse else all(
        -(16 + 16) <= m < 0 for m in mul)
    assert got_counts == want_counts and sum(got_counts) > 0
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)
    after = res.model.state_dict()
    for scope in FROZEN:
        assert _unchanged(before, after, scope), scope
    assert _moved(before, after, "modality_core")
    if use_mse:
        assert _moved(before, after, "modality_core_heads")
        heads = list(res.model["modality_core_heads"].parameters())
        assert {int(res.optimizer.state[p]["step"]) for p in heads} == \
            {res.step}


def test_branch_restore_takes_the_encoder_group(tmp_path):
    """``restore_branch(..., subkey="encoder")`` loads a bare RTSN tower
    from a ``pddm_model`` checkpoint (groups ``encoder`` and ``pddm``): the
    JAX trainers' ``_graft`` of the checkpoint's ``encoder`` subtree."""
    from multimodal_similarity_tpu_torch.models import PDDM
    saved = torch.nn.ModuleDict({"encoder": RTSN(3, 32, 8), "pddm": PDDM(32)})
    path = str(tmp_path / "pddm.ckpt-1")
    save_checkpoint(path, saved, None, 1)
    tower = RTSN(3, 32, 8, generator=torch.Generator().manual_seed(9))
    restore_branch(tower, path, subkey="encoder")
    for k, v in saved["encoder"].state_dict().items():
        assert torch.equal(tower.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# modality_hallucination and modality_hallucination_weak
# ---------------------------------------------------------------------------

HAL_CASES = {"full": False, "weak": True}


@pytest.mark.parametrize("case", list(HAL_CASES))
def test_hallucination_one_epoch_matches_jax_trainer(tmp_path, monkeypatch,
                                                     case):
    """``modality_hallucination`` (five branches) and its sensors-only
    variant against the JAX trainers from the JAX trainers' initial draws
    (core, sensors, hallucinated sensors, then segment and hallucinated
    segment): the loss, metric-loss and hallucination-loss traces within
    rtol 1e-4, the facenet triplet counts of every step equal, val mAP
    within atol 1e-3, every branch moved.  Every step's triplet mask is
    padded (0 < triplets < the 2 x triplet_per_batch capacity), so a
    tiled ``mask.repeat(3)`` in place of the JAX ``jnp.repeat`` (each mask
    entry three times in a row) would give another hallucination loss."""
    sensors_only = HAL_CASES[case]
    feats = "resnet,sensors" if sensors_only else FEATS
    modalities = feats.split(",")
    kw = dict(BASE, **CONV, DATA_ROOT=_data(tmp_path, modalities),
              feat=feats, label_num=3)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    keys = _keys(jcfg.seed, 3 if sensors_only else 5)
    params = {"modality_core": _video(jcfg, jcfg.emb_dim, keys[0]),
              "modality_sensors": _rtsn(jcfg, "sensors", keys[1]),
              "hallucination_sensors": _video(jcfg, 32, keys[2])}
    if not sensors_only:
        params["modality_segment"] = _rtsn(jcfg, "segment", keys[3])
        params["hallucination_segment"] = _video(jcfg, 32, keys[4])
    model = modality_hallucination.build_model(
        pcfg, torch.device("cpu"), 8, None if sensors_only else 12)
    load_flax_params(model, _to_np(params))
    before = _snapshot(model)
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    got_counts, want_counts = [], []
    _record_counts(monkeypatch, jax_hal, want_counts)
    _record_counts(monkeypatch, modality_hallucination, got_counts)
    jax_train = jax_hal_weak.train if sensors_only else jax_hal.train
    _, _, jax_dir = jax_train(jcfg, event_budget=BUDGET,
                              result_dir=str(tmp_path / "jax"))
    port_train = (modality_hallucination_weak.train if sensors_only
                  else modality_hallucination.train)
    res = port_train(pcfg, event_budget=BUDGET,
                     result_dir=str(tmp_path / "port"), device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)

    assert res.step == len(_column(want, "loss")) == 3
    for key in ("loss", "metric_loss", "hal_loss"):
        assert all(np.isfinite(_column(got, key))), key
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    assert all(h > 0 for h in _column(got, "hal_loss"))
    assert got_counts == want_counts
    assert all(0 < c < 2 * pcfg.triplet_per_batch for c in got_counts)
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)
    after = res.model.state_dict()
    for scope in params:
        assert _moved(before, after, scope), scope


# ---------------------------------------------------------------------------
# CLIs and options
# ---------------------------------------------------------------------------

CLIS = {
    "multitask_dcca": (multitask_dcca, FEATS, ["--label_num", "2"]),
    "multitask_cross_prediction": (multitask_cross_prediction, FEATS,
                                   ["--label_num", "2"]),
    "modality_hallucination": (modality_hallucination, FEATS, []),
    "modality_hallucination_weak": (modality_hallucination_weak,
                                    "resnet,sensors", []),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs_on_cpu(tmp_path, name):
    """``main([... --device cpu])`` trains an epoch and logs finite losses,
    a val mAP and a checkpoint."""
    module, feats, extra = CLIS[name]
    args = ["--device", "cpu", "--DATA_ROOT", _data(tmp_path), "--name",
            "cli", "--feat", feats, "--event_per_batch", str(BUDGET),
            "--sess_per_batch", "1", "--max_epochs", "1",
            "--triplet_per_batch", "12", "--lambda_multimodal", "0.1",
            "--silent_mode", *extra]
    for key, value in CONV.items():
        args += [f"--{key}", str(value)]
    module.main(args)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    recs = _records(str(run_dir))
    losses = _column(recs, "loss")
    assert losses and all(np.isfinite(losses))
    assert len(_column(recs, "val_mAP")) == 1
    assert any(n.startswith("cli.ckpt-") for n in os.listdir(run_dir))


@pytest.mark.parametrize("name", list(CLIS))
def test_options_and_missing_gpu_raise(tmp_path, monkeypatch, name):
    """--multihost raises D6's ValueError (no multi-process path in JAX),
    --model_parallel D8's ValueError (no tensor-parallel path in JAX), and
    --watchdog_secs arms the watchdog, which each step beats and the end
    of the run cancels unfired; --device_cache raises D5's ValueError (the
    JAX trainer has no cached feed), --int8_features raises ValueError, and
    the default device and ``--device cuda`` raise when no card is
    visible."""
    module, feats, _ = CLIS[name]
    root = _data(tmp_path)

    def cfg(**kw):
        return _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1,
                    feat=feats, **CONV, **kw)

    with pytest.raises(ValueError, match=f"--multihost: {name} has no "
                       "multi-process path"):
        module.train(cfg(multihost=True), device="cpu")
    with pytest.raises(ValueError, match=f"--model_parallel: {name} has no "
                       "tensor-parallel path"):
        module.train(cfg(model_parallel=2), device="cpu")
    beats = []
    real_beat = StepWatchdog.beat
    with pytest.MonkeyPatch.context() as m:
        m.setattr(StepWatchdog, "beat",
                  lambda self: beats.append(self) or real_beat(self))
        res = module.train(cfg(watchdog_secs=60.0, max_epochs=1),
                           device="cpu")
    assert res.step >= 1 and beats
    assert all(wd.fired == 0 and wd._timer is None for wd in beats)
    with pytest.raises(ValueError, match=f"{name} has no cached feed"):
        module.train(cfg(device_cache=True), device="cpu")
    with pytest.raises(ValueError, match="int8_features is not supported"):
        module.train(cfg(int8_features=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.train(cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device", "cuda", "--DATA_ROOT", root, "--feat",
                     feats, "--sess_per_batch", "1"])
