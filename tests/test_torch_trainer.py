"""The port's training step, optimizer, metrics and trainer against the JAX
package's, on the same numpy inputs and the same initial params (mapped by
convert.py).  Everything runs in f32 on the CPU; tolerances are stated at
each assertion and come from f32 summation order."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.eval.metrics import (
    evaluate as jax_evaluate, evaluate_simple as jax_evaluate_simple,
    retrieval_metrics_device)
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.ops.pallas import (
    batch_hard_pallas, lifted_loss_pallas)
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer,
    l2_regularization as jax_l2, learning_rate_schedule as jax_lr_schedule)
from multimodal_similarity_tpu.train.steps import (
    l2_normalize as jax_l2_normalize)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.eval.metrics import (
    evaluate, evaluate_simple, retrieval_metrics)
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.train.checkpoints import (
    CheckpointManager, save_checkpoint)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer, l2_regularization,
    learning_rate_schedule)
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_batchhard, base_model_lifted)

SMALL = dict(num_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2, n_C=4)


def _cfg(cls, **kw):
    d = dict(name="t", network="convrtsn", feat="resnet", silent_mode=True,
             learning_rate=0.01, keep_prob=1.0, lambda_l2=0.0, **SMALL)
    d.update(kw)
    return cls(**d).resolve()


def test_one_step_matches_jax(rng):
    """One optimizer step from mapped params: the same loss, gradients and
    updated params (loss rtol 1e-5; grads and params atol 1e-6)."""
    x = rng.randn(24, 3, 2, 2, 8).astype(np.float32)
    labels = np.repeat(np.arange(1, 7), 4)
    cfg = _cfg(TrainConfig, lambda_l2=1e-3)
    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    state = TrainState.create(params, jax_build_optimizer("ADAM", 0.01))

    def loss_fn(p):
        emb = jax_l2_normalize(jm.apply({"params": p}, jnp.asarray(x),
                                        train=True,
                                        rngs={"dropout": jax.random.PRNGKey(1)}))
        loss = batch_hard_pallas(emb, jnp.asarray(labels), "soft", True,
                                 block=8, precision="f32")[0]
        return loss + cfg.lambda_l2 * jax_l2(p)

    total, grads = jax.value_and_grad(loss_fn)(state.params)
    new_state = state.apply_gradients(grads, learning_rate=jnp.float32(0.01))

    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    opt = build_optimizer("ADAM", tm, 0.01)
    step = base_model_batchhard.make_balanced_batch_step(
        tm, opt, cfg, "batchhard", precision="f32")
    aux = step(torch.from_numpy(x), torch.from_numpy(labels), 0.01)

    np.testing.assert_allclose(aux["loss"].item(), float(total), rtol=1e-5)
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, grads), tm)
    want_p = flax_to_state_dict(jax.tree.map(np.asarray, new_state.params),
                                tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_l2_regularization_exempts_lstm_and_biases(rng):
    x = jnp.zeros((2, 3, 2, 2, 8))
    params = jax_build("convrtsn", **SMALL).init(jax.random.PRNGKey(2),
                                                   x)["params"]
    params = jax.tree.map(lambda a: a + 0.3, params)  # nonzero biases
    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(l2_regularization(tm).item(),
                               float(jax_l2(params)), rtol=1e-5)
    only_embed = 0.5 * float((tm.embed.conv1x1.weight.detach() ** 2).sum())
    np.testing.assert_allclose(l2_regularization(tm).item(), only_embed,
                               rtol=1e-6)


def test_branch_scope_gradient_scale_matches_optax(rng):
    """Parameters under a pretrained branch scope get 0.1x gradients before
    Adam (eps=0.1), as optax's chain; two steps, atol 1e-6."""

    class Toy(nn.Module):
        def __init__(self):
            super().__init__()
            self.modality_sensors = nn.Linear(3, 2)
            self.head = nn.Linear(2, 2)

    toy = Toy()
    params = {k: {"kernel": getattr(toy, k).weight.detach().numpy().T.copy(),
                  "bias": getattr(toy, k).bias.detach().numpy().copy()}
              for k in ("modality_sensors", "head")}
    state = TrainState.create(jax.tree.map(jnp.asarray, params),
                              jax_build_optimizer("ADAM", 0.05))
    opt = build_optimizer("ADAM", toy, 0.05)
    assert [g["grad_scale"] for g in opt.param_groups] == [1.0, 0.1]
    for _ in range(2):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        state = state.apply_gradients(jax.tree.map(jnp.asarray, grads),
                                      learning_rate=jnp.float32(0.05))
        for name, g in flax_to_state_dict(grads, toy).items():
            toy.get_parameter(name).grad = g.clone()
        apply_gradients(opt, 0.05)
    want = flax_to_state_dict(jax.tree.map(np.asarray, state.params), toy)
    for name, p in toy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("epoch", [0, 999, 1000, 1500, 2000])
def test_learning_rate_schedule_matches(epoch):
    assert learning_rate_schedule(epoch, 1e-2, 1000, 2000) == pytest.approx(
        jax_lr_schedule(epoch, 1e-2, 1000, 2000), rel=1e-12)


def test_retrieval_metrics_match_jax_and_oracle(rng):
    """mAP, mPrec and Recall@K equal the JAX device metrics (atol 1e-5)
    and the NumPy oracle (atol 2e-3, which integrates ties differently)."""
    labels = rng.randint(0, 5, size=60)
    centers = rng.randn(5, 8)
    emb = (centers[labels] + 0.9 * rng.randn(60, 8)).astype(np.float32)
    got = retrieval_metrics(torch.from_numpy(emb), labels)
    want = retrieval_metrics_device(emb, labels)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], atol=1e-5)
    oracle = evaluate_simple(emb, labels)
    np.testing.assert_allclose(oracle, jax_evaluate_simple(emb, labels),
                               atol=1e-12)
    np.testing.assert_allclose([got[0], got[1], got[2][1]], oracle,
                               atol=2e-3)
    # the full oracle is a copy: identical outputs
    full, want_full = evaluate(emb, labels), jax_evaluate(emb, labels)
    for g, w in ((full[0], want_full[0]), (full[2], want_full[2]),
                 (full[5], want_full[5])):
        np.testing.assert_allclose(g, w, atol=1e-12)
    assert full[1] == want_full[1]
    np.testing.assert_array_equal(full[3]["confusion_matrix"],
                                  want_full[3]["confusion_matrix"])
    np.testing.assert_array_equal(full[4], want_full[4])


def test_checkpoint_round_trip_and_pruning(tmp_path):
    model = build_encoder("rtsn", emb_dim=4, n_input=3)
    opt = build_optimizer("ADAM", model, 0.1)
    model(torch.randn(2, 3, 3)).sum().backward()
    apply_gradients(opt, 0.1)
    mgr = CheckpointManager(str(tmp_path), "m", max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(model, opt, step)
    assert mgr.all_steps() == [2, 3]
    fresh = build_encoder("rtsn", emb_dim=4, n_input=3)
    fresh_opt = build_optimizer("ADAM", fresh, 0.1)
    assert mgr.restore(fresh, fresh_opt) == 3
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    assert fresh_opt.state_dict()["state"].keys() == \
        opt.state_dict()["state"].keys()


@pytest.mark.parametrize("flag,value,slice_no", [
    ("multihost", True, 8),
    ("model_parallel", 2, 8), ("profile_dir", "p", 8),
    ("watchdog_secs", 5.0, 8)])
def test_unported_flags_raise(tmp_path, flag, value, slice_no):
    """The slice-8 flags on the batch-hard trainer: --multihost raises
    ROADMAP D6's ValueError (the JAX trainer has no multi-process path),
    --model_parallel 2 without a process group JAX's ValueError (the model
    axis does not divide the one visible device); --profile_dir and
    --watchdog_secs run (slice 8b): a one-epoch run writes the step-window
    trace, or arms the watchdog and cancels it unfired."""
    if flag == "multihost":
        cfg = _cfg(TrainConfig, DATA_ROOT=str(tmp_path), **{flag: value})
        with pytest.raises(ValueError, match="--multihost: "
                           "base_model_batchhard has no multi-process path"):
            base_model_batchhard.train(cfg, device="cpu")
        return
    if flag == "model_parallel":
        cfg = _cfg(TrainConfig, DATA_ROOT=str(tmp_path), **{flag: value})
        with pytest.raises(ValueError, match="--model_parallel 2 does not "
                           "divide the 1 visible devices"):
            base_model_batchhard.train(cfg, device="cpu")
        return
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    if flag == "profile_dir":
        value = str(tmp_path / value)
    cfg = _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1, batch_size=32,
               max_epochs=1, profile_steps=1, **{flag: value})
    fired = []
    real = base_model_batchhard.HondaExperiment.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        wd = self.control.watchdog
        if wd is not None:
            wd.on_timeout = lambda: fired.append(1)
            fired.append(wd)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(base_model_batchhard.HondaExperiment, "__init__", init)
        res = base_model_batchhard.train(cfg, event_budget=48, device="cpu")
    assert res.step == 3
    if flag == "profile_dir":
        assert os.listdir(value) == ["trace_steps2-2.pt.trace.json"]
    else:
        (wd,) = fired  # armed, never fired, and cancelled on close
        assert wd.fired == 0 and wd._timer is None


def test_base_model_multihost_needs_processes(tmp_path):
    """``base_model --multihost`` on one process raises the reference's
    RuntimeError (no mesh of two or more devices across processes)."""
    from multimodal_similarity_tpu_torch.train.trainers import base_model
    cfg = _cfg(TrainConfig, DATA_ROOT=str(tmp_path), multihost=True,
               triplet_select="facenet")
    with pytest.raises(RuntimeError, match="--multihost needs >= 2 devices "
                       "across processes"):
        base_model.train(cfg, device="cpu")


def test_lifted_and_missing_gpu_raise(tmp_path, monkeypatch):
    """An unknown loss kind raises (lifted is ported and runs), and so does
    the default device when no card is visible."""
    cfg = _cfg(TrainConfig, DATA_ROOT=str(tmp_path))
    with pytest.raises(ValueError, match="unknown loss_kind"):
        base_model_batchhard.train(cfg, loss_kind="npairs", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base_model_batchhard.train(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base_model_lifted.train(cfg)


@pytest.mark.parametrize("normalized", [True, False])
def test_one_lifted_step_matches_jax(rng, normalized):
    """One optimizer step of the lifted objective from mapped params (the
    triangular forward when normalised, the row forward when not): the
    same loss, gradients and updated params (loss rtol 1e-5; grads rtol
    1e-4 / atol 1e-6; params atol 1e-6)."""
    x = rng.randn(24, 3, 2, 2, 8).astype(np.float32)
    labels = np.repeat(np.arange(1, 7), 4)
    cfg = _cfg(TrainConfig, normalized=normalized)
    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    state = TrainState.create(params, jax_build_optimizer("ADAM", 0.01))

    def loss_fn(p):
        emb = jm.apply({"params": p}, jnp.asarray(x), train=True,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        if normalized:
            emb = jax_l2_normalize(emb)
        return lifted_loss_pallas(emb, jnp.asarray(labels), cfg.alpha, True,
                                  block=8, bounded=normalized)[0]

    total, grads = jax.value_and_grad(loss_fn)(state.params)
    new_state = state.apply_gradients(grads, learning_rate=jnp.float32(0.01))

    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    opt = build_optimizer("ADAM", tm, 0.01)
    step = base_model_batchhard.make_balanced_batch_step(tm, opt, cfg,
                                                         "lifted")
    aux = step(torch.from_numpy(x), torch.from_numpy(labels), 0.01)

    np.testing.assert_allclose(aux["loss"].item(), float(total), rtol=1e-5)
    assert aux["active_count"].item() == 1.0
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, grads), tm)
    want_p = flax_to_state_dict(jax.tree.map(np.asarray, new_state.params),
                                tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["loss"] for r in recs if "loss" in r],
            [r["val_mAP"] for r in recs if "val_mAP" in r])


def _one_epoch_pair(tmp_path, port_train, jax_train, **extra):
    """One epoch of the port's trainer and the JAX trainer on the same
    synthetic directory from the same initial params, dropout off.
    Returns ((port losses, port val mAPs), (JAX ...), port steps)."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    kw = dict(DATA_ROOT=root, sess_per_batch=1, batch_size=32,
              max_epochs=1, log_flush_every=1, **extra)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)

    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((2, 3, 2, 2, 8)))["params"]
    jcfg.model_path = str(tmp_path / "init.msgpack")
    save_pytree(jcfg.model_path, TrainState.create(
        params, jax_build_optimizer("ADAM", jcfg.learning_rate)))
    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, tm,
                    build_optimizer("ADAM", tm, pcfg.learning_rate), 0)

    _, _, jax_dir = jax_train(jcfg, event_budget=48,
                              result_dir=str(tmp_path / "jax"))
    res = port_train(pcfg, event_budget=48,
                     result_dir=str(tmp_path / "port"), device="cpu")
    return _records(res.result_dir), _records(jax_dir), res.step


def test_one_epoch_matches_jax_trainer(tmp_path, monkeypatch):
    """Both trainers, one epoch on the same synthetic directory from the
    same initial params with dropout off: the same balanced batches, a loss
    trace within rtol 1e-4 and the same val mAP (atol 1e-3).  The JAX run
    here spreads the batch over the suite's virtual CPU devices (f32 ring
    pass), so the port runs its stats in f32 too."""
    from multimodal_similarity_tpu.train.trainers import (
        base_model_batchhard as jax_trainer)
    real_step = base_model_batchhard.make_balanced_batch_step
    monkeypatch.setattr(
        base_model_batchhard, "make_balanced_batch_step",
        lambda *a, **k: real_step(*a, **dict(k, precision="f32")))
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, base_model_batchhard.train, jax_trainer.train)
    assert steps == len(want_loss) == 3
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


@pytest.mark.parametrize("normalized", [True, False])
def test_one_lifted_epoch_matches_jax_trainer(tmp_path, normalized):
    """The lifted trainers, one epoch, as above: the port's triangular
    forward (normalised) or row forward (not) against the JAX trainer's
    ring pass over the virtual CPU devices, both in f32.  Loss trace rtol
    1e-4, val mAP atol 1e-3."""
    from multimodal_similarity_tpu.train.trainers import (
        base_model_lifted as jax_lifted_trainer)
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, base_model_lifted.train, jax_lifted_trainer.train,
        normalized=normalized)
    assert steps == len(want_loss) == 3
    assert all(np.isfinite(got_loss))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_lifted_cli_runs_on_cpu(tmp_path):
    """``python -m ...base_model_lifted --device cpu`` trains an epoch on a
    synthetic directory and logs finite losses and a val mAP."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    args = ["--device", "cpu", "--DATA_ROOT", root, "--name", "cli",
            "--network", "convrtsn",
            "--feat", "resnet", "--num_seg", "3", "--emb_dim", "16",
            "--n_input", "8", "--n_h", "2", "--n_w", "2", "--n_C", "4",
            "--batch_size", "32", "--event_per_batch", "48",
            "--sess_per_batch", "1", "--max_epochs", "1", "--silent_mode"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-m",
                    "multimodal_similarity_tpu_torch.train.trainers."
                    "base_model_lifted", *args],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    # results land under <DATA_ROOT>/results/<name>_<timestamp>
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    losses, maps = _records(str(run_dir))
    assert losses and all(np.isfinite(losses))
    assert len(maps) == 1 and np.isfinite(maps[0])
