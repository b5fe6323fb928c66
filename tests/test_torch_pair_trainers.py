"""The port's single-modality pair trainers (``pddm_model``,
``multitask_model``, ``pairsim_model``) against the JAX trainers: one
epoch each on the same small synthetic Honda directory from the same
initial variables (the JAX trainer's own initial draws, carried into the
port through a step-0 checkpoint, ``--model_path``), dropout off; the host
pair samplers; the global-step and optimizer-step accounting of the
hard-pair pass; the CLIs and their option errors.  Tolerances at each
assertion."""

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
from test_torch_trainer import _cfg

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.models import heads as jh
from multimodal_similarity_tpu.train.trainers import (
    multitask_model as jax_multitask, pairsim_model as jax_pairsim,
    pddm_model as jax_pddm)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.models import PDDM, PairSim, PairSim2
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.train.checkpoints import (
    load_checkpoint, save_checkpoint)
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainers import (
    multitask_model, pairsim_model, pddm_model)

RTSN = dict(network="rtsn", feat="sensors", n_input=8, num_seg=3,
            emb_dim=16)
CONV = dict(network="convrtsn", feat="resnet", n_input=8, n_h=2, n_w=2,
            n_C=4, num_seg=3, emb_dim=16)
BUDGET = 48

# trainer -> (JAX module, port module, width, head group, JAX head, port
# head factory, key split ways of the JAX step, extra config)
TRAINERS = {
    "pddm_model": (jax_pddm, pddm_model, RTSN, "pddm",
                   lambda c: jh.PDDM(n_input=c.emb_dim),
                   lambda c: lambda gen, _: PDDM(c.emb_dim, gen), 2,
                   dict(triplet_per_batch=12, num_negative=3)),
    "multitask_model": (jax_multitask, multitask_model, CONV, "ver",
                        lambda c: jh.PairSim2(n_input=c.emb_dim),
                        lambda c: lambda gen, drop: PairSim2(
                            c.emb_dim, c.keep_prob, gen, drop), 3,
                        dict(triplet_per_batch=12, num_negative=3,
                             lambda_ver=0.5)),
    "pairsim_model": (jax_pairsim, pairsim_model, RTSN, "ver",
                      lambda c: jh.PairSim(n_input=c.emb_dim),
                      lambda c: lambda gen, drop: PairSim(
                          c.emb_dim, c.keep_prob, gen, drop), 2,
                      dict(batch_size=16, num_negative=1,
                           negative_epochs=0)),
}


def _data(tmp_path):
    """5 sessions of short events (4-15 frames), so that every 1-session
    batch of 48 events holds classes with several members."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8),
                                         "sensors": (8,)},
                             seed=0, length_range=(4, 16))
    return root


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _column(recs, key):
    return [r[key] for r in recs if key in r]


def jax_trainer_draws(seed: int, ways: int):
    """A stand-in for the port's Gumbel draw that replays a JAX Honda
    trainer's key sequence: PRNGKey(seed), two splits for the encoder's
    and the head's initial variables, then one split a step, the step key
    split ``ways`` ways (pddm_model: k_mine, k_drop; multitask_model:
    k_mine, k_drop, k_ver) and split(k_mine, 3) into the anchor, positive
    and negative keys."""
    state = {"rng": jax.random.PRNGKey(seed)}
    for _ in range(2):
        state["rng"], _ = jax.random.split(state["rng"])

    def draw(num_pairs, n, num_negative, generator, device):
        state["rng"], key = jax.random.split(state["rng"])
        k_mine = jax.random.split(key, ways)[0]
        k_a, k_p, k_n = jax.random.split(k_mine, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]

    return draw


def _pair_run(tmp_path, name, **extra):
    """Both trainers, one epoch on the same directory from the JAX
    trainer's initial variables.  Returns (port records, JAX records, port
    result)."""
    jmod, pmod, width, group, jhead, phead, ways, kw = TRAINERS[name]
    kw = dict(kw, **width, DATA_ROOT=_data(tmp_path), sess_per_batch=1,
              max_epochs=1, log_flush_every=1, **extra)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)

    # the JAX trainer's initial variables: PRNGKey(seed), one split for
    # the encoder, one for the head
    feat = (2, 2, 8) if width is CONV else (8,)
    rng = jax.random.PRNGKey(jcfg.seed)
    rng, k_enc = jax.random.split(rng)
    _, k_head = jax.random.split(rng)
    encoder = jax_build(jcfg.network, num_seg=jcfg.num_seg,
                        emb_dim=jcfg.emb_dim, n_input=jcfg.n_input,
                        n_h=jcfg.n_h, n_w=jcfg.n_w, n_C=jcfg.n_C)
    e0 = jnp.zeros((2, jcfg.emb_dim), jnp.float32)
    params = {"encoder": encoder.init(
                  k_enc, jnp.zeros((2, jcfg.num_seg) + feat))["params"],
              group: jhead(jcfg).init(k_head, e0, e0,
                                      method="score")["params"]}
    model = pddm_model.pair_model(pcfg, group, phead(pcfg),
                                  torch.device("cpu"))
    load_flax_params(model, jax.tree.map(np.asarray, params))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model,
                    build_optimizer("ADAM", model, pcfg.learning_rate), 0)

    _, _, jax_dir = jmod.train(jcfg, event_budget=BUDGET,
                               result_dir=str(tmp_path / "jax"))
    res = pmod.train(pcfg, event_budget=BUDGET,
                     result_dir=str(tmp_path / "port"), device="cpu")
    return _records(res.result_dir), _records(jax_dir), res


@pytest.mark.parametrize("name", ["pddm_model", "multitask_model"])
def test_one_epoch_matches_jax_trainer(tmp_path, monkeypatch, name):
    """The loss trace within rtol 1e-4 of the JAX trainer's, val mAP (and
    pddm_model's val_mAP_PDDM) within atol 1e-3: the miner draws the JAX
    trainer's Gumbel values (pddm_model's on the PDDM dissimilarity
    matrix)."""
    monkeypatch.setattr(mining, "_draw_gumbels", jax_trainer_draws(
        TrainConfig().seed, TRAINERS[name][6]))
    got, want, res = _pair_run(tmp_path, name)
    got_loss, want_loss = _column(got, "loss"), _column(want, "loss")
    assert res.step == len(want_loss) >= 3
    assert all(np.isfinite(got_loss)) and sum(
        _column(want, "triplet_num")) > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    keys = ["val_mAP"] + (["val_mAP_PDDM"] if name == "pddm_model" else [])
    for key in keys:
        assert len(_column(got, key)) == 1
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   atol=1e-3, err_msg=key)


def test_pairsim_one_epoch_matches_jax_trainer(tmp_path, monkeypatch):
    """The loss trace within rtol 1e-4, the hard-pair count of each step
    and val_acc equal to the JAX trainer's; with hard passes in the epoch,
    the global step equals the loader batches that gave pairs, and Adam's
    step count the number of optimizer steps (the hard passes
    included)."""
    calls = []
    real = pairsim_model.make_pairsim_step

    def counting(*a, **k):
        step = real(*a, **k)

        def run(*args):
            calls.append(1)
            return step(*args)
        return run

    monkeypatch.setattr(pairsim_model, "make_pairsim_step", counting)
    got, want, res = _pair_run(tmp_path, "pairsim_model")
    got_loss, want_loss = _column(got, "loss"), _column(want, "loss")
    assert len(want_loss) >= 3
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    hard = _column(got, "negative_count")
    assert hard == _column(want, "negative_count") and sum(hard) > 0
    assert _column(got, "val_acc") == _column(want, "val_acc")
    assert [r["step"] for r in got if "loss" in r] == \
        [r["step"] for r in want if "loss" in r]

    # every loader batch of this directory gives pairs, so one epoch is
    # one step a batch
    assert res.step == len(got_loss) == 3
    assert len(calls) == res.step + sum(1 for h in hard if h)
    adam_steps = {int(s["step"]) for s in res.optimizer.state.values()}
    assert adam_steps == {len(calls)}
    assert os.path.getsize(os.path.join(res.result_dir,
                                        "val_results.txt")) > 0


def test_pair_samplers_match_jax(rng):
    """``random_pairs`` (a seeded stream, and test=True) and
    ``hard_pairs`` give the JAX package's lists."""
    labels = rng.randint(0, 5, size=40)
    for test in (False, True):
        got = pairsim_model.random_pairs(labels, 30, 2, test=test,
                                         rng=random.Random(4))
        want = jax_pairsim.random_pairs(labels, 30, 2, test=test,
                                        rng=random.Random(4))
        assert got == want and got[1]
    lab = rng.randint(0, 2, size=50)
    prob = rng.dirichlet([1, 1], size=50)
    for threshold in (0.5, 0.9):
        assert pairsim_model.hard_pairs(lab, prob, threshold) == \
            jax_pairsim.hard_pairs(lab, prob, threshold)


def test_pddm_checkpoint_restores_encoder_and_pddm(tmp_path):
    """The epoch checkpoint of ``pddm_model`` holds the parameter groups
    ``encoder`` and ``pddm`` and restores them into a fresh model."""
    kw = dict(TRAINERS["pddm_model"][7], **RTSN, DATA_ROOT=_data(tmp_path),
              sess_per_batch=1, max_epochs=1)
    cfg = _cfg(TrainConfig, **kw)
    res = pddm_model.train(cfg, event_budget=BUDGET,
                           result_dir=str(tmp_path / "run"), device="cpu")
    fresh = pddm_model.pair_model(
        _cfg(TrainConfig, **dict(kw, seed=cfg.seed + 10)), "pddm",
        lambda gen, _: PDDM(cfg.emb_dim, gen), torch.device("cpu"))
    path = os.path.join(res.result_dir, f"t.ckpt-{res.step}")
    assert load_checkpoint(path, fresh) == res.step
    want = res.model.state_dict()
    assert {k.split(".")[0] for k in want} == {"encoder", "pddm"}
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key


@pytest.mark.parametrize("name", list(TRAINERS))
def test_cli_runs_on_cpu(tmp_path, name):
    """``python -m ...<trainer> --device cpu`` trains an epoch and logs
    finite losses and its validation metric."""
    width = TRAINERS[name][2]
    args = ["--device", "cpu", "--DATA_ROOT", _data(tmp_path), "--name",
            "cli", "--event_per_batch", str(BUDGET), "--sess_per_batch",
            "1", "--max_epochs", "1", "--silent_mode"]
    for key, value in width.items():
        args += [f"--{key}", str(value)]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-m",
                    f"multimodal_similarity_tpu_torch.train.trainers.{name}",
                    *args], check=True, env=env, cwd=str(tmp_path),
                   timeout=300)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    recs = _records(str(run_dir))
    losses = _column(recs, "loss")
    metric = "val_acc" if name == "pairsim_model" else "val_mAP"
    assert losses and all(np.isfinite(losses))
    assert len(_column(recs, metric)) == 1
    assert any(n.startswith("cli.ckpt-") for n in os.listdir(run_dir))


@pytest.mark.parametrize("name", list(TRAINERS))
def test_options_and_missing_gpu_raise(tmp_path, monkeypatch, name):
    """--int8_features raises ValueError (the pair trainers feed f32);
    --device_cache raises D5's ValueError on ``pairsim_model`` (no cached
    feed) and the reference's on the others under --bf16_features (the
    cache stores int8); the default device raises when no card is
    visible."""
    pmod, width = TRAINERS[name][1], TRAINERS[name][2]
    root = _data(tmp_path)

    def cfg(**kw):
        return _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1,
                    **width, **kw)

    with pytest.raises(ValueError, match="int8_features is not supported"):
        pmod.train(cfg(int8_features=True), device="cpu")
    with pytest.raises(ValueError, match=(
            "pairsim_model has no cached feed" if name == "pairsim_model"
            else "excludes --bf16_features")):
        pmod.train(cfg(device_cache=True, bf16_features=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmod.train(cfg())
