"""The port's fused cached steps (``train/cached_steps.py``) and the
``--device_cache`` / ``--steps_per_dispatch`` paths of its trainers against
the JAX package's, on the same small synthetic directory (ConvRTSN 2x2x8,
emb_dim 16, budget 48), dropout off.  The JAX side runs with ``mesh=None``
(``parallel.auto_mesh`` patched to give none) and its int8 dequantization
pinned to the bf16 rounding it states (ROADMAP D1); the port's uniform,
Gumbel and structure draws replay the JAX steps' keys (the gather's
uniforms from the first split of a step key, then the step's own splits of
the second).  Tolerances at each assertion."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_base_model import rounded_dequant
from test_torch_multimodal import (
    BRANCHES, CONV, MM, _column, _jax_params, _port_model, _records,
    jax_structure_draws)
from test_torch_multimodal import _data as mm_data
from test_torch_trainer import SMALL, _cfg, _one_epoch_pair

import multimodal_similarity_tpu.parallel as jax_parallel
from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import device_cache as jdc
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.data.datasets import prepare_dataset
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.models import OutputLayer as JaxOutputLayer
from multimodal_similarity_tpu.models import heads as jh
from multimodal_similarity_tpu.train import cached_steps as jcs
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import (
    base_model as jax_base_model, base_model_batchhard as jax_bh,
    base_model_lifted as jax_lifted, cross_prediction as jax_cross,
    multimodal_model as jax_mm, multitask_model as jax_multitask)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.data import device_cache, tsn
from multimodal_similarity_tpu_torch.models import PairSim2, build_encoder
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.train import cached_steps
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model, base_model_batchhard, base_model_lifted, cross_prediction,
    multimodal_model, multitask_model, pairsim_model, pddm_model,
    unimodal_pretrain_sae)
from multimodal_similarity_tpu_torch.utils import profiling

BUDGET = 48
TRIPLETS = dict(triplet_per_batch=12, num_negative=3, alpha=0.2)
CONV_SMALL = dict(network="convrtsn", feat="resnet", **SMALL)


def key_chain(seed: int, skip: int):
    """The JAX trainers' step keys: PRNGKey(seed), ``skip`` splits for the
    initial variables, then one split a step."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(skip):
        rng, _ = jax.random.split(rng)
    while True:
        rng, key = jax.random.split(rng)
        yield key


class JaxCachedDraws:
    """Stand-ins for the port's uniform, Gumbel and structure draws that
    replay the JAX cached steps' keys, one step key from ``keys`` a step:
    split(key) into (k_gather, k_rest); the gather's uniforms are
    uniform(fold_in(k_gather, m)) for each TSN modality m; the semi-hard
    draw takes split(k_rest, ways)[0] split 3 ways (the negatives' key
    split once a negative), the structure draw split(k_rest, 3)[1]."""

    def __init__(self, keys, tsn_modalities=(0,), ways=2):
        self.keys, self.mods, self.ways = keys, tsn_modalities, ways
        self.pending = []

    def patch(self, monkeypatch):
        monkeypatch.setattr(tsn, "draw_tsn_uniforms", self.uniforms)
        monkeypatch.setattr(mining, "_draw_gumbels", self.gumbels)
        monkeypatch.setattr(mining, "_draw_structure_gumbels",
                            self.structure)

    def uniforms(self, generator, b, n_seg, device):
        if not self.pending:
            k_gather, self.k_rest = jax.random.split(next(self.keys))
            self.pending = [jax.random.fold_in(k_gather, m)
                            for m in self.mods]
        return torch.from_numpy(np.array(jax.random.uniform(
            self.pending.pop(0), (b, n_seg)))).to(device)

    def gumbels(self, num_pairs, n, num_negative, generator, device):
        k_mine = jax.random.split(self.k_rest, self.ways)[0]
        k_a, k_p, k_n = jax.random.split(k_mine, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]

    def structure(self, hard_budget, struct_rows, n, generator, device):
        return jax_structure_draws(jax.random.split(self.k_rest, 3)[1])(
            hard_budget, struct_rows, n, generator, device)


@pytest.fixture
def pinned(monkeypatch):
    """The JAX side with mesh=None and its int8 dequantization rounded to
    bf16 (D1), in every module that dequantizes a cached batch."""
    monkeypatch.setattr(jax_parallel, "auto_mesh",
                        lambda n, **kw: (None, n))
    for mod in (jax_steps, jcs, jax_multitask):
        monkeypatch.setattr(mod, "dequant_features", rounded_dequant)


@pytest.fixture(scope="module")
def resnet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cached"))
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    return root


def _caches(root):
    cfg = JaxTrainConfig(DATA_ROOT=root).resolve()
    rows = prepare_dataset(cfg.feature_root, cfg.train_session, "resnet",
                           cfg.label_root, "goal")
    kw = dict(n_seg=3, sess_per_batch=1, event_budget=BUDGET, seed=1,
              verbose=False)
    return (device_cache.DeviceFeatureCache.build(rows, device="cpu", **kw),
            jdc.DeviceFeatureCache.build(rows, **kw))


def _encoders():
    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((2, 3, 2, 2, 8)))["params"]
    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _assert_params(model, jax_params, rtol=1e-4):
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax_params), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=1e-6, err_msg=name)


def _jax_run(step, operands, state, plans, keys, lr=0.01):
    aux_list = []
    for plan, key in zip(plans, keys):
        state, aux = step(state, plan[None], key, jnp.float32(lr), *operands)
        aux_list.append(float(aux["loss"]))
    return state, aux_list


@pytest.mark.parametrize("k", [1, 2])
def test_cached_triplet_step_matches_jax(resnet_root, monkeypatch, pinned,
                                         k):
    """Three fused semi-hard steps on the same plans and params: losses and
    parameters within rtol 1e-4 of the JAX steps (K=1), and of the JAX
    scanned program over a window of two plus a K=1 tail (K=2)."""
    cache, jcache = _caches(resnet_root)
    jm, params, tm = _encoders()
    plans = [p["packed"] for p in cache.epoch_plans()]
    assert len(plans) == 3
    cfg = dict(TRIPLETS, metric="squaredeuclidean", normalized=True,
               lambda_l2=0.0)
    keys = list(jax.random.split(jax.random.PRNGKey(9), 3))

    state = TrainState.create(params, jax_build_optimizer("ADAM", 0.01))
    fused = jcs.make_cached_triplet_step(jm, jcache, **cfg)
    ops = jcache.step_operands()
    if k == 1:
        state, want = _jax_run(fused, ops, state, plans, keys)
    else:
        multi = jcs.make_cached_triplet_step(jm, jcache, **cfg,
                                             steps_per_dispatch=2)
        state, auxs = multi(state, jnp.asarray(np.stack(plans[:2]))[:, None],
                            jnp.stack(keys[:2]), jnp.float32(0.01),
                            *ops)
        state, tail = _jax_run(fused, ops, state, plans[2:], keys[2:])
        want = [float(v) for v in auxs["loss"]] + tail

    JaxCachedDraws(iter(keys)).patch(monkeypatch)
    opt = build_optimizer("ADAM", tm, 0.01)
    step = cached_steps.make_cached_triplet_step(tm, opt, cache, **cfg)
    got = []
    for start in range(0, 3, k):
        got += [float(a["loss"]) for a in cached_steps.dispatch_plan_window(
            plans[start:start + k], 0.01, fused=step, device="cpu")]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_params(tm, state.params)


def test_window_equals_single_steps(resnet_root):
    """A whole K=2 window gives exactly the scalars and parameters of the
    same two plans run one at a time, under the same generators."""
    cache, _ = _caches(resnet_root)
    plans = [p["packed"] for p in cache.epoch_plans()][:2]
    out = []
    for k in (1, 2):
        _, _, tm = _encoders()
        opt = build_optimizer("ADAM", tm, 0.01)
        step = cached_steps.make_cached_triplet_step(
            tm, opt, cache, **TRIPLETS,
            gather_generator=torch.Generator().manual_seed(0),
            mine_generator=torch.Generator().manual_seed(1))
        aux = (cached_steps.dispatch_plan_window(plans, 0.01, fused=step,
                                                 device="cpu")
               if k == 2 else
               [a for p in plans for a in cached_steps.dispatch_plan_window(
                   [p], 0.01, fused=step, device="cpu")])
        out.append(([a["loss"] for a in aux],
                    [p.detach().clone() for p in tm.parameters()]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_cached_body_step_matches_jax(resnet_root, monkeypatch, pinned):
    """``make_cached_body_step`` over the multitask trainer's step (the
    step key split (k_mine, k_drop, k_ver)) against the JAX one: three
    steps, loss and parameters within rtol 1e-4."""
    cache, jcache = _caches(resnet_root)
    pcfg = _cfg(TrainConfig, **TRIPLETS, lambda_ver=0.5)
    jcfg = _cfg(JaxTrainConfig, **TRIPLETS, lambda_ver=0.5)
    jm, enc_params, _ = _encoders()
    head = jh.PairSim2(n_input=16, keep_prob=1.0)
    e0 = jnp.zeros((2, 16), jnp.float32)
    params = jax.tree.map(np.asarray, {"encoder": enc_params, "ver": head.init(
        jax.random.PRNGKey(4), e0, e0, method="score")["params"]})
    raw = jax_multitask.make_multitask_step(jm, head, jcfg, jit=False)
    fused = jcs.make_cached_body_step(
        lambda st, ev, lab, m, key, lr: raw(st, ev[0], lab, m, key, lr),
        jcache)
    plans = [p["packed"] for p in cache.epoch_plans()]
    keys = list(jax.random.split(jax.random.PRNGKey(2), 3))
    state, want = _jax_run(fused, jcache.step_operands(), TrainState.create(
        jax.tree.map(jnp.asarray, params), jax_build_optimizer("ADAM", 0.01)),
        plans, keys)

    JaxCachedDraws(iter(keys), ways=3).patch(monkeypatch)
    model = pddm_model.pair_model(pcfg, "ver", lambda gen, drop: PairSim2(
        16, 1.0, gen, drop), torch.device("cpu"))
    load_flax_params(model, params)
    opt = build_optimizer("ADAM", model, 0.01)
    inner = multitask_model.make_multitask_step(model, opt, pcfg, None)
    step = cached_steps.make_cached_body_step(
        lambda ev, lab, m, lr: inner(ev[0], lab, m, lr), cache, None)
    got = [float(step(torch.from_numpy(p), 0.01)["loss"]) for p in plans]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_params(model, state.params)


@pytest.mark.parametrize("kind,k", [("batchhard", 1), ("batchhard", 2),
                                    ("lifted", 1)])
def test_batchhard_epoch_matches_jax(tmp_path, monkeypatch, pinned, kind, k):
    """One epoch of ``base_model_batchhard --device_cache`` (K=1, and
    ``--steps_per_dispatch 2``: a window of two and a tail of one) and of
    ``base_model_lifted --device_cache`` (the normalised K6/K5 path)
    against the JAX trainer, both in f32: loss trace rtol 1e-4, val mAP
    atol 1e-3; the cache gathered once a step."""
    real_step = base_model_batchhard.make_balanced_batch_step
    monkeypatch.setattr(
        base_model_batchhard, "make_balanced_batch_step",
        lambda *a, **kw: real_step(*a, **dict(kw, precision="f32")))
    real_loss = jax_bh.batch_hard_pallas
    monkeypatch.setattr(jax_bh, "batch_hard_pallas",
                        lambda *a, **kw: real_loss(*a, precision="f32",
                                                   **kw))
    JaxCachedDraws(key_chain(TrainConfig().seed, 1)).patch(monkeypatch)
    device_cache.reset_counts()
    port, jax_train = ((base_model_batchhard.train, jax_bh.train)
                       if kind == "batchhard" else
                       (base_model_lifted.train, jax_lifted.train))
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, port, jax_train, device_cache=True, steps_per_dispatch=k)
    assert steps == len(want_loss) == 3
    assert profiling.counters("cache.") == {"build": 1, "gather": 3}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_base_model_epoch_matches_jax(tmp_path, monkeypatch, pinned):
    """One epoch of ``base_model --device_cache`` (the fused semi-hard
    step) against the JAX trainer: loss trace rtol 1e-4, val mAP atol
    1e-3."""
    JaxCachedDraws(key_chain(TrainConfig().seed, 0)).patch(monkeypatch)
    (got_loss, got_map), (want_loss, want_map), steps = _one_epoch_pair(
        tmp_path, base_model.train, jax_base_model.train,
        triplet_select="facenet", device_cache=True, **TRIPLETS)
    assert steps == len(want_loss) == 3
    assert all(np.isfinite(got_loss)) and any(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_flagship_epoch_matches_jax(tmp_path, monkeypatch, pinned):
    """One epoch of ``multimodal_model --device_mining --device_cache
    --steps_per_dispatch 2`` against the JAX trainer from the same initial
    variables: the loss trace rtol 1e-4, the triplet, hard and structure
    counts equal, val mAP atol 1e-3."""
    kw = dict(MM, **CONV, DATA_ROOT=mm_data(tmp_path),
              feat="resnet,sensors,segment", device_cache=True,
              steps_per_dispatch=2)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    branches = ("sensors", "segment")
    keys = key_chain(jcfg.seed, 0)
    params = _jax_params(jcfg, [next(keys) for _ in range(5)], branches)
    frozen = tuple(f"{b}/encoder" for b in BRANCHES)
    jcfg.model_path = str(tmp_path / "init.msgpack")
    save_pytree(jcfg.model_path, TrainState.create(
        jax.tree.map(jnp.asarray, params), jax_build_optimizer(
            jcfg.optimizer, jcfg.learning_rate, frozen_scopes=frozen)))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, _port_model(pcfg, params, branches),
                    None, 0)

    JaxCachedDraws(key_chain(jcfg.seed, 5), (0, 1, 2), ways=3).patch(
        monkeypatch)
    _, _, jax_dir = jax_mm.train(jcfg, device_mining=True,
                                 event_budget=BUDGET,
                                 result_dir=str(tmp_path / "jax"))
    res = multimodal_model.train(pcfg, device_mining=True,
                                 event_budget=BUDGET,
                                 result_dir=str(tmp_path / "port"),
                                 device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "loss")) == 3
    np.testing.assert_allclose(_column(got, "loss"), _column(want, "loss"),
                               rtol=1e-4)
    for key in ("triplet_count", "hard_count", "struct_count"):
        assert _column(got, key) == _column(want, key), key
    assert sum(_column(got, "hard_count")) > 0
    assert sum(_column(got, "struct_count")) > 0
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)


def test_cross_prediction_epoch_matches_jax(tmp_path, monkeypatch, pinned):
    """One epoch of ``cross_prediction --device_cache`` (the video's TSN
    segments, the sensors window mean-pooled on the device as the target)
    against the JAX trainer from its initial draws (``encoder``, ``head``):
    the loss and MSE traces and ``train_mse`` (read back from the last
    cached step) within rtol 1e-4; the cache gathered once a step."""
    monkeypatch.setattr(jax_cross, "dequant_features", rounded_dequant)
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8),
                                         "sensors": (8,)}, seed=0)
    kw = dict(CONV_SMALL, feat="resnet,sensors", DATA_ROOT=root,
              sess_per_batch=1, max_epochs=1, log_flush_every=1,
              device_cache=True)
    jcfg, pcfg = _cfg(JaxTrainConfig, **kw), _cfg(TrainConfig, **kw)
    keys = key_chain(jcfg.seed, 0)
    params = {"encoder": jax_build("convrtsn", **SMALL).init(
                  next(keys), jnp.zeros((2, 3, 2, 2, 8)))["params"],
              "head": JaxOutputLayer(n_output=8).init(
                  next(keys), jnp.zeros((2, 16)))["params"]}
    model = cross_prediction.build_model(pcfg, torch.device("cpu"), 8)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model, None, 0)

    JaxCachedDraws(key_chain(jcfg.seed, 2)).patch(monkeypatch)
    _, jmetrics, jax_dir = jax_cross.train(jcfg, event_budget=BUDGET,
                                           result_dir=str(tmp_path / "jax"))
    device_cache.reset_counts()
    res = cross_prediction.train(pcfg, event_budget=BUDGET,
                                 result_dir=str(tmp_path / "port"),
                                 device="cpu")
    got, want = _records(res.result_dir), _records(jax_dir)
    assert res.step == len(_column(want, "mse")) == 3
    assert profiling.counters("cache.") == {"build": 1, "gather": 3}
    for key in ("loss", "mse"):
        assert all(np.isfinite(_column(got, key)))
        np.testing.assert_allclose(_column(got, key), _column(want, key),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(res.metrics["train_mse"],
                               jmetrics["train_mse"], rtol=1e-4)
    assert res.metrics["train_mse"] > 0


# trainer -> (module, extra config, the loss key its steps log); each runs
# one epoch with --device_cache on the CPU
OTHER_TRAINERS = {
    "base_model_lifted": (base_model_lifted, dict(CONV_SMALL), "loss"),
    "pddm_model": (pddm_model, dict(CONV_SMALL, **TRIPLETS), "pddm_loss"),
    "multitask_model": (multitask_model, dict(CONV_SMALL, **TRIPLETS,
                                              lambda_ver=0.5), "ver_loss"),
    "unimodal_pretrain_sae": (unimodal_pretrain_sae, dict(
        network="rtsn", feat="sensors", n_input=8, num_seg=3, emb_dim=16),
        "mse"),
    "cross_prediction": (cross_prediction, dict(
        CONV_SMALL, feat="resnet,sensors"), "mse"),
}


@pytest.mark.parametrize("name", list(OTHER_TRAINERS))
def test_other_trainers_run_cached(tmp_path, name):
    """One epoch of each other trainer with --device_cache and
    --steps_per_dispatch 2 on the CPU: finite losses, every step gathered
    from a cache built once, the epoch metric logged."""
    module, extra, key = OTHER_TRAINERS[name]
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8),
                                         "sensors": (8,)}, seed=0)
    cfg = _cfg(TrainConfig, **dict(
        extra, DATA_ROOT=root, sess_per_batch=1, max_epochs=1,
        log_flush_every=1, device_cache=True, steps_per_dispatch=2))
    device_cache.reset_counts()
    res = module.train(cfg, event_budget=BUDGET,
                       result_dir=str(tmp_path / "run"), device="cpu")
    recs = _records(res.result_dir)
    losses = _column(recs, key)
    assert res.step == len(losses) == 3
    assert all(np.isfinite(losses))
    assert profiling.counters("cache.") == {"build": 1, "gather": 3}
    assert all(np.isfinite(v) for v in res.metrics.values())


def test_cli_trains_cached_on_cpu(tmp_path):
    """``python -m ...base_model_batchhard --device_cache
    --steps_per_dispatch 2 --device cpu`` trains an epoch and logs finite
    losses and a val mAP."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    args = ["--device", "cpu", "--DATA_ROOT", root, "--name", "cli",
            "--network", "convrtsn", "--feat", "resnet", "--num_seg", "3",
            "--emb_dim", "16", "--n_input", "8", "--n_h", "2", "--n_w", "2",
            "--n_C", "4", "--batch_size", "32", "--event_per_batch", "48",
            "--sess_per_batch", "1", "--max_epochs", "1", "--silent_mode",
            "--device_cache", "--steps_per_dispatch", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-m",
                    "multimodal_similarity_tpu_torch.train.trainers."
                    "base_model_batchhard", *args],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    (run_dir,) = list((tmp_path / "data" / "results").iterdir())
    recs = _records(str(run_dir))
    assert len(_column(recs, "loss")) == 3
    assert all(np.isfinite(_column(recs, "loss")))
    assert np.isfinite(_column(recs, "val_mAP")).all()


def test_cache_option_errors(tmp_path):
    """The reference's ValueErrors: --device_cache without the fused step
    (base_model's host miners, the flagship without --device_mining), with
    --bf16_features; D5 on a trainer without a cached feed; a
    session-sharded (--multihost) experiment's cache without the trainer's
    mesh.  Given a one-rank mesh, ``build_cache`` builds over it: the
    plans of a cache without one."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8),
                                         "sensors": (8,)}, seed=0)

    def cfg(**kw):
        return _cfg(TrainConfig, DATA_ROOT=root, sess_per_batch=1,
                    device_cache=True, **kw)

    with pytest.raises(ValueError, match="requires --triplet_select facenet"):
        base_model.train(cfg(triplet_select="random"), device="cpu")
    with pytest.raises(ValueError, match="requires --device_mining"):
        multimodal_model.train(cfg(feat="resnet,sensors,segment"),
                               device="cpu")
    with pytest.raises(ValueError, match="excludes --bf16_features"):
        base_model_batchhard.train(cfg(bf16_features=True), device="cpu")
    with pytest.raises(ValueError, match="pairsim_model has no cached feed"):
        pairsim_model.train(cfg(), device="cpu")
    from multimodal_similarity_tpu_torch.train.trainers._honda import (
        HondaExperiment)
    from multimodal_similarity_tpu_torch.parallel import create_mesh
    from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
    sharded = HondaExperiment(
        cfg(), result_dir=str(tmp_path / "mh"), session_shard=True,
        mesh=ProcessMesh(2, 0, None, torch.device("cpu")))
    try:
        with pytest.raises(ValueError, match="needs the trainer's global "
                           "mesh"):
            sharded.build_cache("cpu")
    finally:
        sharded.close()
    exp = HondaExperiment(cfg(), result_dir=str(tmp_path / "e"))
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = create_mesh(1)
        on_mesh = exp.build_cache("cpu", mesh=mesh)
        assert on_mesh.mesh is mesh and on_mesh.n_shards == 1
        alone = exp.build_cache("cpu")
        assert alone.mesh is None
        for a, b in zip(on_mesh.epoch_plans(), alone.epoch_plans()):
            np.testing.assert_array_equal(a["packed"], b["packed"])
    finally:
        torch.distributed.destroy_process_group()
        exp.close()
