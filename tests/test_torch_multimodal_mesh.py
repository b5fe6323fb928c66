"""The port's flagship on a process mesh against the JAX package's on
``create_mesh(2)`` of the suite's virtual devices: the data-parallel fused
step (``make_mm_fused_step(mesh=, gather_smalls=)``), ``multimodal_model
--device_mining`` under a 2-process launch, ``--multihost`` with its
per-rank loaders, and the cached flagship over the mesh cache.

Ranks run as gloo subprocesses (``test_torch_parallel.run_ranks``) and
never import JAX; their semi-hard, structure and TSN draws are the JAX
steps', computed here and replayed from files
(``test_torch_mesh_cache.REPLAY``).  Small sizes (budget 48, ConvRTSN 2 x
2 x 8, emb_dim 16), dropout off, PDDM heads scaled so that the hard and
structure miners fire.  Tolerances at each assertion."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh_cache import (
    REPLAY, mesh_uniforms, semihard_gumbels, write_draws)
from test_torch_multimodal import (
    BRANCHES, CONV, DIMS, MM, _column, _data, _jax_params, _port_model,
    _records, jax_structure_draws)
from test_torch_parallel import gathered, rank_array, run_ranks
from test_torch_trainer import _cfg

import multimodal_similarity_tpu.parallel as jax_parallel
from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.parallel import create_mesh as jax_mesh
from multimodal_similarity_tpu.parallel import (
    host_local_sessions as jax_host_local_sessions)
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import (
    multimodal_model as jax_mm)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import flax_to_state_dict
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint

N, LR = 48, 0.01
FEAT = "resnet,sensors,segment"
T, R = MM["triplet_per_batch"], MM["num_negative"]
FROZEN = tuple(f"{b}/encoder" for b in BRANCHES)


def _config(tmp_path, **extra):
    """The JAX config and the port's config keywords (JSON, for the
    ranks): the flagship's MM settings at CONV's widths, dropout off."""
    kw = dict(name="t", silent_mode=True, learning_rate=LR, keep_prob=1.0,
              lambda_l2=0.0, feat=FEAT, **MM, **CONV)
    kw.update(extra)
    return _cfg(JaxTrainConfig, **kw), kw


def _initial(tmp_path, jcfg, port_kw):
    """The JAX initial variables (5 init keys of ``jcfg.seed``) in a JAX
    checkpoint and a port one, both through ``--model_path``."""
    keys, rng = [], jax.random.PRNGKey(jcfg.seed)
    for _ in range(5):
        rng, k = jax.random.split(rng)
        keys.append(k)
    params = _jax_params(jcfg, keys, ("sensors", "segment"))
    jcfg.model_path = str(tmp_path / "init.msgpack")
    save_pytree(jcfg.model_path, TrainState.create(
        jax.tree.map(jnp.asarray, params), jax_build_optimizer(
            jcfg.optimizer, jcfg.learning_rate, frozen_scopes=FROZEN)))
    (tmp_path / "in").mkdir(exist_ok=True)
    pcfg = _cfg(TrainConfig, **port_kw)
    model = _port_model(pcfg, params, ("sensors", "segment"))
    port_kw["model_path"] = str(tmp_path / "in" / "init.pt")
    save_checkpoint(port_kw["model_path"], model, None, 0)
    with open(tmp_path / "in" / "cfg.json", "w") as f:
        json.dump(port_kw, f)
    return params, model


def _flagship_draws(tmp_path, key, j, n=N):
    """Step ``j``'s semi-hard and structure draws of the JAX fused step
    under ``key`` (split into k_mine, k_mul, k_drop)."""
    k_mine, k_mul, _ = jax.random.split(key, 3)
    write_draws(tmp_path, "g", j, semihard_gumbels(k_mine, -(-T // R), n,
                                                   R))
    write_draws(tmp_path, "s", j, [t.numpy() for t in jax_structure_draws(
        k_mul)(T, min(T // 2, T), n, None, "cpu")])


def _assert_params(got_npz, jax_params, model, atol=1e-5):
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax_params), model)
    for name, w in want.items():
        np.testing.assert_allclose(got_npz[name], w.numpy(), rtol=0,
                                   atol=atol, err_msg=name)


# -- the fused step ------------------------------------------------------------

_STEP_BODY = REPLAY + """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.parallel import create_mesh
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.trainers import multimodal_model
cfg = TrainConfig(**json.load(open(os.path.join(IN, "cfg.json")))).resolve()
model = multimodal_model.build_model(cfg, torch.device("cpu"), sensors=8,
                                     segment=12)
opt = multimodal_model.mm_optimizer(cfg, model)
load_checkpoint(cfg.model_path, model, None)
mesh = create_mesh(SIZE)
step = multimodal_model.make_mm_fused_step(model, opt, cfg, None, mesh=mesh,
                                           gather_smalls=SMALLS)
ev, se, sg, lab, mask, cm = (torch.from_numpy(np.load(os.path.join(IN, f)))
                             for f in ("events.npy", "sensors.npy",
                                       "segment.npy", "labels.npy",
                                       "mask.npy", "cm.npy"))
rows = mesh.rows(ev.shape[0])
if SMALLS:
    lab, mask = lab[rows], mask[rows]
for j in range(2):
    aux = step(ev[rows], se[rows], sg[rows], lab, mask, cm, 1.0, {lr})
    for key in ("loss", "triplet_count", "hard_count", "struct_count"):
        save(f"{{key}}{{j}}", aux[key].reshape(1))
np.savez(os.path.join(OUT, f"params_{{RANK}}.npz"),
         **{{k: v.numpy() for k, v in model.state_dict().items()}})
""".format(lr=LR)


@pytest.mark.parametrize("gather_smalls", [False, True],
                         ids=["torchrun", "multihost-feed"])
def test_fused_step_two_ranks_matches_jax(tmp_path, gather_smalls):
    """Two data-parallel fused flagship steps at 2 ranks (each rank its
    rows of the three modalities; labels and mask global, or under
    ``gather_smalls`` the rank's rows, gathered) against the JAX fused
    step on ``create_mesh(2)`` from the same params under the same draws,
    with an L2 term: the loss of each step within rtol 1e-5 and the
    triplet, hard and structure counts equal on both ranks; every
    parameter within atol 1e-5 after the two steps."""
    jcfg, port_kw = _config(tmp_path, lambda_l2=1e-3)
    params, model = _initial(tmp_path, jcfg, port_kw)
    rng = np.random.RandomState(4)
    inputs = {
        "events": rng.randn(N, 3, *DIMS["resnet"]).astype(np.float32),
        "sensors": rng.randn(N, 3, *DIMS["sensors"]).astype(np.float32),
        "segment": rng.randn(N, 3, *DIMS["segment"]).astype(np.float32),
        "labels": rng.randint(0, 7, size=N).astype(np.int32),
        "mask": (np.arange(N) < N - 4).astype(np.float32),
        "cm": rng.rand(7).astype(np.float32)}
    for name, a in inputs.items():
        np.save(tmp_path / "in" / f"{name}.npy", a)
    keys = jax.random.split(jax.random.PRNGKey(17), 2)
    for j, key in enumerate(keys):
        _flagship_draws(tmp_path, key, j)
    run_ranks(tmp_path, 2, f"SMALLS = {gather_smalls}\n" + _STEP_BODY,
              "fs")

    core, se, sp, ge, gp = jax_mm.build_models(jcfg, sensors_dim=8,
                                               segment_dim=12)
    fused = jax_mm.make_mm_fused_step(core, se, sp, ge, gp, jcfg,
                                      mesh=jax_mesh(2),
                                      gather_smalls=gather_smalls)
    state = TrainState.create(jax.tree.map(jnp.asarray, params),
                              jax_build_optimizer("ADAM", LR,
                                                  frozen_scopes=FROZEN))
    want = []
    for key in keys:
        state, aux = fused(state, *(jnp.asarray(inputs[k]) for k in (
            "events", "sensors", "segment", "labels", "mask", "cm")),
            jnp.float32(1.0), key, jnp.float32(LR))
        want.append({k: float(aux[k]) for k in (
            "loss", "triplet_count", "hard_count", "struct_count")})
    assert want[0]["hard_count"] > 0 and want[0]["struct_count"] > 0
    for r in range(2):
        for j, w in enumerate(want):
            np.testing.assert_allclose(
                rank_array(tmp_path, "fs", f"loss{j}", r), [w["loss"]],
                rtol=1e-5)
            for key in ("triplet_count", "hard_count", "struct_count"):
                assert float(rank_array(tmp_path, "fs", f"{key}{j}",
                                        r)[0]) == w[key], key
        _assert_params(np.load(tmp_path / "out_fs" / f"params_{r}.npz"),
                       state.params, model)


# -- the trainer at 2 ranks ----------------------------------------------------

_TRAIN_BODY = REPLAY + """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import multimodal_model
cfg = TrainConfig(**json.load(open(os.path.join(IN, "cfg.json")))).resolve()
res = multimodal_model.train(cfg, device_mining=True, event_budget=48,
                             result_dir=os.path.join(OUT, "port"),
                             device="cpu")
print("STEPS", res.step)
"""


def _trainer_draws(tmp_path, seed, steps, cached, n_modalities=3):
    """The JAX flagship trainer's step keys (5 init splits of
    PRNGKey(seed), then one split a step) as replayed draws: a streamed
    step's key splits into (k_mine, k_mul, k_drop); a cached step's into
    (k_gather, k_rest), the gather's uniforms from the mesh fold chain of
    k_gather and the body's draws from k_rest."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(5):
        rng, _ = jax.random.split(rng)
    for j in range(steps):
        rng, key = jax.random.split(rng)
        if cached:
            k_gather, key = jax.random.split(key)
            for m in range(n_modalities):
                write_draws(tmp_path, "u", j * n_modalities + m,
                            [mesh_uniforms(k_gather, 2, N // 2, m)])
        _flagship_draws(tmp_path, key, j)


@pytest.mark.parametrize("cached", [False, True], ids=["streamed", "cached"])
def test_trainer_two_ranks_matches_jax(tmp_path, monkeypatch, cached):
    """One epoch of ``multimodal_model --device_mining`` at 2 ranks (the
    global batch's rows a rank), streamed or with ``--device_cache
    --steps_per_dispatch 2`` over the mesh cache, against the JAX trainer
    with ``auto_mesh`` patched to ``create_mesh(2)`` from the same initial
    variables under the same draws: the loss trace within rtol 1e-5, the
    triplet, hard and structure counts equal, val mAP within atol 1e-3,
    rank 1's trace equal to rank 0's; rank 0 alone writes the
    checkpoint."""
    extra = (dict(device_cache=True, steps_per_dispatch=2) if cached
             else {})
    if cached:
        # eight sessions: each of the cache's two shards holds two
        # batches, one --steps_per_dispatch 2 window
        root = str(tmp_path / "data")
        generate_synthetic_honda(root, n_sessions=8, frames_per_session=300,
                                 modal_dims=DIMS, seed=0,
                                 length_range=(4, 16))
    else:
        root = _data(tmp_path)
    jcfg, port_kw = _config(tmp_path, DATA_ROOT=root, **extra)
    _initial(tmp_path, jcfg, port_kw)
    _trainer_draws(tmp_path, jcfg.seed, 4, cached)
    texts = run_ranks(tmp_path, 2, _TRAIN_BODY, "tr")
    monkeypatch.setattr(jax_parallel, "auto_mesh", lambda b, verbose=True: (
        jax_mesh(2), -(-b // 2) * 2))
    _, _, jax_dir = jax_mm.train(jcfg, device_mining=True, event_budget=N,
                                 result_dir=str(tmp_path / "jax"))
    got = _records(str(tmp_path / "out_tr" / "port"))
    want = _records(jax_dir)
    assert len(_column(got, "loss")) == len(_column(want, "loss")) == (
        2 if cached else 3), (texts, len(_column(want, "loss")))
    np.testing.assert_allclose(_column(got, "loss"), _column(want, "loss"),
                               rtol=1e-5)
    for key in ("triplet_count", "hard_count", "struct_count"):
        assert _column(got, key) == _column(want, key), key
    assert sum(_column(got, "hard_count")) > 0
    np.testing.assert_allclose(_column(got, "val_mAP"),
                               _column(want, "val_mAP"), atol=1e-3)
    rank1 = _records(str(tmp_path / "out_tr" / "port_proc1"))
    assert _column(rank1, "loss") == _column(got, "loss")
    assert glob.glob(str(tmp_path / "out_tr" / "port" / "t.ckpt-*"))
    assert not glob.glob(str(tmp_path / "out_tr" / "port_proc1" / "*ckpt*"))


# -- --multihost ---------------------------------------------------------------

_MULTIHOST_BODY = REPLAY + """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import multimodal_model
seen = {}
Exp = multimodal_model.HondaExperiment


class Recorded(Exp):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        seen["exp"] = self


real = multimodal_model.make_mm_fused_step


def recorded(*a, **k):
    step = real(*a, **k)

    def run(*args):
        aux = step(*args)
        if "loss" not in seen:
            seen["loss"] = aux["loss"]
            for name, t in zip(("events", "sensors", "segment", "labels",
                                "mask", "cm"), args):
                save(name, t)
            save("use_mm", np.asarray([args[6]], np.float32))
            save("loss", aux["loss"][None])
        return aux
    return run


multimodal_model.HondaExperiment = Recorded
multimodal_model.make_mm_fused_step = recorded
kw = json.load(open(os.path.join(IN, "cfg.json")))
# the trainer starts the group from the explicit coordinator flags
kw.update(coordinator_address=PG, num_processes=SIZE, process_id=RANK)
res = multimodal_model.train(TrainConfig(**kw).resolve(), device_mining=True,
                             event_budget=48,
                             result_dir=os.path.join(OUT, "port"),
                             device="cpu")
exp = seen["exp"]
with open(os.path.join(OUT, f"sessions_{RANK}.json"), "w") as f:
    json.dump({"local": [r[0] for r in exp.local_set],
               "batches": exp.batch_per_epoch, "steps": res.step}, f)
"""


def test_multihost_two_ranks_matches_jax(tmp_path):
    """``multimodal_model --device_mining --multihost --coordinator_address
    file://... --num_processes 2 --process_id r`` at 2 ranks: each rank's
    session shard and the lockstep batch count are JAX's
    (``host_local_sessions``, ``(len(train_set) // 2) // sess_per_batch``),
    each rank's loader fills its half of the budget; the first step's loss
    equals the JAX fused step's (``gather_smalls``) on ``create_mesh(2)``
    over the rank-ordered concatenation of the two ranks' batches (JAX's
    ``make_global_batch``) from the same params under the same draws
    (rtol 1e-5); rank 0 alone writes the checkpoint."""
    jcfg, port_kw = _config(tmp_path, DATA_ROOT=_data(tmp_path),
                            multihost=True)
    params, _ = _initial(tmp_path, jcfg, port_kw)
    keys = jax.random.split(jax.random.PRNGKey(23), 3)
    for j, key in enumerate(keys):
        _flagship_draws(tmp_path, key, j)
    run_ranks(tmp_path, 2, _MULTIHOST_BODY, "mh", init=False)

    exp_rows = jax_mm.HondaExperiment(
        jcfg, modalities=FEAT.split(","), event_budget=N,
        result_dir=str(tmp_path / "rows"),
        limit_label_num=(jcfg.task == "supervised"))
    train_set = exp_rows.train_set
    exp_rows.close()
    for r in range(2):
        with open(tmp_path / "out_mh" / f"sessions_{r}.json") as f:
            rec = json.load(f)
        assert rec["local"] == [row[0] for row in
                                jax_host_local_sessions(train_set, r, 2)]
        assert rec["batches"] == (len(train_set) // 2) // jcfg.sess_per_batch
        assert rec["steps"] == rec["batches"]
    batch = [gathered(tmp_path, "mh", name, 2) for name in (
        "events", "sensors", "segment", "labels", "mask")]
    assert batch[0].shape[0] == N
    cm = rank_array(tmp_path, "mh", "cm", 0)
    np.testing.assert_array_equal(rank_array(tmp_path, "mh", "cm", 1), cm)
    core, se, sp, ge, gp = jax_mm.build_models(jcfg, sensors_dim=8,
                                               segment_dim=12)
    fused = jax_mm.make_mm_fused_step(core, se, sp, ge, gp, jcfg,
                                      mesh=jax_mesh(2), gather_smalls=True)
    state = TrainState.create(jax.tree.map(jnp.asarray, params),
                              jax_build_optimizer("ADAM", LR,
                                                  frozen_scopes=FROZEN))
    _, aux = fused(state, *(jnp.asarray(a) for a in batch), jnp.asarray(cm),
                   jnp.float32(rank_array(tmp_path, "mh", "use_mm", 0)[0]),
                   keys[0], jnp.float32(LR))
    for r in range(2):
        np.testing.assert_allclose(rank_array(tmp_path, "mh", "loss", r),
                                   [float(aux["loss"])], rtol=1e-5)
    assert glob.glob(str(tmp_path / "out_mh" / "port" / "t.ckpt-*"))
    assert not glob.glob(str(tmp_path / "out_mh" / "port_proc1" / "*ckpt*"))
    assert os.path.isdir(tmp_path / "out_mh" / "port_proc1")


@pytest.mark.parametrize("network", ["convrtsn", "tsn"])
def test_dropout_global_rows_equal_one_device(network):
    """Inside ``Dropout.global_rows`` each rank's share of a batch draws
    the whole batch's masks and keeps its rows, so the shares' train-mode
    outputs (keep_prob 0.5, each rank's dropout generator seeded alike)
    concatenate to the one-device output, ConvRTSN's [B, S, ...] layer
    and TSN's flattened [B x S, ...] one alike; shares of ceil(B / n)
    rows, the last one short.  Within rtol 1e-5, atol 1e-6: a product's
    rounding may change with its row count, where another mask would
    move entries by their own size."""
    from multimodal_similarity_tpu_torch.models import build_encoder
    from multimodal_similarity_tpu_torch.models.encoders import Dropout
    from multimodal_similarity_tpu_torch.parallel.data_parallel import share
    dims = ((3, 2, 2, 8) if network == "convrtsn" else (3, 8))
    x = torch.from_numpy(np.random.RandomState(5).randn(
        10, *dims).astype(np.float32))

    def model():
        return build_encoder(network, num_seg=3, emb_dim=16, n_input=8,
                             n_h=2, n_w=2, n_C=4, keep_prob=0.5,
                             generator=torch.Generator().manual_seed(0),
                             dropout_generator=torch.Generator().manual_seed(
                                 1)).train()

    want = model()(x)
    for n in (2, 4):
        parts = []
        for r in range(n):
            rows = share(10, ProcessMeshStub(n, r))
            with Dropout.global_rows(10, rows):
                parts.append(model()(x[rows]))
        torch.testing.assert_close(torch.cat(parts), want, rtol=1e-5,
                                   atol=1e-6, msg=f"{n} shares")


class ProcessMeshStub:
    """The size and rank of a mesh, all ``share`` reads."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank
