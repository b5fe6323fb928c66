"""The port's device feature cache on a process mesh
(``DeviceFeatureCache.build(mesh=...)``) and the cached steps on it,
against the JAX package's cache on ``create_mesh(n)`` of the suite's
virtual devices.

The build and the gather without ``rows`` use no collective (each rank
stages and gathers its own shard), so their parity runs in this process,
one build per rank under a ``ProcessMesh`` of that rank.  The cached steps
run on 2 gloo ranks as subprocesses (``test_torch_parallel.run_ranks``);
their uniform and Gumbel draws are the JAX steps', computed here and
replayed in the ranks from files (``REPLAY``).  ConvRTSN 2x2x8, emb_dim
16, budget 48, dropout off; the JAX int8 dequantization pinned to its
stated bf16 rounding (ROADMAP D1).  Tolerances at each assertion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_base_model import rounded_dequant
from test_torch_parallel import _init_params, rank_array, run_ranks
from test_torch_trainer import SMALL

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import device_cache as jdc
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.data.datasets import (
    prepare_multimodal_dataset)
from multimodal_similarity_tpu.ops.mining import select_batch_balanced
from multimodal_similarity_tpu.parallel import create_mesh as jax_mesh
from multimodal_similarity_tpu.train import cached_steps as jcs
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import (
    base_model_batchhard as jax_bh)
from multimodal_similarity_tpu_torch.convert import flax_to_state_dict
from multimodal_similarity_tpu_torch.data import device_cache, tsn
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh

N_SEG, BUDGET, SEED = 3, 48, 1
MODALITIES = ["resnet", "sensors"]
CPU = torch.device("cpu")

# rank-side replay of draws written by the test process: call j of the
# TSN uniforms reads draws/u<j>_*.npy, of the semi-hard Gumbels
# draws/g<j>_*.npy, of the structure Gumbels draws/s<j>_*.npy
REPLAY = """
import glob
from multimodal_similarity_tpu_torch.data import tsn as _tsn
from multimodal_similarity_tpu_torch.ops import mining as _mining
_calls = {"u": 0, "g": 0, "s": 0}


def _load(kind):
    j = _calls[kind]
    _calls[kind] += 1
    files = sorted(glob.glob(os.path.join(IN, "draws", f"{kind}{j:03d}_*")))
    assert files, (kind, j)
    return [torch.from_numpy(np.load(f)) for f in files]


_tsn.draw_tsn_uniforms = lambda gen, b, n_seg, device: _load("u")[0]
_mining._draw_gumbels = lambda p, n, r, gen, device: (
    lambda d: (d[0], d[1], d[2:]))(_load("g"))
_mining._draw_structure_gumbels = lambda h, s, n, gen, device: tuple(
    _load("s"))
"""


def write_draws(tmp_path, kind, j, arrays):
    """Call ``j``'s draws of ``kind`` ("u", "g" or "s") for ``REPLAY``."""
    d = tmp_path / "in" / "draws"
    d.mkdir(parents=True, exist_ok=True)
    for i, a in enumerate(arrays):
        np.save(d / f"{kind}{j:03d}_{i:02d}.npy", np.asarray(a))


def mesh_uniforms(k_gather, n_shards, per, m):
    """The JAX mesh gather's uniforms of TSN modality ``m`` for the whole
    batch: shard s draws uniform(fold_in(fold_in(k_gather, s), m)) for its
    ``per`` rows."""
    return np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(k_gather, s), m),
        (per, N_SEG))) for s in range(n_shards)])


def semihard_gumbels(k_mine, num_pairs, n, num_negative):
    """The JAX semi-hard miner's Gumbel arrays for ``k_mine``."""
    k_a, k_p, k_n = jax.random.split(k_mine, 3)
    return [np.asarray(jax.random.gumbel(k, (num_pairs, n), jnp.float32))
            for k in [k_a, k_p] + list(jax.random.split(k_n, num_negative))]


def rank_mesh(n, r):
    """Rank r's mesh of n processes, for a build or gather that runs no
    collective."""
    return ProcessMesh(n, r, None, CPU)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Five train sessions of two modalities (events of 4-39 frames)."""
    root = str(tmp_path_factory.mktemp("meshcache"))
    generate_synthetic_honda(
        root, n_sessions=7, frames_per_session=260,
        modal_dims={"resnet": (2, 2, 8), "sensors": (8,)}, seed=3,
        splits=(0.75, 0.15), length_range=(4, 40))
    cfg = JaxTrainConfig(DATA_ROOT=root).resolve()
    rows = prepare_multimodal_dataset(cfg.feature_root, cfg.train_session,
                                      MODALITIES, cfg.label_root, "goal")
    assert len(rows) == 5
    return rows


KW = dict(n_seg=N_SEG, sess_per_batch=2, event_budget=BUDGET, seed=SEED,
          verbose=False)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_shards_match_jax_mesh_cache(dataset, n):
    """Each rank's resident q, scale and seq_len equal its rows of the JAX
    cache on ``create_mesh(n)`` bit for bit; the label table (whole on
    every rank), the layout and two epochs of plans (packed, labels, mask)
    equal the JAX cache's."""
    want = jdc.DeviceFeatureCache.build(dataset, mesh=jax_mesh(n), **KW)
    w_plans = [list(want.epoch_plans()) for _ in range(2)]
    for r in range(n):
        got = device_cache.DeviceFeatureCache.build(
            dataset, device="cpu", mesh=rank_mesh(n, r), **KW)
        assert (got.shard_rows, got.max_frames, got.sess_per_batch,
                got.batches_per_epoch) == (
            want.shard_rows, want.max_frames, want.sess_per_batch,
            want.batches_per_epoch)
        rows = slice(r * got.shard_rows, (r + 1) * got.shard_rows)
        np.testing.assert_array_equal(got.label_dev.numpy(),
                                      np.asarray(want.label_dev))
        np.testing.assert_array_equal(got.seq_len.numpy(),
                                      np.asarray(want.seq_len)[rows])
        for m in range(len(MODALITIES)):
            for name in ("q", "scale"):
                np.testing.assert_array_equal(
                    getattr(got, name)[m].numpy(),
                    np.asarray(getattr(want, name)[m])[rows],
                    err_msg=f"{name}{m} rank {r}")
        for epoch in w_plans:
            for a, b in zip(got.epoch_plans(), epoch):
                np.testing.assert_array_equal(a["packed"],
                                              b["packed"].reshape(-1))
                for key in ("labels_host", "mask_host"):
                    np.testing.assert_array_equal(a[key], b[key])
                assert a["num_events"] == b["num_events"]


@pytest.mark.parametrize("n", [2, 4])
def test_rank_gathers_match_jax(dataset, monkeypatch, n):
    """One plan gathered by each rank under the JAX mesh gather's fold
    chain (the uniforms of shard s and modality m from
    fold_in(fold_in(key, s), m), drawn for the whole batch): the rank's
    rows of both TSN modalities bit-equal to the JAX gather's, the labels
    and mask equal to its whole batch's."""
    want = jdc.DeviceFeatureCache.build(dataset, mesh=jax_mesh(n), **KW)
    plan = next(want.epoch_plans())
    key = jax.random.PRNGKey(21)
    mods, w_lab, w_mask = want._gather(
        key, plan["packed"], want.seq_len, want.label_dev,
        *[a for m in range(2) for a in (want.q[m], want.scale[m])])
    per = BUDGET // n
    for r in range(n):
        got = device_cache.DeviceFeatureCache.build(
            dataset, device="cpu", mesh=rank_mesh(n, r), **KW)
        pending = [mesh_uniforms(key, n, per, m) for m in range(2)]
        monkeypatch.setattr(tsn, "draw_tsn_uniforms", lambda g, b, s, d: (
            torch.from_numpy(pending.pop(0))))
        out, lab, mask = got.gather(
            torch.from_numpy(next(got.epoch_plans())["packed"]), None)
        rows = slice(r * per, (r + 1) * per)
        for m in range(2):
            for name in ("q", "scale"):
                np.testing.assert_array_equal(
                    out[m][name].numpy(), np.asarray(mods[m][name])[rows],
                    err_msg=f"{name}{m} rank {r}")
        np.testing.assert_array_equal(lab.numpy(), np.asarray(w_lab))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(w_mask))


def test_budget_gate_and_thin_meshes(dataset, capsys):
    """The estimate at n shards equals JAX's (max-padded shards); the gate
    takes the worst rank's share of it: a budget of exactly that share
    builds, one byte less declines with the notice; fewer sessions than
    shards decline with JAX's notice."""
    for n in (2, 4):
        est = device_cache.estimate_cache_bytes(dataset, n_shards=n)
        assert est == jdc.estimate_cache_bytes(dataset, n_shards=n)
        assert est > device_cache.estimate_cache_bytes(dataset) or n == 1
        for r in range(n):
            kw = dict(KW, verbose=True)
            built = device_cache.DeviceFeatureCache.build(
                dataset, device="cpu", mesh=rank_mesh(n, r),
                budget_bytes=est // n, **dict(kw, verbose=False))
            assert built is not None
            assert device_cache.DeviceFeatureCache.build(
                dataset, device="cpu", mesh=rank_mesh(n, r),
                budget_bytes=est // n - 1, **kw) is None
            assert "estimated the largest host share of" in \
                capsys.readouterr().out
    kw = dict(KW, verbose=True)
    assert jdc.DeviceFeatureCache.build(dataset[:3], mesh=jax_mesh(4),
                                        **kw) is None
    want = capsys.readouterr().out.splitlines()[-1]
    assert device_cache.DeviceFeatureCache.build(
        dataset[:3], device="cpu", mesh=rank_mesh(4, 1), **kw) is None
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert "3 sessions < 4 shards" in want


# -- the cached steps at 2 ranks ----------------------------------------------

LR, BATCH, STEPS = 0.01, 32, 2
# one session a batch: the 2-rank cache's shards hold 3 and 2 sessions,
# two batches an epoch
STEP_KW = dict(KW, sess_per_batch=1)
TRIPLETS = dict(triplet_per_batch=12, num_negative=3, alpha=0.2)

_STEP_BODY = REPLAY + """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.data.device_cache import (
    DeviceFeatureCache)
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.parallel import create_mesh
from multimodal_similarity_tpu_torch.train import cached_steps
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model_batchhard)
spec = json.load(open(os.path.join(IN, "spec.json")))
mesh = create_mesh(SIZE)
cache = DeviceFeatureCache.build(spec["dataset"], device="cpu", mesh=mesh,
                                 **spec["cache"])
model = build_encoder("convrtsn", **spec["small"])
opt = build_optimizer("ADAM", model, spec["lr"])
load_checkpoint(os.path.join(IN, "init.pt"), model, opt)
cfg = TrainConfig(**spec["cfg"]).resolve()
if spec["kind"] == "base_model":
    step = cached_steps.make_cached_triplet_step(model, opt, cache,
                                                 **spec["triplets"])
else:
    step = base_model_batchhard.make_cached_balanced_step(
        model, opt, cfg, cache, None, spec["kind"])
for j, plan in zip(range(spec["steps"]), cache.epoch_plans()):
    packed = plan["packed"]
    if spec["kind"] != "base_model":
        rows = np.load(os.path.join(IN, f"rows{j}.npy"))
        packed = np.concatenate([packed, rows]).astype(np.int32)
    aux = step(torch.from_numpy(packed), spec["lr"])
    save(f"loss{j}", aux["loss"][None])
np.savez(os.path.join(OUT, f"params_{RANK}.npz"),
         **{k: v.numpy() for k, v in model.state_dict().items()})
"""


@pytest.mark.parametrize("kind", ["batchhard", "lifted", "base_model"])
def test_cached_steps_two_ranks_match_jax(dataset, tmp_path, monkeypatch,
                                          kind):
    """Two fused cached steps at 2 ranks over the mesh cache against the
    JAX steps over its cache on ``create_mesh(2)``, from the same params
    under the same draws: the batch-hard and lifted balanced steps (each
    rank gathers its row block, receives its share of the balanced rows in
    one all-to-all, and trains on the f32 ring) and base_model's
    data-parallel semi-hard step.  The loss of each step within rtol 1e-5
    on both ranks, every parameter within atol 1e-5 after the two
    steps."""
    import json
    for mod in (jax_steps, jcs):
        monkeypatch.setattr(mod, "dequant_features", rounded_dequant)
    resnet = [[row[0], row[-1]] for row in dataset]
    jm, params, tm = _init_params(tmp_path, LR)
    jcfg = JaxTrainConfig(
        name="t", network="convrtsn", feat="resnet", learning_rate=LR,
        keep_prob=1.0, lambda_l2=0.0, batch_size=BATCH, **SMALL).resolve()
    jcache = jdc.DeviceFeatureCache.build(resnet, mesh=jax_mesh(2),
                                          **STEP_KW)
    ops = jcache.step_operands()
    if kind == "base_model":
        fused = jcs.make_cached_triplet_step(jm, jcache, **TRIPLETS)
    else:
        fused = jax_bh.make_balanced_batch_step(jm, jcfg, kind,
                                                mesh=jax_mesh(2),
                                                cache=jcache)
    state = TrainState.create(params, jax_build_optimizer("ADAM", LR))
    per = BUDGET // 2
    want = []
    keys = jax.random.split(jax.random.PRNGKey(13), STEPS)
    for j, (plan, key) in enumerate(zip(jcache.epoch_plans(), keys)):
        k_gather, k_rest = jax.random.split(key)
        write_draws(tmp_path, "u", j, [mesh_uniforms(k_gather, 2, per, 0)])
        if kind == "base_model":
            write_draws(tmp_path, "g", j, semihard_gumbels(
                jax.random.split(k_rest)[0],
                -(-TRIPLETS["triplet_per_batch"] // 3), BUDGET, 3))
            state, aux = fused(state, plan["packed"], key, jnp.float32(LR),
                               *ops)
        else:
            valid = np.where(plan["mask_host"] > 0)[0]
            rows = valid[select_batch_balanced(
                plan["labels_host"][valid], BATCH,
                rng=__import__("random").Random(j))].astype(np.int32)
            assert rows.size == BATCH
            np.save(tmp_path / "in" / f"rows{j}.npy", rows)
            state, aux = fused(state, plan["packed"], rows,
                               plan["labels_host"][rows], key,
                               jnp.float32(LR), *ops)
        want.append(float(aux["loss"]))
    assert all(np.isfinite(want)) and any(want)
    spec = {"dataset": resnet, "kind": kind, "lr": LR, "steps": STEPS,
            "small": SMALL, "triplets": TRIPLETS,
            "cache": STEP_KW,
            "cfg": dict(name="t", network="convrtsn", feat="resnet",
                        learning_rate=LR, keep_prob=1.0, lambda_l2=0.0,
                        batch_size=BATCH, silent_mode=True, **SMALL)}
    with open(tmp_path / "in" / "spec.json", "w") as f:
        json.dump(spec, f)
    run_ranks(tmp_path, 2, _STEP_BODY, "st")
    ref = flax_to_state_dict(jax.tree.map(np.asarray, state.params),
                             build_encoder("convrtsn", **SMALL))
    for r in range(2):
        got = [float(rank_array(tmp_path, "st", f"loss{j}", r)[0])
               for j in range(STEPS)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        params_r = np.load(tmp_path / "out_st" / f"params_{r}.npz")
        for name, w in ref.items():
            np.testing.assert_allclose(params_r[name], w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
