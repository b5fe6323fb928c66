"""The port's tensor parallelism (``parallel/tensor_parallel.py``,
``--model_parallel``) against the JAX package's and against the port's
data parallelism, on the CPU over gloo.

The rule is held leaf for leaf to JAX's ``tp_sharded_leaves`` mapped
through ``convert.py``.  The rest runs in three spawns of torch ranks
(``test_torch_parallel.run_ranks``: files in and out, the ranks never
import JAX), each holding several checks:

* 2 ranks, a 1 x 2 data x model mesh: the trainers with --model_parallel
  2, a resume from a checkpoint written without it, the checkpoint round
  trip, JAX's mesh errors and the no-op error;
* 4 ranks, a 2 x 2 mesh: the trainers (the device cache with
  --steps_per_dispatch 2, and --multihost at 2 ranks a host), the
  sub-group {1, 3} running the rings and ``replicate``, and three steps of
  the data-parallel triplet step on the mesh for JAX's ``shard_state_tp``
  step;
* 2 ranks without a model axis: the same trainers at a data axis of 2, and
  the rings and ``replicate`` on the world, the references of the last.

A trainer with --model_parallel is held to the same trainer without it at
the same data axis (in this process at one, the 2-rank spawn at two), which
``tests/test_torch_parallel.py`` and ``tests/test_torch_multimodal_mesh.py``
hold to JAX: every step's loss within rtol 2e-4 / atol 2e-5 (the tolerance
of the JAX package's tests/test_tensor_parallel.py), the final parameters
within rtol 1e-4 / atol 1e-6 (f32 summation order over a few Adam steps),
and each rank's split parameters and Adam moments 1/2 of the whole.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.parallel import (
    create_2d_mesh as jax_2d_mesh,
    make_dp_triplet_step as jax_dp_step,
    shard_state_tp,
    tp_sharded_leaves as jax_sharded_leaves,
)
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import (
    multimodal_model as jax_multimodal)
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_scopes, flax_to_state_dict, torch_leaf)
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.parallel import tp_sharded_leaves
from multimodal_similarity_tpu_torch.train.checkpoints import (
    load_checkpoint, save_checkpoint)
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model, base_model_classifier, base_model_tf, cross_prediction,
    multimodal_model, multimodal_model_weak, multitask_model, pairsim_model,
    pddm_model, unimodal_pretrain_sae)
from test_torch_parallel import jax_gumbels, rank_array, run_ranks

LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
SMALL = dict(num_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2, n_C=4)


# -- the rule -----------------------------------------------------------------


def _jax_shapes(model, *inputs):
    """The flax params of ``model`` as zero arrays of their shapes (no
    compile: ``eval_shape``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["params"])


def _rtsn(emb):
    jm = jax_build("rtsn", num_seg=3, emb_dim=emb, n_input=8)
    return (_jax_shapes(jm, jnp.zeros((2, 3, 8))),
            build_encoder("rtsn", num_seg=3, emb_dim=emb, n_input=8))


def _convrtsn():
    kw = dict(num_seg=3, emb_dim=128, n_input=1536, n_h=8, n_w=8, n_C=20)
    return (_jax_shapes(jax_build("convrtsn", **kw),
                        jnp.zeros((2, 3, 8, 8, 1536))),
            build_encoder("convrtsn", **kw))


def _flagship():
    """The flagship's whole params (core, both branch encoders and PDDM
    heads) at a small width, built as the JAX trainer builds them."""
    kw = dict(name="f", network="convrtsn", feat=["resnet", "sensors",
                                                   "segment"], **SMALL)
    jcfg = JaxTrainConfig(**kw).resolve()
    core, s_enc, s_pddm, g_enc, g_pddm = jax_multimodal.build_models(
        jcfg, sensors_dim=8, segment_dim=16)
    e = jnp.zeros((2, 32))
    params = {
        "modality_core": _jax_shapes(core, jnp.zeros((2, 3, 2, 2, 8))),
        "modality_sensors": {
            "encoder": _jax_shapes(s_enc, jnp.zeros((2, 3, 8))),
            "pddm": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 jax.eval_shape(
                                     lambda k: s_pddm.init(k, e, e,
                                                           method="score"),
                                     jax.random.PRNGKey(0))["params"])},
        "modality_segment": {
            "encoder": _jax_shapes(g_enc, jnp.zeros((2, 3, 16))),
            "pddm": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 jax.eval_shape(
                                     lambda k: g_pddm.init(k, e, e,
                                                           method="score"),
                                     jax.random.PRNGKey(0))["params"])},
    }
    model = multimodal_model.build_model(
        TrainConfig(**kw).resolve(), torch.device("cpu"), sensors=8,
        segment=16)
    return params, model


def _small(network):
    """``network`` at the small width, as base_model's --network builds
    it."""
    x = jnp.zeros((2, 3) + ((8,) if network == "tsn" else (2, 2, 8)))
    return (_jax_shapes(jax_build(network, **SMALL), x),
            build_encoder(network, **SMALL))


MODELS = {"rtsn_emb32": lambda: _rtsn(32), "rtsn_emb1024": lambda: _rtsn(1024),
          "convrtsn": _convrtsn, "flagship": _flagship,
          **{n: (lambda n=n: _small(n))
             for n in ("tsn", "convtsn", "convbirtsn")}}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _jax_names(params, model, mp):
    """JAX's ``tp_sharded_leaves`` on a (8 / mp) x mp mesh, each leaf
    mapped to its torch parameter through ``convert.torch_leaf``."""
    leaves = dict(_flatten(params))
    expected = model.state_dict()
    names = set()
    for keystr, spec in jax_sharded_leaves(params, jax_2d_mesh(8, mp)):
        path = tuple(k.strip("'") for k in keystr[1:-1].split("]["))
        name, _ = torch_leaf(path, leaves[path], expected,
                             flax_scopes(model))
        names.add(name)
    return names


@pytest.mark.parametrize("mp", [2, 4, 8])
@pytest.mark.parametrize("which", list(MODELS))
def test_sharded_leaves_match_jax(which, mp):
    """The port splits exactly the leaves JAX's rule splits, each along the
    torch dim holding the flax leaf's trailing dim."""
    params, model = MODELS[which]()
    got = dict(tp_sharded_leaves(model, mp))
    assert set(got) == _jax_names(params, model, mp)
    assert got, which
    for name, dim in got.items():
        p = model.get_parameter(name)
        assert p.shape[dim] % mp == 0 and p.shape[dim] >= 2 * mp


def test_no_op_config_splits_nothing():
    """A config whose dims do not divide splits nothing, as in JAX."""
    params = {"dense": {"kernel": np.zeros((5, 3), np.float32),
                        "bias": np.zeros((3,), np.float32)}}
    assert jax_sharded_leaves(params, jax_2d_mesh(8, 2)) == []
    model = nn.Module()
    model.dense = nn.Linear(5, 3)
    assert tp_sharded_leaves(model, 2) == []


# -- the spawns ---------------------------------------------------------------

BASE = dict(silent_mode=True, learning_rate=0.01, lambda_l2=1e-3,
            log_flush_every=1, sess_per_batch=1, max_epochs=1)
RTSN = dict(network="rtsn", feat="sensors", n_input=8, emb_dim=32,
            num_seg=3, keep_prob=0.9)
RUNS = {
    "bm": ("bm", dict(RTSN, triplet_select="facenet", triplet_per_batch=12,
                      num_negative=3)),
    "bh": ("batchhard", dict(RTSN, batch_size=32)),
    "lt": ("lifted", dict(RTSN, batch_size=32)),
    "mm": ("mm", dict(network="convrtsn", feat=["resnet", "sensors",
                                                 "segment"],
                      triplet_per_batch=12, lambda_multimodal=0.5,
                      multimodal_epochs=0, label_num=3, keep_prob=0.9,
                      **SMALL)),
}
RUNS["bmc"] = ("bm", dict(RUNS["bm"][1], device_cache=True,
                          steps_per_dispatch=2, max_epochs=2))
RUNS["bmh"] = ("bm", dict(RUNS["bm"][1], multihost=True))
BUDGET = 48

# the trainer helper every rank and this process run: ``train(name, mp,
# **over)`` one run of RUNS[name] into OUT/<name>, its split bytes saved
_TRAIN = """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
    sharded_bytes)
from multimodal_similarity_tpu_torch.train.trainers import (
    base_model, base_model_batchhard, multimodal_model)
RUNS = json.load(open(os.path.join(IN, "runs.json")))


def train(name, mp, tag=None, **over):
    kind, kw = RUNS[name]
    kw = dict(kw, model_parallel=mp, **over)
    if kw.get("multihost"):
        kw.update(coordinator_address=PG, num_processes=SIZE,
                  process_id=RANK)
    cfg = TrainConfig(**kw).resolve()
    cfg.feat_dim["segment"] = (16,)
    out = os.path.join(OUT, tag or name)
    if kind == "bm":
        res = base_model.train(cfg, event_budget={budget}, result_dir=out,
                               device="cpu")
    elif kind == "mm":
        res = multimodal_model.train(cfg, device_mining=True,
                                     event_budget={budget}, result_dir=out,
                                     device="cpu")
    else:
        res = base_model_batchhard.train(cfg, loss_kind=kind,
                                         event_budget={budget},
                                         result_dir=out, device="cpu")
    if mp:
        save("bytes_" + (tag or name),
             np.array(sharded_bytes(res.model, res.optimizer)))
    return res
""".format(budget=BUDGET)

_TP12 = _TRAIN + """
import glob
import torch
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.parallel import (
    auto_mesh_tp, create_2d_mesh, gather_state_tp, shard_module_tp)
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
os.environ["LOCAL_WORLD_SIZE"] = str(SIZE)
for name in ("bm", "bh", "lt", "mm"):
    train(name, 2)
# back: a split run resumed from the checkpoint written without a model axis
train("bm", 2, tag="bm_resume", max_epochs=2,
      model_path=os.path.join(IN, "ref_bm.ckpt"))
# the split run's checkpoint: whole; loaded, split and gathered it is equal
(path,) = glob.glob(os.path.join(OUT, "bm", "*.ckpt-*"))
kw = RUNS["bm"][1]
model = build_encoder("rtsn", num_seg=3, emb_dim=kw["emb_dim"], n_input=8)
opt = build_optimizer("ADAM", model, 0.01)
load_checkpoint(path, model, opt)
shard_module_tp(model, create_2d_mesh(SIZE, 2), opt)
state, ostate = gather_state_tp(model, opt)
file = torch.load(path, weights_only=True)
same = all(torch.equal(state[k], v) for k, v in file["model"].items())
same &= state.keys() == file["model"].keys()
same &= all(torch.equal(ostate["state"][i][k], v)
            for i, e in file["optimizer"]["state"].items()
            for k, v in e.items())
save("round_trip", np.array([same]))

# the layers no trainer splits: Conv2d (column-parallel), a grouped Conv2d
# and the raw parameters of the SAE (gathered where used), against the
# unsplit module: outputs, and gradients gathered from the shards
from torch import nn
from multimodal_similarity_tpu_torch.models import SAE
from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
    _all_gather_cat, plain_name)
from multimodal_similarity_tpu_torch.train.state import l2_regularization
LAYERS = {
    "conv": lambda: nn.Sequential(nn.Conv2d(3, 8, 3), nn.ReLU(),
                                  nn.Conv2d(8, 4, 1)),
    "grouped_conv": lambda: nn.Sequential(nn.Conv2d(4, 8, 3, groups=2)),
    "sae": lambda: SAE(6, 8),
}
tp = create_2d_mesh(SIZE, 2)
for kind, make in LAYERS.items():
    torch.manual_seed(5)
    whole, split = make(), make()
    split.load_state_dict(whole.state_dict())
    x = torch.randn((5, 6) if kind == "sae" else (2, 3 + (kind != "conv"),
                                                     7, 7))
    sharded = shard_module_tp(split, tp)
    outs = []
    for m in (whole, split):
        out = m(x)
        out = out if isinstance(out, tuple) else (out,)
        (sum((o ** 2).sum() for o in out) + l2_regularization(m)).backward()
        outs.append(torch.cat([o.detach().reshape(-1) for o in out]))
    grads = {plain_name(n): (_all_gather_cat(p.grad, p.tp_shard.dim, tp.model)
                             if hasattr(p, "tp_shard") else p.grad)
             for n, p in split.named_parameters()}
    err = float((outs[0] - outs[1]).abs().max())
    gerr = max(float((grads[n] - p.grad).abs().max())
               for n, p in whole.named_parameters())
    save("layer_" + kind, np.array([len(sharded), err, gerr]))

errors = {}
try:
    auto_mesh_tp(8, 3, verbose=False)
except ValueError as e:
    errors["divide"] = str(e)
os.environ["LOCAL_WORLD_SIZE"] = "1"
try:
    train("bm", 2, tag="hosts", multihost=True)
except ValueError as e:
    errors["hosts"] = str(e)
os.environ["LOCAL_WORLD_SIZE"] = str(SIZE)
try:
    train("bm", 2, tag="noop", network="tsn", emb_dim=3)
except ValueError as e:
    errors["noop"] = str(e)
with open(os.path.join(OUT, f"errors_{RANK}.json"), "w") as f:
    json.dump(errors, f)
"""

_RING_PART = """
from multimodal_similarity_tpu_torch.parallel import (
    make_ring_batch_hard_loss, make_ring_lifted_loss, replicate)
from multimodal_similarity_tpu_torch.parallel.ring_mining import _ring_stats


def ring_outputs(mesh, tag):
    emb, labels, valid = (np.load(os.path.join(IN, f + ".npy"))
                          for f in ("ring_emb", "ring_labels", "ring_valid"))
    rows = mesh.rows(len(emb))
    e, l, v = (torch.from_numpy(a[rows]) for a in (emb, labels, valid))
    out = dict(zip(("fp", "fpi", "cn", "cni", "nc"),
                   _ring_stats(mesh, e, l, True)))
    x = e.clone().requires_grad_(True)
    out["bh_loss"] = make_ring_batch_hard_loss(mesh, "soft")(x, l)[0]
    out["bh_loss"].backward()
    out["bh_grad"] = x.grad
    x = e.clone().requires_grad_(True)
    out["lt_loss"] = make_ring_lifted_loss(mesh, 0.5)(x, l, v)[0]
    out["lt_loss"].backward()
    out["lt_grad"] = x.grad
    # every rank's own value, then its mesh rank 0's on every rank
    out["replicated"] = replicate(torch.arange(4.0) + 10 * RANK, mesh)
    np.savez(os.path.join(OUT, f"{tag}_{mesh.rank}.npz"),
             **{k: t.detach().numpy() for k, t in out.items()})
"""

_TP22_TAIL = """
import torch
import torch.distributed as dist
from multimodal_similarity_tpu_torch.parallel import ProcessMesh
os.environ["LOCAL_WORLD_SIZE"] = str(SIZE)
for name in ("bm", "bh", "lt", "mm", "bmc"):
    train(name, 2)
# --multihost: two processes a host, a model group a host
os.environ["LOCAL_WORLD_SIZE"] = "2"
train("bmh", 2)
os.environ["LOCAL_WORLD_SIZE"] = str(SIZE)

# the rings and replicate on the sub-group of ranks 1 and 3: global rank 0
# left out
g13 = dist.new_group([1, 3])
dist.new_group([0, 2])
if RANK in (1, 3):
    ring_outputs(ProcessMesh(2, RANK // 2, g13, torch.device("cpu")), "sub")
dist.barrier()

# three data-parallel triplet steps on the 2 x 2 mesh from the JAX params,
# the miner fed JAX's draws of each step
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.parallel import (
    create_2d_mesh, gather_state_tp, make_dp_triplet_step, shard_module_tp)
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
calls = [0]


def draw(num_pairs, n, num_negative, generator, device):
    j = calls[0]
    calls[0] += 1
    g = [torch.from_numpy(np.load(os.path.join(IN, f"g{{j}}_{{i}}.npy")))
         for i in range(2 + num_negative)]
    return g[0], g[1], g[2:]


mining._draw_gumbels = draw
model = build_encoder("convrtsn", {small})
opt = build_optimizer("ADAM", model, {lr})
load_checkpoint(os.path.join(IN, "init.pt"), model, opt)
tp = create_2d_mesh(SIZE, 2)
shard_module_tp(model, tp, opt)
step = make_dp_triplet_step(model, opt, tp.data, triplet_per_batch={t},
                            alpha=0.2, num_negative={r}, lambda_l2=1e-3)
events, labels, mask = (np.load(os.path.join(IN, f + ".npy"))
                        for f in ("events", "labels", "mask"))
local = torch.from_numpy(events[tp.data.rows(len(events))])
for i in range({steps}):
    aux = step(local, torch.from_numpy(labels), torch.from_numpy(mask), {lr})
    save(f"jloss{{i}}", aux["loss"][None])
state, _ = gather_state_tp(model, opt)
np.savez(os.path.join(OUT, f"jparams_{{RANK}}.npz"),
         **{{k: v.numpy() for k, v in state.items()}})
"""

DP_N, DP_T, DP_R, DP_LR, DP_STEPS = 24, 13, 3, 0.01, 3
_TP22 = _TRAIN + _RING_PART + _TP22_TAIL.format(
    small=", ".join(f"{k}={v}" for k, v in SMALL.items()), lr=DP_LR, t=DP_T,
    r=DP_R, steps=DP_STEPS)

_DP2 = _TRAIN + _RING_PART + """
import torch
from multimodal_similarity_tpu_torch.parallel import create_mesh
for name in ("bm", "bh", "lt", "mm", "bmc", "bmh"):
    train(name, 0)
ring_outputs(create_mesh(SIZE), "world")
"""

RING_N, RING_D = 32, 16


def _write_inputs(tmp_path):
    """The synthetic directory, the runs' configs, the ring inputs and the
    JAX parity step's params, batch and draws; returns the JAX side's
    (model, params, events, labels, mask)."""
    inp = tmp_path / "in"
    inp.mkdir()
    root = str(tmp_path / "data")
    generate_synthetic_honda(
        root, n_sessions=5, frames_per_session=250,
        modal_dims={"resnet": (2, 2, 8), "sensors": (8,), "segment": (16,)},
        seed=0)
    runs = {k: (kind, dict(BASE, DATA_ROOT=root, name=k, **kw))
            for k, (kind, kw) in RUNS.items()}
    (inp / "runs.json").write_text(json.dumps(runs))
    rng = np.random.RandomState(0)
    np.save(inp / "ring_emb.npy", rng.randn(RING_N, RING_D).astype(np.float32))
    np.save(inp / "ring_labels.npy",
            rng.randint(0, 5, size=RING_N).astype(np.int64))
    np.save(inp / "ring_valid.npy",
            (rng.rand(RING_N) > 0.1).astype(np.float32))

    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((2, 3, 2, 2, 8)))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = build_encoder("convrtsn", **SMALL)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    save_checkpoint(str(inp / "init.pt"), tm,
                    build_optimizer("ADAM", tm, DP_LR), 0)
    rng = np.random.RandomState(1)
    events = rng.randn(DP_N, 3, 2, 2, 8).astype(np.float32)
    labels = rng.randint(1, 4, size=DP_N).astype(np.int32)
    mask = (np.arange(DP_N) < 22).astype(np.float32)
    for name, a in (("events", events), ("labels", labels), ("mask", mask)):
        np.save(inp / f"{name}.npy", a)
    for i in range(DP_STEPS):
        draws = jax_gumbels(jax.random.split(jax.random.PRNGKey(100 + i))[0],
                            -(-DP_T // DP_R), DP_N, DP_R)
        for k, g in enumerate(draws):
            np.save(inp / f"g{i}_{k}.npy", g)
    return jm, params, events, labels, mask


def _train_here(tmp_path, names, **over):
    """The runs at a data axis of one, in this process (no process group)."""
    env = {"IN": str(tmp_path / "in"), "OUT": str(tmp_path / "out_ref"),
           "RANK": 0, "SIZE": 1, "PG": None, "os": os, "np": np,
           "save": lambda name, x: None}
    exec(_TRAIN, env)
    return {n: env["train"](n, 0, **over) for n in names}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every run: the references in this process and the three spawns."""
    tmp_path = tmp_path_factory.mktemp("tp")
    jax_side = _write_inputs(tmp_path)
    (tmp_path / "out_ref").mkdir()
    refs = _train_here(tmp_path, ("bm", "bh", "lt", "mm"))
    (path,) = (tmp_path / "out_ref" / "bm").glob("*.ckpt-*")
    (tmp_path / "in" / "ref_bm.ckpt").write_bytes(path.read_bytes())
    run_ranks(tmp_path, 2, _TP12, "tp12")
    run_ranks(tmp_path, 4, _TP22, "tp22")
    run_ranks(tmp_path, 2, _DP2, "dp2")
    return tmp_path, refs, jax_side


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f if '"loss"' in line]


def _final(run_dir):
    """The last checkpoint's model and optimizer state."""
    (path,) = sorted(p for p in os.listdir(run_dir) if ".ckpt-" in p)[-1:]
    return torch.load(os.path.join(run_dir, path), weights_only=True)


def _same_run(got_dir, want_dir):
    got, want = _losses(got_dir), _losses(want_dir)
    assert got and len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    g, w = _final(got_dir), _final(want_dir)
    assert g["step"] == w["step"]
    assert g["model"].keys() == w["model"].keys()
    for k, v in w["model"].items():
        np.testing.assert_allclose(g["model"][k].numpy(), v.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    for i, entry in w["optimizer"]["state"].items():
        for k, v in entry.items():
            np.testing.assert_allclose(
                g["optimizer"]["state"][i][k].numpy(), v.numpy(),
                rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{i}.{k}")


def _halved(tmp_path, tag, name, n):
    for r in range(n):
        held, whole = rank_array(tmp_path, tag, f"bytes_{name}", r)
        assert held > 0 and 2 * held == whole, (r, held, whole)


@pytest.mark.parametrize("name", ["bm", "bh", "lt", "mm"])
def test_trainers_1x2_match_one_process(spawned, name):
    """--model_parallel 2 on 2 ranks (pure tensor parallelism: the
    batch-hard and lifted losses on the fused kernels' plain versions over
    the whole batch, the single-device fused steps) against the same
    trainer in one process; rank 1's loss trace equals rank 0's."""
    tmp_path, _, _ = spawned
    out = tmp_path / "out_tp12"
    _same_run(str(out / name), str(tmp_path / "out_ref" / name))
    assert _losses(str(out / f"{name}_proc1")) == _losses(str(out / name))
    assert not list((out / f"{name}_proc1").glob("*.ckpt-*"))
    _halved(tmp_path, "tp12", name, 2)


@pytest.mark.parametrize("name", ["bm", "bh", "lt", "mm", "bmc", "bmh"])
def test_trainers_2x2_match_data_parallel(spawned, name):
    """--model_parallel 2 on 4 ranks (a 2 x 2 mesh: the rings and the
    data-parallel steps over each data group; ``bmc`` the cached step with
    --steps_per_dispatch 2, ``bmh`` --multihost at two ranks a host, each
    data row a host's session shard) against the same trainer on 2 ranks
    without a model axis; every rank's loss trace equal."""
    tmp_path, _, _ = spawned
    out = tmp_path / "out_tp22"
    _same_run(str(out / name), str(tmp_path / "out_dp2" / name))
    for r in (1, 2, 3):
        assert _losses(str(out / f"{name}_proc{r}")) == \
            _losses(str(out / name))
    _halved(tmp_path, "tp22", name, 4)


def test_checkpoint_without_and_back(spawned):
    """A checkpoint of a split run loads into a run without a model axis
    and one without loads into a split run: ``base_model``'s second epoch
    from the other side's first-epoch checkpoint agrees both ways (the
    split checkpoint is whole: the same keys and shapes)."""
    tmp_path, _, _ = spawned
    (tp_ckpt,) = (tmp_path / "out_tp12" / "bm").glob("*.ckpt-*")
    (ref_ckpt,) = (tmp_path / "out_ref" / "bm").glob("*.ckpt-*")
    whole = torch.load(tp_ckpt, weights_only=True)
    plain = torch.load(ref_ckpt, weights_only=True)
    assert {k: v.shape for k, v in whole["model"].items()} == \
        {k: v.shape for k, v in plain["model"].items()}
    _train_here(tmp_path, ("bm",), max_epochs=2, model_path=str(tp_ckpt))
    # the run without a model axis, resumed from the split checkpoint,
    # against the split run resumed from the checkpoint without one
    got = _losses(str(tmp_path / "out_ref" / "bm"))[-1]
    want = _losses(str(tmp_path / "out_tp12" / "bm_resume"))[-1]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    model = build_encoder("rtsn", num_seg=3, emb_dim=32, n_input=8)
    opt = build_optimizer("ADAM", model, 0.01)
    assert load_checkpoint(str(tp_ckpt), model, opt) == whole["step"]


@pytest.mark.parametrize("kind,n_split", [("conv", 4), ("grouped_conv", 2),
                                          ("sae", 6)])
def test_split_layers_match_unsplit(spawned, kind, n_split):
    """The layers no trainer splits, at 1 x 2: a Conv2d pair
    (column-parallel, the channels gathered), a grouped Conv2d (its weight
    gathered where used) and the SAE's raw parameters (gathered where used;
    its l2 term summed over the model group): the output and every
    gathered gradient equal the unsplit module's (1e-6), on both ranks."""
    tmp_path, _, _ = spawned
    for r in range(2):
        split, err, gerr = rank_array(tmp_path, "tp12", f"layer_{kind}", r)
        assert split == n_split
        assert err <= 1e-6 and gerr <= 1e-6, (err, gerr)


def test_checkpoint_round_trip(spawned):
    """A split run's checkpoint, loaded whole, split again and gathered
    (``gather_state_tp``), gives back every parameter and moment of the
    file, on both ranks."""
    tmp_path, _, _ = spawned
    for r in range(2):
        assert rank_array(tmp_path, "tp12", "round_trip", r)[0]


def test_mesh_and_no_op_errors(spawned):
    """At 2 ranks: a model axis of 3 raises JAX's "does not divide the 2
    visible devices"; --multihost --model_parallel 2 with one process a
    host JAX's "must not span hosts"; a TSN of emb_dim 3 JAX's no-op
    ValueError; the same on both ranks."""
    tmp_path, _, _ = spawned
    errs = [json.loads((tmp_path / "out_tp12" / f"errors_{r}.json")
                       .read_text()) for r in range(2)]
    assert errs[0] == errs[1]
    assert errs[0]["divide"] == ("--model_parallel 3 does not divide the "
                                 "2 visible devices")
    assert errs[0]["hosts"] == (
        "--model_parallel 2 does not divide the 1 devices per host; a tp "
        "group must not span hosts")
    assert errs[0]["noop"] == (
        "--model_parallel 2: no parameter has a trailing dim divisible by 2 "
        "(emb_dim 3); tensor parallelism would be a silent no-op")


def test_subgroup_rings_and_replicate(spawned):
    """The batch-hard ring (stats, winners, loss and gradient), the lifted
    ring (loss and gradient) and ``replicate`` on the sub-group {1, 3} of 4
    ranks, which leaves global rank 0 out, equal the same calls on a
    2-rank world, mesh rank for mesh rank; ``replicate`` gives every
    member its mesh rank 0's value (global rank 1's)."""
    tmp_path, _, _ = spawned
    for r in range(2):
        sub = np.load(tmp_path / "out_tp22" / f"sub_{r}.npz")
        world = np.load(tmp_path / "out_dp2" / f"world_{r}.npz")
        for k in world.files:
            if k == "replicated":
                continue
            np.testing.assert_array_equal(sub[k], world[k], err_msg=k)
        np.testing.assert_array_equal(sub["replicated"],
                                      np.arange(4.0) + 10)
        np.testing.assert_array_equal(world["replicated"], np.arange(4.0))


def test_tp_step_matches_jax_shard_state_tp(spawned):
    """Three data-parallel triplet steps on the 2 x 2 mesh (ConvRTSN split
    over each model group, the loss and summed gradients over each data
    group) against JAX's ``make_dp_triplet_step`` on ``create_2d_mesh(4,
    2)`` with ``shard_state_tp``, from the same params, the miner fed
    JAX's draws: every step's loss within rtol 2e-4 / atol 2e-5, the
    gathered parameters within rtol 1e-4 / atol 1e-6, on every rank."""
    tmp_path, _, (jm, params, events, labels, mask) = spawned
    mesh = jax_2d_mesh(4, 2)
    state = shard_state_tp(TrainState.create(
        params, jax_build_optimizer("ADAM", DP_LR)), mesh)
    step = jax_dp_step(jm, mesh, triplet_per_batch=DP_T, alpha=0.2,
                       num_negative=DP_R, lambda_l2=1e-3)
    losses = []
    for i in range(DP_STEPS):
        state, aux = step(state, jnp.asarray(events), jnp.asarray(labels),
                          jnp.asarray(mask), jax.random.PRNGKey(100 + i),
                          jnp.float32(DP_LR))
        losses.append(float(aux["loss"]))
        assert float(aux["triplet_num"]) > 0
    tm = build_encoder("convrtsn", **SMALL)
    want = flax_to_state_dict(jax.tree.map(np.asarray, state.params), tm)
    for r in range(4):
        got = [rank_array(tmp_path, "tp22", f"jloss{i}", r)[0]
               for i in range(DP_STEPS)]
        np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        got = np.load(tmp_path / "out_tp22" / f"jparams_{r}.npz")
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


# -- errors without a process group -------------------------------------------


def test_base_model_host_miner_raises(tmp_path):
    """--model_parallel with a host miner raises JAX's ValueError."""
    cfg = TrainConfig(DATA_ROOT=str(tmp_path), triplet_select="random",
                      model_parallel=2).resolve()
    with pytest.raises(ValueError, match="--model_parallel requires "
                       "--triplet_select facenet"):
        base_model.train(cfg, device="cpu")


D8 = {
    "pddm_model": pddm_model.train,
    "multitask_model": multitask_model.train,
    "pairsim_model": pairsim_model.train,
    "base_model_classifier": base_model_classifier.train,
    "cross_prediction": cross_prediction.train,
    "unimodal_pretrain_sae": unimodal_pretrain_sae.train,
    "base_model_tf": base_model_tf.train,
    "multimodal_model_weak": multimodal_model_weak.train,
}


@pytest.mark.parametrize("name", list(D8))
def test_trainers_without_tp_path_raise_d8(tmp_path, name):
    """A trainer with no tensor-parallel path in JAX (which ignores the
    flag there) raises ROADMAP D8's ValueError."""
    cfg = TrainConfig(DATA_ROOT=str(tmp_path), model_parallel=2).resolve()
    with pytest.raises(ValueError, match=f"--model_parallel: {name} has no "
                       "tensor-parallel path"):
        D8[name](cfg, device="cpu")

