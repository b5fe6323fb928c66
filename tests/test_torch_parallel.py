"""The port's data parallelism (``multimodal_similarity_tpu_torch.parallel``)
against the JAX package's on the suite's virtual CPU devices.

Torch ranks run as separate processes over gloo, joined through a file
(``init_method=file://...``, so that concurrent test workers cannot
collide on a port), one thread each, each joined with a limit of its own.
The ranks never import JAX: they read their inputs from ``.npy`` files and
save their outputs the same way; the test process computes the JAX side on
``create_mesh(n)`` of its virtual devices.  Tolerances are stated at each
assertion: f32 summation order, as in the single-device parity tests.
"""

import glob
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.data import (
    generate_synthetic_honda, prepare_dataset)
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.parallel import create_mesh as jax_mesh
from multimodal_similarity_tpu.parallel import (
    host_local_sessions as jax_host_local_sessions)
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    prep_operands, stats_plain, winning_pair_grad)
from multimodal_similarity_tpu_torch.parallel import (
    auto_mesh, create_mesh, host_local_sessions, initialize_distributed,
    make_global_batch, make_ring_batch_hard_loss, ring_batch_hard_stats,
    shard_batch)
from multimodal_similarity_tpu_torch.parallel import ring_mining
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2, n_C=4)
RANK_TIMEOUT = 120

_RUNNER = """\
import os, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import torch.distributed as dist
RANK, SIZE = int(sys.argv[1]), int(sys.argv[2])
IN, OUT = sys.argv[4], sys.argv[5]
PG = "file://" + sys.argv[3]
torch.set_num_threads(1)
if {init!r}:
    dist.init_process_group("gloo", init_method=PG, world_size=SIZE,
                            rank=RANK)


def save(name, x):
    np.save(os.path.join(OUT, f"{{name}}_{{RANK}}.npy"),
            x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))


def replay_draws():
    # the JAX miner's Gumbel draws, precomputed by the test process
    from multimodal_similarity_tpu_torch.ops import mining
    draws = [torch.from_numpy(np.load(p)) for p in
             sorted(f for f in (os.path.join(IN, n) for n in os.listdir(IN))
                    if os.path.basename(f).startswith("gumbel"))]

    def draw(num_pairs, n, num_negative, generator, device):
        return draws[0], draws[1], draws[2:]
    mining._draw_gumbels = draw


try:
{body}
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def run_ranks(tmp_path, n, body, tag, init=True):
    """Run ``body`` on ``n`` gloo ranks (the group started before it, or
    with ``init=False`` left to the body, at ``PG``); returns their stdout
    texts (every rank must exit 0 within RANK_TIMEOUT seconds, or all are
    killed)."""
    inp, out = tmp_path / "in", tmp_path / f"out_{tag}"
    inp.mkdir(exist_ok=True)
    out.mkdir()
    script = tmp_path / f"rank_{tag}.py"
    script.write_text(_RUNNER.format(
        root=ROOT, init=init,
        body=textwrap.indent(textwrap.dedent(body), "    ")))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n),
         str(tmp_path / f"pg_{tag}"), str(inp), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(n)]
    texts = []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {tag} hung past {RANK_TIMEOUT} s")
            texts.append(text)
            assert p.returncode == 0, f"rank {r} of {tag} failed:\n{text}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return texts


def gathered(tmp_path, tag, name, n):
    """The ranks' saved ``name`` arrays concatenated in rank order."""
    return np.concatenate([np.load(tmp_path / f"out_{tag}" / f"{name}_{r}.npy")
                           for r in range(n)])


def rank_array(tmp_path, tag, name, rank):
    return np.load(tmp_path / f"out_{tag}" / f"{name}_{rank}.npy")


def jax_gumbels(key, num_pairs, n, num_negative):
    """The Gumbel arrays the JAX semi-hard miner draws for ``key``."""
    k_a, k_p, k_n = jax.random.split(key, 3)
    keys = [k_a, k_p] + list(jax.random.split(k_n, num_negative))
    return [np.asarray(jax.random.gumbel(k, (num_pairs, n), jnp.float32))
            for k in keys]


def save_gumbels(tmp_path, draws):
    (tmp_path / "in").mkdir(exist_ok=True)
    for i, g in enumerate(draws):
        np.save(tmp_path / "in" / f"gumbel{i:02d}.npy", g)


# -- the rings at 4 ranks -----------------------------------------------------

RING_N, RING_D, RING_RANKS, LIFTED_MARGIN = 32, 16, 4, 0.5

_RING_BODY = """
from multimodal_similarity_tpu_torch.parallel import (
    create_mesh, make_ring_batch_hard_loss, make_ring_lifted_loss,
    make_ring_lifted_stats_grad, ring_batch_hard_stats)
from multimodal_similarity_tpu_torch.parallel.ring_mining import _ring_stats
mesh = create_mesh(SIZE)
emb, labels, valid, w = (np.load(os.path.join(IN, f + ".npy"))
                         for f in ("emb", "labels", "valid", "w"))
rows = mesh.rows(len(emb))
e, l, v = (torch.from_numpy(a[rows]) for a in (emb, labels, valid))
for name, x in zip(("fp", "fpi", "cn", "cni", "nc"),
                   _ring_stats(mesh, e, l, True)):
    save(name, x)
for name, x in zip(("fp2", "cn2", "nc2"), ring_batch_hard_stats(mesh, e, l)):
    save(name, x)
for tag, margin in (("soft", "soft"), ("hard", 0.2)):
    x = e.clone().requires_grad_(True)
    loss, active, *_ = make_ring_batch_hard_loss(mesh, margin)(x, l)
    loss.backward()
    save("loss_" + tag, loss[None])
    save("active_" + tag, active[None])
    save("grad_" + tag, x.grad)
x = e.clone().requires_grad_(True)
fp, cn, nc = make_ring_lifted_stats_grad(mesh, {margin})(x, l, v)
wr = torch.from_numpy(w[:, rows])
((fp * wr[0]).sum() + (cn * wr[1]).sum()).backward()
for name, t in (("lfp", fp), ("lcn", cn), ("lnc", nc), ("lgrad", x.grad)):
    save(name, t)
x = e.clone().requires_grad_(True)
loss = make_ring_lifted_loss(mesh, {margin})(x, l, v)[0]
loss.backward()
save("lloss", loss[None])
save("llgrad", x.grad)
""".format(margin=LIFTED_MARGIN)


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """One 4-rank run of every ring quantity, and the inputs."""
    tmp_path = tmp_path_factory.mktemp("ring")
    rng = np.random.RandomState(0)
    emb = rng.randn(RING_N, RING_D).astype(np.float32)
    labels = rng.randint(0, 5, size=RING_N).astype(np.int64)
    labels[:3] = 1
    valid = (np.arange(RING_N) < 26).astype(np.float32)
    w = rng.randn(2, RING_N).astype(np.float32)
    (tmp_path / "in").mkdir()
    for name, a in (("emb", emb), ("labels", labels), ("valid", valid),
                    ("w", w)):
        np.save(tmp_path / "in" / f"{name}.npy", a)
    run_ranks(tmp_path, RING_RANKS, _RING_BODY, "ring")
    return tmp_path, emb, labels, valid, w


def _got(ring_run, name):
    return gathered(ring_run[0], "ring", name, RING_RANKS)


def test_ring_batch_hard_stats_match_jax(ring_run):
    """``ring_batch_hard_stats`` and the winner-tracking ring at 4 ranks
    against the JAX ring on ``create_mesh(4)``: fp and cn rtol 1e-5, nc and
    the winners (global indices) equal."""
    from multimodal_similarity_tpu.parallel.ring_mining import (
        _ring_stats as jax_ring_stats)
    _, emb, labels, _, _ = ring_run
    want = jax_ring_stats(jax_mesh(RING_RANKS), jnp.asarray(emb),
                          jnp.asarray(labels), "data", True)
    for name, w in zip(("fp", "fpi", "cn", "cni", "nc"), want):
        w = np.asarray(w)
        if name in ("fp", "cn"):
            np.testing.assert_allclose(_got(ring_run, name), w, rtol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(_got(ring_run, name), w,
                                          err_msg=name)
    for name in ("fp", "cn", "nc"):
        np.testing.assert_array_equal(_got(ring_run, name + "2"),
                                      _got(ring_run, name))


@pytest.mark.parametrize("margin", ["soft", "hard"])
def test_ring_batch_hard_loss_and_grad_match_jax(ring_run, margin):
    """The ring batch-hard loss (global value on every rank), its active
    share and the gradient of the global loss with respect to every rank's
    rows, against the JAX ring loss: rtol 1e-5 (gradient atol 1e-7)."""
    from multimodal_similarity_tpu.parallel import (
        make_ring_batch_hard_loss as jax_ring_loss)
    tmp_path, emb, labels, _, _ = ring_run
    loss_fn = jax_ring_loss(jax_mesh(RING_RANKS),
                            "soft" if margin == "soft" else 0.2)
    (loss, aux), grad = jax.value_and_grad(
        lambda e: (lambda o: (o[0], o[1]))(loss_fn(e, jnp.asarray(labels))),
        has_aux=True)(jnp.asarray(emb))
    for r in range(RING_RANKS):
        np.testing.assert_allclose(
            rank_array(tmp_path, "ring", f"loss_{margin}", r), [float(loss)],
            rtol=1e-5)
        np.testing.assert_allclose(
            rank_array(tmp_path, "ring", f"active_{margin}", r),
            [float(aux)], rtol=1e-5)
    np.testing.assert_allclose(_got(ring_run, f"grad_{margin}"),
                               np.asarray(grad), rtol=1e-5, atol=1e-7)


def test_ring_lifted_stats_and_grad_match_jax(ring_run):
    """The lifted ring's stats and their gradient under fixed cotangents,
    and the lifted ring loss and its gradient, with a ``valid`` mask, at 4
    ranks against the JAX rings: rtol 1e-5; the gradients' entries also
    within 1e-5 of the gradient's largest entry (entries near zero are
    sums that cancel: both packages sit 1.2e-6 of that scale from a
    float64 evaluation)."""
    from multimodal_similarity_tpu.parallel import (
        make_ring_lifted_loss as jax_lifted_loss,
        make_ring_lifted_stats_grad as jax_lifted_stats)
    tmp_path, emb, labels, valid, w = ring_run
    mesh = jax_mesh(RING_RANKS)
    stats = jax_lifted_stats(mesh, LIFTED_MARGIN)
    lab, val = jnp.asarray(labels), jnp.asarray(valid)
    (fp, cn, nc), vjp = jax.vjp(lambda e: stats(e, lab, val),
                                jnp.asarray(emb))
    (g,) = vjp((jnp.asarray(w[0]), jnp.asarray(w[1]), jnp.zeros_like(nc)))
    for name, want in (("lfp", fp), ("lcn", cn), ("lnc", nc)):
        np.testing.assert_allclose(_got(ring_run, name), np.asarray(want),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(_got(ring_run, "lgrad"), np.asarray(g),
                               rtol=1e-5, atol=1e-5 * np.abs(g).max())
    loss_fn = jax_lifted_loss(mesh, LIFTED_MARGIN)
    loss, grad = jax.value_and_grad(
        lambda e: loss_fn(e, lab, val)[0])(jnp.asarray(emb))
    for r in range(RING_RANKS):
        np.testing.assert_allclose(rank_array(tmp_path, "ring", "lloss", r),
                                   [float(loss)], rtol=1e-5)
    np.testing.assert_allclose(_got(ring_run, "llgrad"), np.asarray(grad),
                               rtol=1e-5, atol=1e-5 * np.abs(grad).max())


# -- one process: the mesh helpers and the world-1 ring ---------------------


@pytest.fixture
def world_one(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg1",
                            world_size=1, rank=0)
    try:
        yield create_mesh(1)
    finally:
        dist.destroy_process_group()


def test_world_one_ring_matches_kernel_plain_version(world_one, rng):
    """At world 1 the ring is one fold: its stats and winners equal the
    batch-hard kernels' plain version in f32 (rtol 1e-6, winners equal),
    and the ring loss's gradient equals the plain version's winner-pair
    gradient (rtol 1e-6)."""
    emb = torch.from_numpy(rng.randn(48, 8).astype(np.float32))
    labels = torch.from_numpy(rng.randint(1, 6, size=48))
    ops = prep_operands(emb, labels, torch.ones(48), "f32")
    fp, cn, nc, fpi, cni = stats_plain(ops, True)
    got = ring_mining._ring_stats(world_one, emb, labels, True)
    np.testing.assert_allclose(got[0].numpy(), fp.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), cn.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), fpi.numpy())
    np.testing.assert_array_equal(got[3].numpy(), cni.numpy())
    np.testing.assert_array_equal(got[4].numpy(), nc.numpy())
    np.testing.assert_array_equal(
        ring_batch_hard_stats(world_one, emb, labels)[0].numpy(),
        got[0].numpy())
    x = emb.clone().requires_grad_(True)
    make_ring_batch_hard_loss(world_one, 0.2)(x, labels)[0].backward()
    g_fp = torch.zeros(48)
    g_cn = torch.zeros(48)
    weights = nc / nc.sum()
    active = (fp - cn + 0.2) > 0
    g_fp[active], g_cn[active] = weights[active], -weights[active]
    want = winning_pair_grad(emb, fp, cn, fpi.long(), cni.long(), g_fp, g_cn)
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_mesh_helpers(world_one):
    """On a one-rank group: ``auto_mesh`` gives no mesh below two processes
    (as JAX's below two devices); ``shard_batch`` takes this rank's
    contiguous rows; ``make_global_batch`` keeps local rows and says which
    global rows they are; ``host_local_sessions`` equals JAX's;
    ``create_mesh`` refuses a size other than the world's."""
    assert auto_mesh(37) == (None, 37)
    assert world_one.size == 1 and world_one.rank == 0
    assert world_one.shape == {"data": 1}
    batch = {"x": np.arange(12).reshape(6, 2), "k": 3}
    assert np.array_equal(shard_batch(batch, world_one)["x"], batch["x"])
    glob_rows = make_global_batch(world_one, {"x": batch["x"]})["x"]
    assert glob_rows.offset == 0 and glob_rows.global_rows == 6
    sessions = [f"s{i}" for i in range(7)]
    for pid in range(3):
        assert host_local_sessions(sessions, pid, 3) == \
            jax_host_local_sessions(sessions, pid, 3)
    assert host_local_sessions(sessions) == sessions
    with pytest.raises(ValueError, match="process group has 1"):
        create_mesh(2)


@pytest.mark.parametrize("form", ["torchrun", "explicit"])
def test_initialize_distributed_starts_a_group(tmp_path, monkeypatch, form):
    """The zero-argument form starts the group from ``torchrun``'s
    environment (``env://``), the explicit form from a coordinator URL;
    either at world 1 gives no mesh from ``auto_mesh`` and a one-rank
    ``create_mesh`` on the CPU (gloo)."""
    if form == "torchrun":
        for key, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                           ("MASTER_ADDR", "127.0.0.1"),
                           ("MASTER_PORT", "0")):
            monkeypatch.setenv(key, value)
        initialize_distributed(backend="gloo")
    else:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        initialize_distributed(f"file://{tmp_path}/pg", 1, 0,
                               backend="gloo")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert auto_mesh(37) == (None, 37)
        mesh = create_mesh()
        assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_without_a_group(monkeypatch):
    """Without a process group: the zero-argument form is a no-op outside
    ``torchrun``; a partial explicit config raises the reference's
    ValueError; ``auto_mesh`` gives (None, batch); ``create_mesh``
    raises."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="without --coordinator_address"):
        initialize_distributed(None, 2, None)
    with pytest.raises(ValueError, match="needs --num_processes"):
        initialize_distributed("localhost:1", None, 0)
    assert auto_mesh(37) == (None, 37)
    with pytest.raises(RuntimeError, match="initialised process group"):
        create_mesh()


# -- the data-parallel triplet step at 2 ranks --------------------------------

DP_N, DP_T, DP_R, DP_LR = 24, 13, 3, 0.01

_DP_BODY = """
replay_draws()
from multimodal_similarity_tpu_torch.models import build_encoder
from multimodal_similarity_tpu_torch.parallel import (
    create_mesh, make_dp_triplet_step)
from multimodal_similarity_tpu_torch.train.checkpoints import load_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
model = build_encoder("convrtsn", num_seg=3, emb_dim=16, n_input=8, n_h=2,
                      n_w=2, n_C=4)
opt = build_optimizer("ADAM", model, {lr})
load_checkpoint(os.path.join(IN, "init.pt"), model, opt)
mesh = create_mesh(SIZE)
step = make_dp_triplet_step(model, opt, mesh, triplet_per_batch={t},
                            alpha=0.2, num_negative={r}, lambda_l2=1e-3)
events, labels, mask = (np.load(os.path.join(IN, f + ".npy"))
                        for f in ("events", "labels", "mask"))
aux = step(torch.from_numpy(events[mesh.rows(len(events))]),
           torch.from_numpy(labels), torch.from_numpy(mask), {lr})
save("loss", aux["loss"][None])
save("triplets", aux["triplet_num"][None])
np.savez(os.path.join(OUT, f"params_{{RANK}}.npz"),
         **{{k: v.numpy() for k, v in model.state_dict().items()}})
""".format(lr=DP_LR, t=DP_T, r=DP_R)


def _init_params(tmp_path, lr):
    """Random JAX ConvRTSN params and the port checkpoint holding them."""
    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(3),
                     jnp.zeros((2, 3, 2, 2, 8)))["params"]
    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    (tmp_path / "in").mkdir(exist_ok=True)
    save_checkpoint(str(tmp_path / "in" / "init.pt"), tm,
                    build_optimizer("ADAM", tm, lr), 0)
    return jm, params, tm


def test_dp_triplet_step_matches_jax(tmp_path):
    """``make_dp_triplet_step`` at 2 ranks against JAX's on
    ``create_mesh(2)`` from the same params, the miner fed the JAX step's
    draws: the loss and every updated parameter within rtol 1e-4 (atol
    1e-6), identical on both ranks."""
    from multimodal_similarity_tpu.parallel import (
        make_dp_triplet_step as jax_dp_step)
    rng = np.random.RandomState(1)
    events = rng.randn(DP_N, 3, 2, 2, 8).astype(np.float32)
    labels = rng.randint(1, 4, size=DP_N).astype(np.int32)
    mask = (np.arange(DP_N) < 22).astype(np.float32)
    jm, params, tm = _init_params(tmp_path, DP_LR)
    for name, a in (("events", events), ("labels", labels), ("mask", mask)):
        np.save(tmp_path / "in" / f"{name}.npy", a)
    key = jax.random.PRNGKey(11)
    save_gumbels(tmp_path, jax_gumbels(jax.random.split(key)[0],
                                       -(-DP_T // DP_R), DP_N, DP_R))
    run_ranks(tmp_path, 2, _DP_BODY, "dp")

    state = TrainState.create(params, jax_build_optimizer("ADAM", DP_LR))
    step = jax_dp_step(jm, jax_mesh(2), triplet_per_batch=DP_T, alpha=0.2,
                       num_negative=DP_R, lambda_l2=1e-3)
    state, aux = step(state, jnp.asarray(events), jnp.asarray(labels),
                      jnp.asarray(mask), key, jnp.float32(DP_LR))
    assert float(aux["triplet_num"]) > 0
    want = flax_to_state_dict(jax.tree.map(np.asarray, state.params), tm)
    for r in range(2):
        np.testing.assert_allclose(rank_array(tmp_path, "dp", "loss", r),
                                   [float(aux["loss"])], rtol=1e-4)
        assert rank_array(tmp_path, "dp", "triplets", r)[0] == \
            float(aux["triplet_num"])
        got = np.load(tmp_path / "out_dp" / f"params_{r}.npz")
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


# -- the trainers at 2 ranks --------------------------------------------------


def _trainer_setup(tmp_path, **extra):
    """A synthetic directory, the JAX and port configs (dropout off, the
    same initial params through ``--model_path``)."""
    root = str(tmp_path / "data")
    generate_synthetic_honda(root, n_sessions=5, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8)}, seed=0)
    kw = dict(name="t", network="convrtsn", feat="resnet", silent_mode=True,
              learning_rate=0.01, keep_prob=1.0, lambda_l2=0.0,
              DATA_ROOT=root, sess_per_batch=1, batch_size=32, max_epochs=1,
              log_flush_every=1, **SMALL)
    kw.update(extra)
    jcfg = JaxTrainConfig(**kw).resolve()
    jm, params, _ = _init_params(tmp_path, jcfg.learning_rate)
    jcfg.model_path = str(tmp_path / "init.msgpack")
    save_pytree(jcfg.model_path, TrainState.create(
        params, jax_build_optimizer("ADAM", jcfg.learning_rate)))
    port_kw = dict(kw, model_path=str(tmp_path / "in" / "init.pt"))
    with open(tmp_path / "in" / "cfg.json", "w") as f:
        json.dump(port_kw, f)
    return jcfg, jm, params


def _records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["loss"] for r in recs if "loss" in r],
            [r["val_mAP"] for r in recs if "val_mAP" in r])


_BATCHHARD_BODY = """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import base_model_batchhard
cfg = TrainConfig(**json.load(open(os.path.join(IN, "cfg.json")))).resolve()
res = base_model_batchhard.train(cfg, loss_kind=LOSS, event_budget=48,
                                 result_dir=os.path.join(OUT, "port"),
                                 device="cpu")
print("STEPS", res.step)
"""


@pytest.mark.parametrize("loss_kind", ["batchhard", "lifted"])
def test_batchhard_two_ranks_match_jax_trainer(tmp_path, monkeypatch,
                                               loss_kind):
    """One epoch of ``base_model_batchhard`` / ``base_model_lifted`` at 2
    ranks (torchrun's data parallelism, no --multihost) against the JAX
    trainer with ``auto_mesh`` patched to a 2-device mesh, both on the f32
    ring, dropout off: loss trace rtol 1e-4, val mAP atol 1e-3; rank 0
    alone writes checkpoints."""
    import importlib

    import multimodal_similarity_tpu.parallel as jax_parallel
    jax_trainer = importlib.import_module(
        f"multimodal_similarity_tpu.train.trainers.base_model_{loss_kind}")
    jcfg, _, _ = _trainer_setup(tmp_path)
    texts = run_ranks(tmp_path, 2, f"LOSS = {loss_kind!r}\n"
                      + _BATCHHARD_BODY, "bh")
    monkeypatch.setattr(jax_parallel, "auto_mesh", lambda b, verbose=True: (
        jax_mesh(2), -(-b // 2) * 2))
    _, _, jax_dir = jax_trainer.train(jcfg, event_budget=48,
                                      result_dir=str(tmp_path / "jax"))
    got_loss, got_map = _records(tmp_path / "out_bh" / "port")
    want_loss, want_map = _records(jax_dir)
    assert len(got_loss) == len(want_loss) == 3, texts
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)
    rank1 = _records(tmp_path / "out_bh" / "port_proc1")
    np.testing.assert_allclose(rank1[0], got_loss, rtol=1e-6)
    assert glob.glob(str(tmp_path / "out_bh" / "port" / "t.ckpt-3"))
    assert not glob.glob(str(tmp_path / "out_bh" / "port_proc1" / "*ckpt*"))


class _FeedOpened(Exception):
    pass


@pytest.mark.parametrize("trainer", ["base_model_batchhard", "base_model"])
def test_trainer_feeds_the_rank_device(tmp_path, monkeypatch, trainer):
    """On a mesh the trainer works on the rank's own device.  Under NCCL
    that is ``cuda:<LOCAL_RANK>`` while ``--device cuda`` names no card,
    and the feed thread's current CUDA device is not the one the main
    thread was bound to: ``open_feed`` must receive the indexed device.
    A mesh on ``cpu:0`` stands in for an NCCL rank's (the CPU has no
    card); ``open_feed`` gets that device, not the bare ``cpu`` the caller
    passed."""
    import importlib

    from multimodal_similarity_tpu_torch.configs import TrainConfig
    from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
    from multimodal_similarity_tpu_torch.train.trainers import (
        base_model_batchhard as bh)
    mod = importlib.import_module(
        f"multimodal_similarity_tpu_torch.train.trainers.{trainer}")
    _trainer_setup(tmp_path)
    with open(tmp_path / "in" / "cfg.json") as f:
        cfg = TrainConfig(**json.load(f), triplet_select="facenet").resolve()
    rank_dev = torch.device("cpu", 0)
    seen = []

    def open_feed(self, device, *a, **k):
        seen.append(device)
        raise _FeedOpened

    monkeypatch.setattr(bh, "initialize_distributed", lambda *a, **k: None)
    monkeypatch.setattr(bh, "auto_mesh", lambda b, verbose=True: (
        ProcessMesh(2, 0, None, rank_dev), -(-b // 2) * 2))
    monkeypatch.setattr(mod, "replicate", lambda tree, mesh: tree)
    monkeypatch.setattr(mod.HondaExperiment, "open_feed", open_feed)
    with pytest.raises(_FeedOpened):
        mod.train(cfg, event_budget=48, result_dir=str(tmp_path / "port"),
                  device="cpu")
    assert seen == [rank_dev] and seen[0].index == 0


_MULTIHOST_BODY = """
import json
replay_draws()
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import base_model
seen = {}
Exp = base_model.HondaExperiment


class Recorded(Exp):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        seen["exp"] = self


real_dp = base_model.make_dp_triplet_step


def recorded_dp(*a, **k):
    step = real_dp(*a, **k)

    def run(events, labels, mask, lr):
        first = "loss" not in seen
        if first:
            for name, t in (("events", events), ("labels", labels),
                            ("mask", mask)):
                save(name, t)
        aux = step(events, labels, mask, lr)
        if first:
            seen["loss"] = aux["loss"]
            save("loss", aux["loss"][None])
        return aux
    return run


base_model.HondaExperiment = Recorded
base_model.make_dp_triplet_step = recorded_dp
kw = json.load(open(os.path.join(IN, "cfg.json")))
# the trainer starts the group from the explicit coordinator flags
kw.update(coordinator_address=PG, num_processes=SIZE, process_id=RANK)
res = base_model.train(TrainConfig(**kw).resolve(), event_budget=48,
                       result_dir=os.path.join(OUT, "port"), device="cpu")
exp = seen["exp"]
with open(os.path.join(OUT, f"sessions_{RANK}.json"), "w") as f:
    json.dump({"local": [r[0] for r in exp.local_set],
               "batches": exp.batch_per_epoch, "steps": res.step}, f)
"""


def test_base_model_multihost_two_ranks(tmp_path):
    """``base_model --multihost --coordinator_address file://...
    --num_processes 2 --process_id r`` (the trainer starts the group) at 2
    ranks: each rank's session shard and
    the lockstep batch count equal JAX's ``host_local_sessions`` and
    ``(len(train_set) // pcount) // sess_per_batch``; the first step's loss
    equals the JAX data-parallel step's on the rank-ordered concatenation
    of the two local batches from the same params under the same draws
    (rtol 1e-4); rank 0 alone writes the checkpoint."""
    from multimodal_similarity_tpu.parallel import (
        make_dp_triplet_step as jax_dp_step)
    t, r_neg = 12, 3
    jcfg, jm, params = _trainer_setup(
        tmp_path, triplet_select="facenet", triplet_per_batch=t,
        num_negative=r_neg, multihost=True, lambda_l2=1e-3)
    key = jax.random.PRNGKey(5)
    save_gumbels(tmp_path, jax_gumbels(jax.random.split(key)[0],
                                       -(-t // r_neg), 48, r_neg))
    run_ranks(tmp_path, 2, _MULTIHOST_BODY, "mh", init=False)

    train_set = prepare_dataset(jcfg.feature_root, jcfg.train_session,
                                "resnet", jcfg.label_root,
                                jcfg.label_type)[: jcfg.label_num]
    for r in range(2):
        with open(tmp_path / "out_mh" / f"sessions_{r}.json") as f:
            rec = json.load(f)
        assert rec["local"] == [row[0] for row in
                                jax_host_local_sessions(train_set, r, 2)]
        assert rec["batches"] == (len(train_set) // 2) // jcfg.sess_per_batch
        assert rec["steps"] == rec["batches"]
    events, labels, mask = (gathered(tmp_path, "mh", n, 2)
                            for n in ("events", "labels", "mask"))
    assert events.shape[0] == 48
    state = TrainState.create(params, jax_build_optimizer(
        "ADAM", jcfg.learning_rate))
    step = jax_dp_step(jm, jax_mesh(2), triplet_per_batch=t, alpha=jcfg.alpha,
                       num_negative=r_neg, lambda_l2=1e-3)
    _, aux = step(state, jnp.asarray(events), jnp.asarray(labels),
                  jnp.asarray(mask), key, jnp.float32(jcfg.learning_rate))
    for r in range(2):
        np.testing.assert_allclose(rank_array(tmp_path, "mh", "loss", r),
                                   [float(aux["loss"])], rtol=1e-4)
    assert glob.glob(str(tmp_path / "out_mh" / "port" / "t.ckpt-1"))
    assert not glob.glob(str(tmp_path / "out_mh" / "port_proc1" / "*ckpt*"))


_PREEMPT_BODY = """
import json
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers import base_model_batchhard
from multimodal_similarity_tpu_torch.utils import preemption

if RANK == 1:
    class FiringGuard(preemption.PreemptionGuard):
        checks = 0

        @property
        def should_stop(self):
            FiringGuard.checks += 1
            if FiringGuard.checks > 2:
                self.request_stop()
            return self._stop.is_set()
    preemption.PreemptionGuard = FiringGuard
cfg = TrainConfig(**json.load(open(os.path.join(IN, "cfg.json")))).resolve()
res = base_model_batchhard.train(cfg, event_budget=48,
                                 result_dir=os.path.join(OUT, "port"),
                                 device="cpu")
print(f"RANK_{RANK}_STOPPED step={res.step}")
"""


def test_asymmetric_preemption_two_ranks(tmp_path):
    """A stop requested on rank 1 alone stops both ranks at the same step
    boundary (``sync_should_stop``'s all-reduce), well short of the
    50-epoch budget; rank 0 checkpoints that step and says so, rank 1
    reports stopping without claiming a checkpoint."""
    _trainer_setup(tmp_path, max_epochs=50)
    texts = run_ranks(tmp_path, 2, _PREEMPT_BODY, "pre")
    steps = []
    for r, text in enumerate(texts):
        want = ("preemption signal: checkpointed at step" if r == 0
                else "preemption signal: stopping at step")
        assert want in text, text
        steps.append(int(re.search(rf"RANK_{r}_STOPPED step=(\d+)",
                                   text).group(1)))
    assert steps[0] == steps[1] and 0 < steps[0] < 20, steps
    assert glob.glob(str(tmp_path / "out_pre" / "port"
                         / f"t.ckpt-{steps[0]}"))
    assert not glob.glob(str(tmp_path / "out_pre" / "port_proc1" / "*ckpt*"))
