"""The port's InceptionV2 tower (``…_torch/models/inception_v2.py``) against
the flax one: the parameter count, the endpoint table and shapes, the
forward in train and eval mode with the batch-norm running statistics
after a training step, ``convert.py`` on conv kernels and batch stats, and
one ``base_CUB --network inception_v2`` step against the JAX trainer.
Tolerances at each assertion."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.models import CUBLayer as JaxCUBLayer
from multimodal_similarity_tpu.models.inception_v2 import (
    ENDPOINT_CHANNELS as JAX_ENDPOINT_CHANNELS, InceptionV2 as JaxInception)
from multimodal_similarity_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpoints)
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu.train.trainers import base_CUB as jax_base_CUB
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.models import (
    ENDPOINT_CHANNELS, InceptionV2)
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.train.state import build_optimizer
from multimodal_similarity_tpu_torch.train.trainers import base_CUB

# training-mode batch norm in f32 through ~70 layers, relative to each
# tensor's scale (see test_forward_matches_flax)
TRAIN_TOL = 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(size, seed=0):
    """flax variables with random BN betas and running statistics (the
    init values, zero betas, zero means and unit variances, would not
    exercise the mapping)."""
    v = jax.jit(JaxInception().init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                      if p[-1].key == "bias" else a), v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.2 * rng.randn(*a.shape).astype(np.float32)
                      if p[-1].key == "mean" else
                      rng.uniform(0.5, 2.0, a.shape).astype(np.float32)),
        v["batch_stats"])
    return params, stats


def _close(got, want, tol, err_msg=""):
    """Every element within ``tol`` of ``want``'s largest magnitude."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=err_msg)


def test_param_count_is_the_slim_table():
    shapes = jax.eval_shape(JaxInception().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    jax_count = sum(int(np.prod(p.shape))
                    for p in jax.tree_util.tree_leaves(shapes["params"]))
    got = sum(p.numel() for p in InceptionV2().parameters())
    assert got == jax_count == 10_153_336


def test_endpoints_at_224():
    """The endpoint table is the JAX one, and each endpoint has its
    channel count at the slim spatial size (NCHW here)."""
    assert ENDPOINT_CHANNELS == JAX_ENDPOINT_CHANNELS
    spatial = {"Conv2d_1a_7x7": 112, "Conv2d_2b_1x1": 56,
               "Conv2d_2c_3x3": 56, "Mixed_3b": 28, "Mixed_3c": 28,
               "Mixed_4a": 14, "Mixed_4b": 14, "Mixed_4c": 14,
               "Mixed_4d": 14, "Mixed_4e": 14, "Mixed_5a": 7,
               "Mixed_5b": 7, "Mixed_5c": 7}
    model = InceptionV2(capture_endpoints=True).eval()
    with torch.no_grad():
        pool, endpoints = model(torch.zeros(1, 224, 224, 3))
    assert tuple(pool.shape) == (1, 1024)
    assert endpoints.keys() == ENDPOINT_CHANNELS.keys()
    for k, ch in ENDPOINT_CHANNELS.items():
        assert tuple(endpoints[k].shape) == (1, ch, spatial[k], spatial[k]), k


def _moved_stats(model):
    """Each batch norm's running statistics over (1 - momentum): the batch
    mean and variance a training step from zero statistics moved them
    to."""
    return {f"{name}.{buf}": getattr(mod, buf).numpy() / (1.0 - mod.momentum)
            for name, mod in model.named_modules()
            if hasattr(mod, "running_mean")
            for buf in ("running_mean", "running_var")}


@pytest.mark.parametrize("size,batch", [(64, 4), (224, 2)])
def test_forward_matches_flax(size, batch):
    """Eval mode (running statistics): the pooled output and every
    endpoint at 1e-5 of each tensor's scale (5e-7 observed).

    Training mode (batch statistics): the same at TRAIN_TOL = 2e-3 of the
    scale, and the batch mean and biased variance each batch norm moved
    its running statistics towards (from zero statistics, so the buffers
    hold them times 1 - momentum) against flax's at the same tolerance.
    The train-mode gap is f32 noise of the batch variance, which grows
    with depth to 1.1e-3 at 64 x 64 x 4 (the last blocks normalise over 16
    values) and 1.1e-4 at 224 x 224 x 2; the port's own float64 run of the
    same weights lies within 1.4e-4 / 2.8e-5 of its f32 run, and is held
    within 5e-4 here.  An unbiased variance would be off by 1/15 at the
    last blocks at 64, far beyond it.  64 and 224 take the asymmetric TF
    SAME pads at every stride-2 layer."""
    params, stats = _variables(size)
    x = np.random.RandomState(1).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)
    jm = JaxInception(capture_endpoints=True)
    tm = load_flax_params(InceptionV2(capture_endpoints=True), _np(params),
                          _np(stats))
    variables = {"params": params, "batch_stats": stats}

    want, want_ep = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_ep = tm.eval()(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), 1e-5, "eval pool")
    for k in ENDPOINT_CHANNELS:
        _close(got_ep[k].permute(0, 2, 3, 1).numpy(), np.asarray(want_ep[k]),
               1e-5, f"eval {k}")

    # zero running statistics, so that a step's buffers hold the batch
    # statistics times (1 - momentum) exactly enough to compare
    zeros = jax.tree.map(jnp.zeros_like, stats)
    (want, want_ep), new = jax.jit(functools.partial(
        jm.apply, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": zeros}, jnp.asarray(x))
    load_flax_params(tm, _np(params), _np(zeros))
    with torch.no_grad():
        got, got_ep = tm.train()(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), TRAIN_TOL, "train pool")
    for k in ENDPOINT_CHANNELS:
        _close(got_ep[k].permute(0, 2, 3, 1).numpy(), np.asarray(want_ep[k]),
               TRAIN_TOL, f"train {k}")
    got_stats = _moved_stats(tm)
    want_stats = _moved_stats(load_flax_params(
        InceptionV2(), _np(params), _np(new["batch_stats"])))
    assert got_stats.keys() == want_stats.keys() and len(got_stats) == 2 * 69
    for k in got_stats:
        _close(got_stats[k], want_stats[k], TRAIN_TOL, k)

    with torch.no_grad():
        exact = tm.double().train()(torch.from_numpy(x).double())[0]
    _close(got.numpy(), exact.numpy(), 5e-4, "train pool against f64")


def test_convert_rejects_bad_conv_and_bn_leaves():
    """A missing or misshaped conv kernel, a missing or misshaped batch
    stat, an unknown stat and a 3-D kernel all raise."""
    shapes = jax.eval_shape(JaxInception().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    params, stats = (jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes[c])
                     for c in ("params", "batch_stats"))
    model = InceptionV2()
    load_flax_params(model, params, stats)        # the whole tree maps

    def edit(tree, path, value):
        tree = jax.tree.map(lambda a: a, tree)     # a copy
        node = tree
        for key in path[:-1]:
            node = node[key]
        if value is None:
            del node[path[-1]]
        else:
            node[path[-1]] = value
        return tree

    conv = ("Mixed_4b_Branch_2_Conv2d_0b_3x3", "kernel")
    bn = ("Mixed_4b_Branch_2_Conv2d_0b_3x3_BatchNorm", "var")
    with pytest.raises(KeyError, match="no JAX leaf"):
        flax_to_state_dict(edit(params, conv, None), model, stats)
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(edit(params, conv, np.zeros((3, 3, 96, 129),
                                                       np.float32)),
                           model, stats)
    with pytest.raises(ValueError, match="4-D Conv"):
        flax_to_state_dict(edit(params, conv, np.zeros((3, 3, 96),
                                                       np.float32)),
                           model, stats)
    with pytest.raises(KeyError, match="running_var"):
        flax_to_state_dict(params, model, edit(stats, bn, None))
    with pytest.raises(KeyError, match="running_mean"):
        flax_to_state_dict(params, model)          # no batch stats at all
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(params, model,
                           edit(stats, bn, np.ones(7, np.float32)))
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(params, model, edit(
            stats, (bn[0], "count"), np.ones(128, np.float32)))


def test_inception_base_cub_step_matches_jax_trainer(tmp_path):
    """One ``base_CUB --network inception_v2`` step (semi-hard triplet
    loss, Adam, the tower's gradients at 0.1x) at crop = image size, from
    the JAX trainer's initial variables: the step's loss at rtol 1e-4, val
    mAP and recall@1 after it at atol 1e-3, and the saved weights and
    running statistics against the JAX checkpoint's.  The tower's update
    is held as a whole (relative L2 error under 10%): at 32 x 32 the last
    blocks are 1 x 1 and normalise over the batch alone, and the JAX f32
    gradient of a conv feeding a batch norm there is up to 26% off the JAX
    float64 one (a difference of large terms), while the port in float64
    agrees with JAX float64 to 3e-7 (a check made at this shape).  The
    head's update within 2e-3 of its scale, the running means (from 0)
    within TRAIN_TOL of theirs, the running variances (from 1) within
    1e-6."""
    rng = np.random.RandomState(0)
    size, n_cls = 32, 8
    tint = rng.rand(n_cls, 1, 1, 3)
    lab = np.repeat(np.arange(n_cls), 6)
    lab_te = np.repeat(np.arange(1, 5), 4)
    data = {
        "image_train": np.clip(tint[lab] + 0.3 * rng.rand(48, size, size, 3),
                               0, 1).astype(np.float32),
        "label_train": lab,
        "image_test": np.clip(tint[lab_te - 1]
                              + 0.3 * rng.rand(16, size, size, 3),
                              0, 1).astype(np.float32),
        "label_test": lab_te}
    kw = dict(name="t", silent_mode=True, emb_dim=16, learning_rate=1e-3,
              keep_prob=1.0, max_epochs=1, network="inception_v2",
              loss="triplet", DATA_ROOT=str(tmp_path))
    jcfg, pcfg = JaxTrainConfig(**kw).resolve(), TrainConfig(**kw).resolve()

    key = jax.random.PRNGKey(jcfg.seed)
    bvars = JaxInception().init(key, jnp.asarray(
        data["image_train"][:2]))
    params = {"InceptionV2": bvars["params"],
              "CUBLayer": JaxCUBLayer(n_output=16).init(
                  key, jnp.zeros((2, 1024)))["params"]}
    model = base_CUB.build_model(pcfg, "cpu")
    load_flax_params(model, _np(params),
                     {"InceptionV2": _np(bvars["batch_stats"])})
    pcfg.model_path = str(tmp_path / "init.pt")
    save_checkpoint(pcfg.model_path, model,
                    build_optimizer("ADAM", model, 1e-3), 0)

    state, want_metrics, jax_dir = jax_base_CUB.train(
        jcfg, data=data, crop=size, result_dir=str(tmp_path / "jax"))
    res = base_CUB.train(pcfg, data=data, crop=size,
                         result_dir=str(tmp_path / "port"), device="cpu")

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f
                    if '"loss"' in line]

    np.testing.assert_allclose(losses(res.result_dir), losses(jax_dir),
                               rtol=1e-4)
    np.testing.assert_allclose(
        [res.metrics["val_mAP"], res.metrics["val_recall@1"]],
        [want_metrics["val_mAP"], want_metrics["val_recall@1"]], atol=1e-3)

    template = {"state": TrainState.create(params, jax_build_optimizer(
        "ADAM", 1e-3)), "batch_stats": bvars["batch_stats"]}
    saved = JaxCheckpoints(jax_dir, "t").restore(template)
    want, init = ({k: v.numpy() for k, v in flax_to_state_dict(
        _np(p), model, {"InceptionV2": _np(b)}).items()}
        for p, b in ((saved["state"].params, saved["batch_stats"]),
                     (params, bvars["batch_stats"])))
    got = {k: v.numpy() for k, v in res.model.state_dict().items()}
    tower = [k for k, _ in res.model.named_parameters()
             if k.startswith("InceptionV2.")]
    d_got = np.concatenate([(got[k] - init[k]).ravel() for k in tower])
    d_want = np.concatenate([(want[k] - init[k]).ravel() for k in tower])
    rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
    worst = max((float(np.abs(got[k] - want[k]).max()
                       / np.abs(want[k] - init[k]).max()), k)
                for k in got if k.startswith("CUBLayer."))
    mean = [k for k in got if k.endswith("running_mean")]
    moved = max(float(np.abs(got[k] - want[k]).max()
                      / np.abs(want[k]).max()) for k in mean)
    var = max(float(np.abs(got[k] - want[k]).max())
              for k in got if k.endswith("running_var"))
    # tower: the whole update within 10% (L2) of the JAX one (2.9%
    # observed; a missing 0.1x branch scale would be 900% off)
    assert rel < 0.1, rel
    assert worst[0] < 2e-3, worst           # 4.6e-4 observed
    assert moved < TRAIN_TOL, moved         # 2.4e-5 observed
    assert var < 1e-6, var                  # 6e-8 observed
