"""The semi-hard triplet slice of the port against the JAX package, on the
same numpy inputs: the device and host miners, the triplet losses, the
optimizers, the encoders (params carried across by convert.py) and the
fused and gathered triplet steps.  Tolerances at each assertion."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_similarity_tpu.data.device_feed import (
    quantize_features as jax_quantize)
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.models.encoders import (
    OutputLayer as JaxOutputLayer)
from multimodal_similarity_tpu.ops import losses as jl
from multimodal_similarity_tpu.ops.distances import (
    all_diffs as jax_all_diffs, cdist as jax_cdist, self_distance)
from multimodal_similarity_tpu.ops.mining import (
    mine_semihard_triplets as jax_mine,
    mine_semihard_triplets_from_embeddings as jax_mine_rows,
    select_triplets_facenet as jax_facenet,
    select_triplets_random as jax_random)
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu.train.state import (
    TrainState, build_optimizer as jax_build_optimizer)
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.models import OutputLayer, build_encoder
from multimodal_similarity_tpu_torch.ops import losses as tl
from multimodal_similarity_tpu_torch.ops import mining
from multimodal_similarity_tpu_torch.ops.distances import (
    cdist_rows, pairwise_distance)
from multimodal_similarity_tpu_torch.train.state import (
    apply_gradients, build_optimizer)
from multimodal_similarity_tpu_torch.train.steps import (
    make_gathered_triplet_step, make_triplet_train_step)


def _batch(rng, n=60, n_classes=5, d=8):
    """Overlapping clusters (semi-hard negatives exist), background 0."""
    labels = rng.randint(0, n_classes, size=n)
    centers = rng.randn(n_classes, d) * 0.5
    emb = centers[labels] + rng.randn(n, d)
    return emb.astype(np.float32), labels


def _jax_draws(key):
    """The Gumbel arrays ``jax.random.categorical`` draws inside the JAX
    miner for ``key``: split(key, 3), then split(k_n, R) for the
    negatives."""
    def draw(num_pairs, n, num_negative, generator, device):
        k_a, k_p, k_n = jax.random.split(key, 3)

        def gumbel(k):
            return torch.from_numpy(np.array(jax.random.gumbel(
                k, (num_pairs, n), jnp.float32))).to(device)

        return gumbel(k_a), gumbel(k_p), [
            gumbel(k) for k in jax.random.split(k_n, num_negative)]
    return draw


def _same_mined(got, want):
    for field in ("anchor", "positive", "negative", "mask"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    assert float(got.active_count) == float(want.active_count)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_negative", [1, 3])
def test_matrix_miner_fed_jax_draws_is_index_equal(rng, monkeypatch, masked,
                                                   num_negative):
    """Fed the JAX miner's Gumbel draws, the port's matrix miner picks the
    same anchors, positives, negatives, mask and active count (exact)."""
    emb, labels = _batch(rng)
    dists = np.array(self_distance(jnp.asarray(emb)))
    valid = (rng.rand(60) > 0.2).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(7)
    want = jax_mine(jnp.asarray(dists), jnp.asarray(labels), key, 31,
                    alpha=0.2, num_negative=num_negative,
                    valid=None if valid is None else jnp.asarray(valid))
    monkeypatch.setattr(mining, "_draw_gumbels", _jax_draws(key))
    got = mining.mine_semihard_triplets(
        torch.from_numpy(dists), torch.from_numpy(labels), None, 31,
        alpha=0.2, num_negative=num_negative,
        valid=None if valid is None else torch.from_numpy(valid))
    assert float(want.mask.sum()) > 0
    _same_mined(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_miner_fed_jax_draws_is_index_equal(monkeypatch, seed):
    """The row-wise miner (distances of the sampled anchors only) on
    integer-valued embeddings, whose Gram distances are exact in f32 on
    both sides: index-equal to the JAX row miner, mask and active count
    included."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, size=48)
    emb = (rng.randint(-2, 3, size=(48, 6))
           + 2 * np.eye(4)[labels][:, [0, 1, 2, 3, 0, 1]]).astype(np.float32)
    valid = (np.arange(48) < 44).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_mine_rows(jnp.asarray(emb), jnp.asarray(labels), key, 24,
                         alpha=2.5, num_negative=3, valid=jnp.asarray(valid))
    monkeypatch.setattr(mining, "_draw_gumbels", _jax_draws(key))
    got = mining.mine_semihard_triplets_from_embeddings(
        torch.from_numpy(emb), torch.from_numpy(labels), None, 24,
        alpha=2.5, num_negative=3, valid=torch.from_numpy(valid))
    assert float(want.mask.sum()) > 0
    _same_mined(got, want)


def test_public_miner_is_semihard_and_empty_without_anchors(rng):
    """The port's own draws: every unmasked triplet is semi-hard, same-class
    and valid; one generator seed gives one result; a batch where no class
    can anchor (background and singletons only) masks everything."""
    emb, labels = _batch(rng, n=80)
    valid = np.ones(80, np.float32)
    valid[-10:] = 0.0
    e, lab, v = (torch.from_numpy(a) for a in (emb, labels, valid))
    mined = mining.mine_semihard_triplets_from_embeddings(
        e, lab, torch.Generator().manual_seed(3), 48, alpha=0.2, valid=v)
    again = mining.mine_semihard_triplets_from_embeddings(
        e, lab, torch.Generator().manual_seed(3), 48, alpha=0.2, valid=v)
    assert torch.equal(mined.negative, again.negative)
    d = pairwise_distance(e, e).numpy()
    m = mined.mask.numpy()
    assert m.shape == (48,) and m.sum() > 0
    for a, p, n, k in zip(mined.anchor.numpy(), mined.positive.numpy(),
                          mined.negative.numpy(), m):
        if not k:
            continue
        assert labels[a] == labels[p] != 0 and a != p
        assert labels[n] != labels[a]
        assert valid[a] and valid[p] and valid[n]
        assert d[a, n] - d[a, p] < 0.2 and d[a, p] < d[a, n]

    lonely = torch.tensor([0, 0, 1, 2, 3, 0])
    none = mining.mine_semihard_triplets(
        torch.rand(6, 6), lonely, torch.Generator().manual_seed(0), 6)
    assert float(none.mask.sum()) == 0.0


def test_host_miners_index_equal(rng):
    """select_triplets_facenet (on the port's exact-difference distances)
    and select_triplets_random give the JAX package's index lists for the
    same random.Random seed."""
    emb, labels = _batch(rng)
    d_port = cdist_rows(torch.from_numpy(emb), torch.from_numpy(emb),
                        chunk=7).numpy()
    d_jax = np.asarray(jax_cdist(jax_all_diffs(jnp.asarray(emb),
                                               jnp.asarray(emb))))
    np.testing.assert_allclose(d_port, d_jax, rtol=1e-6, atol=1e-6)
    got = mining.select_triplets_facenet(labels, d_port, 30, 0.2, 3,
                                         rng=random.Random(5))
    want = jax_facenet(labels, d_jax, 30, 0.2, 3, rng=random.Random(5))
    assert got == want and len(got[0]) > 0
    assert mining.select_triplets_random(labels, 20, 3,
                                         rng=random.Random(6)) == \
        jax_random(labels, 20, 3, rng=random.Random(6))


def _triplets(rng, t=16, d=6):
    return [rng.randn(t, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("loss", ["plain", "margins", "masked", "empty",
                                  "weighted", "per_triplet"])
def test_triplet_losses_and_gradients_match(rng, loss):
    """Values and gradients (anchor, positive, negative) within 1e-6."""
    a, p, n = _triplets(rng)
    mask = (rng.rand(16) > 0.3).astype(np.float32)
    margins = rng.rand(16).astype(np.float32)
    probs = [rng.rand(16).astype(np.float32) for _ in range(2)]
    cases = {
        "plain": (jl.triplet_loss, tl.triplet_loss, (), {}),
        "margins": (jl.triplet_loss, tl.triplet_loss, (margins,), {}),
        "masked": (jl.triplet_loss_masked, tl.triplet_loss_masked,
                   (mask,), {"alpha": 0.5}),
        "empty": (jl.triplet_loss_masked, tl.triplet_loss_masked,
                  (np.zeros(16, np.float32),), {}),
        "weighted": (jl.weighted_triplet_loss, tl.weighted_triplet_loss,
                     tuple(probs), {"alpha": 0.3}),
        "per_triplet": (jl.weighted_triplet_loss_per_triplet,
                        tl.weighted_triplet_loss_per_triplet, tuple(probs),
                        {}),
    }
    jf, tf, extra, kw = cases[loss]

    def jax_value(a, p, n):
        out = jf(a, p, n, *map(jnp.asarray, extra), **kw)
        return out[0].sum() if isinstance(out, tuple) else out

    want, want_g = jax.value_and_grad(jax_value, argnums=(0, 1, 2))(
        *map(jnp.asarray, (a, p, n)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, p, n)]
    out = tf(*ts, *map(torch.from_numpy, extra), **kw)
    got = out[0].sum() if isinstance(out, tuple) else out
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-6)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-6, atol=1e-6)
    if isinstance(out, tuple):
        np.testing.assert_allclose(out[1].detach().numpy(), np.asarray(
            jf(*map(jnp.asarray, (a, p, n)), *map(jnp.asarray, extra),
               **kw)[1]), rtol=1e-6, atol=1e-6)


class _Toy(nn.Module):
    """A pretrained branch scope (0.1x gradients), a frozen scope and a
    plain layer."""

    def __init__(self):
        super().__init__()
        self.modality_sensors = nn.Linear(3, 2)
        self.tail = nn.Linear(2, 2)
        self.head = nn.Linear(2, 2)


def _toy_params(toy):
    return {k: {"kernel": getattr(toy, k).weight.detach().numpy().T.copy(),
                "bias": getattr(toy, k).bias.detach().numpy().copy()}
            for k in ("modality_sensors", "tail", "head")}


@pytest.mark.parametrize("name", ["ADAM", "ADAGRAD", "ADADELTA", "RMSPROP",
                                  "MOMENTUM", "SGD"])
def test_optimizers_match_optax(rng, name):
    """Five steps with a changing learning rate, the 0.1 branch scale on
    ``modality_sensors`` and ``tail`` frozen: params within 1e-6 of the
    optax chain after every step; the frozen layer does not move; the
    optimizer state survives a state_dict round trip."""
    torch.manual_seed(0)
    toy = _Toy()
    params = _toy_params(toy)
    frozen = _toy_params(toy)["tail"]
    state = TrainState.create(jax.tree.map(jnp.asarray, params),
                              jax_build_optimizer(name, 0.05,
                                                  frozen_scopes=("tail",)))
    opt = build_optimizer(name, toy, 0.05, frozen_scopes=("tail",))
    assert [g["grad_scale"] for g in opt.param_groups] == [1.0, 0.1, 0.0]
    for step, lr in enumerate((0.05, 0.03, 0.08, 0.02, 0.01)):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        state = state.apply_gradients(jax.tree.map(jnp.asarray, grads),
                                      learning_rate=jnp.float32(lr))
        for pname, g in flax_to_state_dict(grads, toy).items():
            toy.get_parameter(pname).grad = g.clone()
        apply_gradients(opt, lr)
        want = flax_to_state_dict(jax.tree.map(np.asarray, state.params),
                                  toy)
        for pname, p in toy.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[pname].numpy(), atol=1e-6,
                                       err_msg=f"{name} step {step} {pname}")
        if step == 2:
            fresh = build_optimizer(name, toy, 0.05, frozen_scopes=("tail",))
            fresh.load_state_dict(opt.state_dict())
            opt = fresh
    np.testing.assert_array_equal(toy.tail.weight.detach().numpy().T,
                                  frozen["kernel"])


ENCODERS = {
    "tsn": (dict(num_seg=3, emb_dim=16, n_input=8), (6, 3, 8)),
    "convtsn": (dict(num_seg=3, emb_dim=16, n_input=12, n_h=2, n_w=3,
                     n_C=5), (6, 3, 2, 3, 12)),
    "convbirtsn": (dict(num_seg=3, emb_dim=16, n_input=12, n_h=2, n_w=3,
                        n_C=5), (6, 3, 2, 3, 12)),
    "convlstm": (dict(max_time=7, emb_dim=16, n_input=12, n_h=2, n_w=3,
                      n_C=5), (6, 7, 2, 3, 12)),
}


def _jax_module_and_port(network, x):
    if network == "output":
        jm = JaxOutputLayer(10)
        tm = OutputLayer(x.shape[-1], 10)
    else:
        kw, _ = ENCODERS[network]
        jm = jax_build(network, **kw)
        tm = build_encoder(network, **kw)
    return jm, tm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("network", ["tsn", "convtsn", "convbirtsn",
                                     "convlstm", "output"])
def test_encoder_forward_and_gradient_match(network, dtype):
    """Eval outputs within 1e-5 and parameter gradients of a random
    projection of the outputs within 1e-5 (rtol 1e-4), params carried by
    convert.py; bf16 inputs reach the same f32 math on both sides."""
    rng = np.random.RandomState(5)
    shape = (6, 9) if network == "output" else ENCODERS[network][1]
    x = rng.randn(*shape).astype(np.float32)
    seq_len = np.array([7, 1, 3, 5, 6, 2])
    jm, tm = _jax_module_and_port(network, x)
    args = (jnp.asarray(x),) + ((jnp.asarray(seq_len),)
                                if network == "convlstm" else ())
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), params)                      # nonzero biases
    load_flax_params(tm, params)
    if dtype == "bf16":
        args = (args[0].astype(jnp.bfloat16),) + args[1:]
    cot = rng.randn(6, 10 if network == "output" else 16).astype(np.float32)

    def jax_loss(p):
        out = jm.apply({"params": p}, *args)
        return (out * cot).sum(), out

    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    targs = [torch.from_numpy(np.array(args[0].astype(jnp.float32)))]
    if dtype == "bf16":
        targs[0] = targs[0].to(torch.bfloat16)
    if network == "convlstm":
        targs.append(torch.from_numpy(seq_len))
    tm.eval()
    got = tm(*targs)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, want_g), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


SMALL = dict(num_seg=3, emb_dim=16, n_input=8, n_h=2, n_w=2, n_C=4)


def _rounded_dequant(x):
    """The JAX dequantization with its stated bf16 rounding kept: XLA's
    compiled step may keep q * scale in f32 (allow_excess_precision)."""
    if isinstance(x, dict) and "q" in x:
        return jax.lax.reduce_precision(
            x["q"].astype(jnp.float32)
            * x["scale"].astype(jnp.bfloat16).astype(jnp.float32),
            exponent_bits=8, mantissa_bits=7).astype(jnp.bfloat16)
    return x


def _step_inputs(rng, features):
    x = rng.randn(48, 3, 2, 2, 8).astype(np.float32)
    labels = np.repeat(np.arange(0, 8), 6)
    mask = (np.arange(48) < 44).astype(np.float32)
    jm = jax_build("convrtsn", **SMALL)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    tm = build_encoder("convrtsn", **SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    if features == "int8":
        q, s = jax_quantize(x)
        jx = {"q": jnp.asarray(q), "scale": jnp.asarray(s)}
        tx = {"q": torch.from_numpy(q), "scale": torch.from_numpy(s)}
    elif features == "bf16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    return jm, params, tm, jx, tx, labels, mask


def _same_params(tm, state):
    want = flax_to_state_dict(jax.tree.map(np.asarray, state.params), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("features", ["f32", "bf16", "int8"])
def test_fused_triplet_step_matches_jax(rng, monkeypatch, features):
    """One fused step (eval-mode embed, mining on the JAX draws, train-mode
    re-forward of the mined triplets, Adam), dropout off: the same mined
    count and active count, loss within rtol 1e-5, params within 1e-6."""
    monkeypatch.setattr(jax_steps, "dequant_features", _rounded_dequant)
    jm, params, tm, jx, tx, labels, mask = _step_inputs(rng, features)
    key = jax.random.PRNGKey(11)
    state = TrainState.create(params, jax_build_optimizer("ADAM", 0.01))
    step = jax_steps.make_triplet_train_step(
        jm, triplet_per_batch=12, alpha=0.2, num_negative=3,
        lambda_l2=1e-3)
    state, want = step(state, jx, jnp.asarray(labels), jnp.asarray(mask),
                       key, jnp.float32(0.01))
    monkeypatch.setattr(mining, "_draw_gumbels",
                        _jax_draws(jax.random.split(key)[0]))
    opt = build_optimizer("ADAM", tm, 0.01)
    got = make_triplet_train_step(
        tm, opt, triplet_per_batch=12, alpha=0.2, num_negative=3,
        lambda_l2=1e-3)(tx, torch.from_numpy(labels),
                        torch.from_numpy(mask), 0.01)
    assert float(got["triplet_num"]) == float(want["triplet_num"]) > 0
    np.testing.assert_allclose(float(got["active_count"]),
                               float(want["active_count"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    _same_params(tm, state)
    assert tm.training


def test_gathered_triplet_step_matches_jax(rng):
    """One step on host-mined [a; p; n] indices with a partial mask: the
    loss within rtol 1e-5 and params within 1e-6 of the JAX step's."""
    jm, params, tm, jx, tx, labels, _ = _step_inputs(rng, "f32")
    tri = rng.randint(0, 48, size=36)
    tri_mask = (np.arange(12) < 9).astype(np.float32)
    state = TrainState.create(params, jax_build_optimizer("MOMENTUM", 0.05))
    state, want = jax_steps.make_gathered_triplet_step(jm, alpha=0.3)(
        state, jx, jnp.asarray(tri), jnp.asarray(tri_mask),
        jax.random.PRNGKey(0), jnp.float32(0.05))
    opt = build_optimizer("MOMENTUM", tm, 0.05)
    got = make_gathered_triplet_step(tm, opt, alpha=0.3)(
        tx, torch.from_numpy(tri), torch.from_numpy(tri_mask), 0.05)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert float(got["triplet_num"]) == 9.0
    _same_params(tm, state)
