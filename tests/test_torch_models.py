"""The port's encoders against the JAX package's flax modules, with the
flax params mapped by convert.py; eval outputs agree to 1e-5 (f32, the
same operations in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.models.lstm import LSTM as JaxLSTM
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.models import LSTM, build_encoder

CASES = {
    "convrtsn": dict(num_seg=3, emb_dim=16, n_input=12, n_h=2, n_w=3,
                     n_C=5),
    "rtsn": dict(num_seg=3, emb_dim=16, n_input=8),
}
SHAPES = {"convrtsn": (6, 3, 2, 3, 12), "rtsn": (6, 3, 8)}


def _pair(network, keep_prob=1.0):
    kw = CASES[network]
    x = np.random.RandomState(1).randn(*SHAPES[network]).astype(np.float32)
    jm = jax_build(network, keep_prob=keep_prob, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    tm = build_encoder(network, keep_prob=keep_prob, **kw)
    load_flax_params(tm, params)
    return x, jm, variables, tm, params


@pytest.mark.parametrize("network", ["convrtsn", "rtsn"])
def test_encoder_eval_outputs_match_jax(network):
    x, jm, variables, tm, _ = _pair(network, keep_prob=0.5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], CASES[network]["emb_dim"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lstm_cell_gate_order_and_forget_bias():
    """The fused [x; h] weight, the (i, j, f, o) gate split and the +1.0
    forget bias: outputs and final state over 4 steps equal flax's."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 5).astype(np.float32)
    jm = JaxLSTM(7)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # nonzero biases so the forget-bias offset and gate order both matter
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), variables["params"])
    j_out, (j_c, j_h) = jm.apply({"params": params}, jnp.asarray(x))
    tm = LSTM(5, 7)
    load_flax_params(tm, params)
    with torch.no_grad():
        t_out, (t_c, t_h) = tm(torch.from_numpy(x))
    for got, want in ((t_out, j_out), (t_c, j_c), (t_h, j_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_convert_rejects_missing_and_extra_leaves():
    _, _, _, tm, params = _pair("convrtsn")
    state = flax_to_state_dict(params, tm)
    assert set(state) == set(tm.state_dict())
    assert state["embed.conv1x1.weight"].shape == (5, 12)  # [out, in]

    missing = {"embed": params["embed"]}
    with pytest.raises(KeyError, match="no JAX leaf"):
        flax_to_state_dict(missing, tm)

    extra = dict(params, head={"kernel": np.zeros((16, 2), np.float32)})
    with pytest.raises(KeyError, match="extra JAX leaf"):
        flax_to_state_dict(extra, tm)

    odd = {"embed": {"conv1x1": dict(params["embed"]["conv1x1"],
                                     scale=np.ones(5, np.float32))},
           "lstm": params["lstm"]}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(odd, tm)

    wrong = {"embed": {"conv1x1": {
        "kernel": np.zeros((12, 6), np.float32),
        "bias": params["embed"]["conv1x1"]["bias"]}},
        "lstm": params["lstm"]}
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(wrong, tm)


def test_init_is_xavier_uniform_with_zero_bias():
    gen = torch.Generator().manual_seed(0)
    tm = build_encoder("convrtsn", n_input=1536, n_C=20, emb_dim=128,
                       generator=gen)
    w = tm.embed.conv1x1.weight.detach()
    limit = (6.0 / (1536 + 20)) ** 0.5
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    assert float(tm.embed.conv1x1.bias.detach().abs().max()) == 0.0
    again = build_encoder("convrtsn", n_input=1536, n_C=20, emb_dim=128,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.lstm.cell.kernel.weight,
                       tm.lstm.cell.kernel.weight)
