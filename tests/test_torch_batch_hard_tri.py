"""The port's triangular batch-hard path (algo="tri" and "auto" of
ops/kernels/batch_hard.py, K3 in ops/kernels/batch_hard_tri.py) against the
JAX package's triangular Pallas kernel (interpret mode on the CPU, block 16),
on the same numpy inputs.  On a CPU tensor every algo runs the plain PyTorch
version; the CUDA kernel itself is held bit-equal to K1/K2 on the card by
chip_smoke.py.

Tolerances: f32 stats and losses 1e-4 (summation order of the distance
products differs between XLA and PyTorch); gradients rtol 1e-3 / atol 1e-5
as the JAX package's own kernel tests; bf16 5e-2 (operand rounding, and the
TPU kernel's bf16 epilogue)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops.pallas import (
    batch_hard_pallas, fused_batch_hard_stats as jax_fused_stats)
from multimodal_similarity_tpu.ops.pallas.batch_hard import _stats_impl
from multimodal_similarity_tpu_torch.ops.kernels import (
    LAUNCHES, batch_hard_fused, fused_batch_hard_stats, use_triangular)
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    Operands, batch_hard_stats, prep_operands)
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard_tri import (
    tri_stats_kernel, tri_tile)
from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import tri_block

BLOCK = 16
# (n, valid): aligned and ragged N over blocks of 16, with and without a
# valid mask
CASES = [pytest.param(64, False, id="aligned"),
         pytest.param(37, False, id="ragged"),
         pytest.param(70, True, id="ragged-valid")]


def _clustered(rng, n, n_classes=5, dim=24):
    labels = rng.randint(0, n_classes, size=n)
    centers = rng.randn(n_classes, dim)
    emb = (centers[labels] + 0.8 * rng.randn(n, dim)).astype(np.float32)
    labels[:3] = 1
    return emb, labels


def _valid(rng, n, masked):
    return (rng.rand(n) > 0.2).astype(np.float32) if masked else None


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n,masked", CASES)
@pytest.mark.parametrize("algo", ["tri", "auto"])
def test_stats_match_jax_tri(rng, n, masked, algo):
    emb, labels = _clustered(rng, n)
    valid = _valid(rng, n, masked)
    fp, cn, nc = fused_batch_hard_stats(_t(emb), _t(labels), _t(valid),
                                        "f32", algo)
    jfp, jcn, jnc = jax_fused_stats(_j(emb), _j(labels), _j(valid), BLOCK,
                                    "f32", "tri")
    _close(fp, jfp)
    _close(cn, jcn)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))


@pytest.mark.parametrize("n,masked", CASES)
def test_winners_equal_jax_tri(rng, n, masked):
    """The winner columns equal the triangular TPU kernel's, row side and
    column side alike, lowest index first on ties."""
    emb, labels = _clustered(rng, n)
    valid = _valid(rng, n, masked)
    ops = prep_operands(_t(emb), _t(labels),
                        _t(valid) if masked else torch.ones(n), "f32")
    fp, cn, nc, fpi, cni = batch_hard_stats(ops, True, "tri")
    jfp, jcn, jnc, jfpi, jcni = _stats_impl(_j(emb), _j(labels), _j(valid),
                                            BLOCK, "f32", "tri")
    _close(fp, jfp)
    _close(cn, jcn)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))
    np.testing.assert_array_equal(fpi.numpy(), np.asarray(jfpi))
    np.testing.assert_array_equal(cni.numpy(), np.asarray(jcni))


def test_winner_ties_take_lowest_index():
    """Duplicated rows on both sides of a tile boundary: every tie resolves
    to the lowest index, as the TPU's column side does (batch_hard_tri.py
    :170-184)."""
    base = np.array([[0, 0], [1, 0], [0, 2], [5, 5]], np.float32)
    emb = np.concatenate([base] * 5)          # 20 rows over blocks of 16
    labels = np.array([1, 2, 1, 3] * 5)
    ops = prep_operands(_t(emb), _t(labels), torch.ones(20), "f32")
    got = batch_hard_stats(ops, True, "tri")
    want = _stats_impl(_j(emb), _j(labels), None, BLOCK, "f32", "tri")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # row 0's closest negatives are the copies of [1, 0]: the lowest is 1
    assert got[4][0].item() == 1 and got[3][0].item() == 2


@pytest.mark.parametrize("margin", ["soft", 0.5])
@pytest.mark.parametrize("n,masked", CASES)
def test_loss_tuple_matches_jax_tri(rng, n, masked, margin):
    emb, labels = _clustered(rng, n)
    valid = _valid(rng, n, masked)
    got = batch_hard_fused(_t(emb), _t(labels), margin, True, _t(valid),
                           "f32", "tri")
    want = batch_hard_pallas(_j(emb), _j(labels), margin, True, _j(valid),
                             BLOCK, "f32", "tri")
    for k in range(6):
        _close(got[k].detach().numpy(), want[k])


@pytest.mark.parametrize("algo", ["tri", "auto"])
def test_gradient_matches_jax_grad(rng, algo):
    emb, labels = _clustered(rng, 70, dim=16)
    valid = _valid(rng, 70, True)
    e = _t(emb).clone().requires_grad_(True)
    batch_hard_fused(e, _t(labels), "soft", True, _t(valid), "f32",
                     algo)[0].backward()

    def loss_tri(x):
        return batch_hard_pallas(x, _j(labels), "soft", True, _j(valid),
                                 BLOCK, "f32", "tri")[0]

    g = np.asarray(jax.grad(loss_tri)(_j(emb)))
    np.testing.assert_allclose(e.grad.numpy(), g, rtol=1e-3, atol=1e-5)


def test_bf16_close_to_f32_and_jax(rng):
    emb, labels = _clustered(rng, 80)
    fp16, cn16, _ = fused_batch_hard_stats(_t(emb), _t(labels), None,
                                           "bf16", "tri")
    fp32, cn32, _ = fused_batch_hard_stats(_t(emb), _t(labels), None, "f32",
                                           "tri")
    jfp, jcn, _ = jax_fused_stats(_j(emb), _j(labels), None, BLOCK, "bf16",
                                  "tri")
    for got, want in ((fp16, fp32), (cn16, cn32), (fp16, jfp), (cn16, jcn)):
        _close(got, want, 5e-2)


def test_algos_agree_on_cpu_and_count_no_launch(rng):
    """On CPU tensors tri, auto and row are the same plain version, with
    and without a gradient, and no kernel launch is counted."""
    emb, labels = _clustered(rng, 50)
    before = dict(LAUNCHES)
    outs = {}
    for algo in ("tri", "auto", "row"):
        with torch.no_grad():
            ng = fused_batch_hard_stats(_t(emb), _t(labels), None, "bf16",
                                        algo)
        e = _t(emb).clone().requires_grad_(True)
        loss = batch_hard_fused(e, _t(labels), "soft", True, None, "bf16",
                                algo)
        loss[0].backward()
        outs[algo] = (*ng, loss[0].detach(), e.grad)
    for algo in ("auto", "row"):
        for a, b in zip(outs["tri"], outs[algo]):
            assert torch.equal(a, b)
    assert LAUNCHES == before


def test_kernel_entry_needs_cuda_and_plain_needs_cpu():
    """No fallback: the kernel refuses CPU operands, and a device without
    a kernel raises rather than taking the plain version."""
    ops = prep_operands(torch.randn(8, 4), torch.arange(8) % 3,
                        torch.ones(8), "f32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tri_stats_kernel(ops, True)
    meta = Operands(*(t.to("meta") for t in ops))
    with pytest.raises(ValueError, match="no batch-hard kernel"):
        batch_hard_stats(meta, False, "tri")


# (n, d, sms) -> (use_triangular, K3's bf16 tile edge) on an H100 (132 SMs)
# and a smaller card, as measured: K1 up to N=128 and at d=128 once its
# 64-row blocks fill the SMs (N=8192, 16384) or at N=256; K3 otherwise,
# the trainer's N=512 and the kernel sweep's d=1024 included; 128-wide
# tiles once their pairs fill the SMs
GATE_TABLE = [
    (16, 128, 132, False, 64),
    (64, 1024, 132, False, 64),
    (128, 128, 132, False, 64),
    (512, 128, 132, True, 64),
    (700, 90, 132, True, 64),
    (1000, 72, 132, True, 64),
    (8192, 1024, 132, True, 128),
    (16384, 1024, 132, True, 128),
    (512, 128, 16, True, 64),
    (256, 128, 132, False, 64),
    (256, 512, 132, True, 64),
    (4096, 128, 132, True, 128),
    (8192, 128, 132, False, 128),
    (16384, 512, 132, True, 128),
    (2048, 128, 16, False, 128),
]


@pytest.mark.parametrize("n,d,sms,tri,tile", GATE_TABLE)
def test_gate_and_tile_table(n, d, sms, tri, tile):
    assert use_triangular(n, d, sms) is tri
    assert tri_tile(n, sms, True) == tile


# (n, sms, bf16) -> K3's tile edge: bf16 takes 128 from the first N whose
# 128-row tile pairs fill the SMs (16 tiles, 136 pairs, on 132 SMs: N >
# 1920), else 64; f32 keeps K6's FMA tiles (64 once their pairs fill the
# SMs, else 32)
TILE_TABLE = [
    (1, 132, True, 64),
    (1920, 132, True, 64),
    (1921, 132, True, 128),
    (4500, 132, True, 128),
    (768, 16, True, 128),
    (640, 16, True, 64),
    (512, 16, True, 64),
    (512, 132, False, 32),
    (700, 132, False, 32),
    (1000, 132, False, 64),
    (8192, 132, False, 64),
]


@pytest.mark.parametrize("n,sms,bf16,tile", TILE_TABLE)
def test_tri_tile_table(n, sms, bf16, tile):
    assert tri_tile(n, sms, bf16) == tile
    if not bf16:
        assert tile == tri_block(n, sms)
