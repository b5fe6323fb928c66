"""The port's batch-hard stats and loss (ops/kernels/batch_hard.py) against
the JAX package's Pallas kernels (interpret mode on the CPU) and dense
oracles, on the same numpy inputs.  On a CPU tensor the port runs its plain
PyTorch version; the CUDA kernel itself is checked against that version on
the card by chip_smoke.py.

Tolerances: f32 stats and losses 1e-4 (summation order of the distance
products differs between XLA and PyTorch); gradients rtol 1e-3 / atol 1e-5
as the JAX package's own kernel tests; bf16 5e-2 (operand rounding, as the
JAX package's bf16 test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops.distances import self_distance
from multimodal_similarity_tpu.ops.losses import batch_hard as jax_batch_hard
from multimodal_similarity_tpu.ops.pallas import (
    batch_hard_pallas, fused_batch_hard_stats as jax_fused_stats)
from multimodal_similarity_tpu.ops.pallas.batch_hard import _stats_pallas
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels import (
    LAUNCHES, batch_hard_fused, fused_batch_hard_stats)
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    pad_depth, prep_operands, stats_plain, tma_operand)
from multimodal_similarity_tpu_torch.ops.losses import batch_hard


def _clustered(rng, n=70, n_classes=5, dim=24):
    labels = rng.randint(0, n_classes, size=n)
    centers = rng.randn(n_classes, dim)
    emb = (centers[labels] + 0.8 * rng.randn(n, dim)).astype(np.float32)
    return emb, labels


def _dense_stats(emb, labels, valid=None):
    n = emb.shape[0]
    d = np.asarray(self_distance(jnp.asarray(emb)))
    same = labels[:, None] == labels[None, :]
    colmask = np.ones(n, bool) if valid is None else np.asarray(valid) > 0
    pos_m = same & ~np.eye(n, dtype=bool) & colmask[None, :]
    neg_m = ~same & colmask[None, :]
    return (d * pos_m).max(1), np.where(neg_m, d, 1e30).min(1), neg_m.sum(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_fused_stats_match_dense_and_jax(rng):
    emb, labels = _clustered(rng)
    fp, cn, nc = fused_batch_hard_stats(_t(emb), _t(labels), None, "f32")
    want_fp, want_cn, want_nc = _dense_stats(emb, labels)
    jfp, jcn, jnc = jax_fused_stats(jnp.asarray(emb), jnp.asarray(labels),
                                    None, 32, "f32")
    for got, dense, jax_out in ((fp, want_fp, jfp), (cn, want_cn, jcn)):
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(nc.numpy(), want_nc)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))


def test_fused_stats_respect_valid_mask(rng):
    emb, labels = _clustered(rng, n=40)
    valid = (np.arange(40) < 30).astype(np.float32)
    fp, cn, nc = fused_batch_hard_stats(_t(emb), _t(labels), _t(valid),
                                        "f32")
    want_fp, want_cn, want_nc = _dense_stats(emb, labels, valid)
    jfp, jcn, jnc = jax_fused_stats(jnp.asarray(emb), jnp.asarray(labels),
                                    jnp.asarray(valid), 16, "f32")
    np.testing.assert_allclose(fp.numpy(), want_fp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cn.numpy(), want_cn, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cn.numpy(), np.asarray(jcn), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(nc.numpy(), want_nc)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jnc))


def test_winner_indices_equal_jax_in_f32(rng):
    """The winner columns (fpi, cni) of the plain version equal the TPU
    kernel's, lowest column first on ties, exactly."""
    emb, labels = _clustered(rng, n=70)
    valid = (rng.rand(70) > 0.2).astype(np.float32)
    ops = prep_operands(_t(emb), _t(labels), _t(valid), "f32")
    fp, cn, nc, fpi, cni = stats_plain(ops, True)
    jfp, jcn, jnc, jfpi, jcni = _stats_pallas(
        jnp.asarray(emb), jnp.asarray(labels, jnp.float32),
        jnp.asarray(valid), 32, "f32")
    np.testing.assert_array_equal(fpi.numpy(), np.asarray(jfpi))
    np.testing.assert_array_equal(cni.numpy(), np.asarray(jcni))


def test_winner_ties_take_lowest_column():
    """Exact ties (duplicated rows, a class with no negative, a row with
    no positive) resolve to the lowest column, as on the TPU."""
    emb = np.array([[0, 0], [1, 0], [1, 0], [0, 2], [0, 2], [5, 5]],
                   np.float32)
    labels = np.array([1, 2, 2, 1, 1, 3])
    ops = prep_operands(_t(emb), _t(labels), torch.ones(6), "f32")
    fp, cn, nc, fpi, cni = stats_plain(ops, True)
    jfp, jcn, jnc, jfpi, jcni = _stats_pallas(
        jnp.asarray(emb), jnp.asarray(labels, jnp.float32), jnp.ones(6),
        8, "f32")
    np.testing.assert_array_equal(fpi.numpy(), np.asarray(jfpi))
    np.testing.assert_array_equal(cni.numpy(), np.asarray(jcni))
    # row 1's two nearest negatives tie at distance 1 (columns 0 and ...):
    # duplicates 1 and 2 share every distance, so cni picks the lower one
    assert cni[0].item() == 1 and fpi[5].item() == 0


@pytest.mark.parametrize("margin", ["soft", 0.5])
def test_batch_hard_fused_matches_reference_loss(rng, margin):
    emb, labels = _clustered(rng, n=60)
    labels[:3] = 1
    got = batch_hard_fused(_t(emb), _t(labels), margin, True,
                           precision="f32")
    want = jax_batch_hard(self_distance(jnp.asarray(emb)),
                          jnp.asarray(labels, jnp.float32), margin, True)
    jax_fused = batch_hard_pallas(jnp.asarray(emb), jnp.asarray(labels),
                                  margin, True, block=32, precision="f32")
    dense = batch_hard(pairwise_distance(_t(emb), _t(emb)), _t(labels),
                       margin, True)
    for ref in (want, jax_fused):
        np.testing.assert_allclose(got[0].item(), float(ref[0]), rtol=1e-4)
        np.testing.assert_allclose(got[1].item(), float(ref[1]), rtol=1e-4)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dense[0].item(), float(want[0]), rtol=1e-4)


def test_batch_hard_fused_gradients_match(rng):
    emb, labels = _clustered(rng, n=48, dim=16)
    labels[:3] = 1
    e = _t(emb).clone().requires_grad_(True)
    batch_hard_fused(e, _t(labels), "soft", True, precision="f32")[0] \
        .backward()

    def loss_pallas(x):
        return batch_hard_pallas(x, jnp.asarray(labels), "soft", True,
                                 block=16, precision="f32")[0]

    def loss_dense(x):
        return jax_batch_hard(self_distance(x),
                              jnp.asarray(labels, jnp.float32), "soft",
                              True)[0]

    for fn in (loss_pallas, loss_dense):
        g = np.asarray(jax.grad(fn)(jnp.asarray(emb)))
        np.testing.assert_allclose(e.grad.numpy(), g, rtol=1e-3, atol=1e-5)


def test_batch_hard_fused_nonaligned_n(rng):
    emb, labels = _clustered(rng, n=37, dim=8)
    labels[:3] = 1
    got = batch_hard_fused(_t(emb), _t(labels), 0.3, True, precision="f32")
    want = jax_batch_hard(self_distance(jnp.asarray(emb)),
                          jnp.asarray(labels, jnp.float32), 0.3, True)
    jax_fused = batch_hard_pallas(jnp.asarray(emb), jnp.asarray(labels), 0.3,
                                  True, block=16, precision="f32")
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(got[0].item(), float(jax_fused[0]), rtol=1e-4)


def test_fused_stats_bf16_close(rng):
    """bf16 operands stay within bf16 tolerance of the exact stats and of
    the JAX package's bf16 kernel (whose epilogue is bf16 too)."""
    emb, labels = _clustered(rng, n=64)
    fp16, cn16, _ = fused_batch_hard_stats(_t(emb), _t(labels), None, "bf16")
    fp32, cn32, _ = fused_batch_hard_stats(_t(emb), _t(labels), None, "f32")
    jfp, jcn, _ = jax_fused_stats(jnp.asarray(emb), jnp.asarray(labels),
                                  None, 32, "bf16")
    for a, b in ((fp16, fp32), (cn16, cn32)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-2)
    np.testing.assert_allclose(fp16.numpy(), np.asarray(jfp), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(cn16.numpy(), np.asarray(jcn), rtol=5e-2,
                               atol=5e-2)


def test_fused_stats_large_label_ids(rng):
    """Ids far beyond f32's exact range, including ids >= 2^31, stay
    distinct: labels are compared as int64, never cast to float."""
    n, d = 96, 32
    emb = rng.randn(n, d).astype(np.float32)
    small = np.array([1, 2, 3] * (n // 3), np.int64)
    jfp, jcn, jnc = jax_fused_stats(jnp.asarray(emb), jnp.asarray(small),
                                    None, 32, "f32")
    ref = fused_batch_hard_stats(_t(emb), _t(small), None, "f32")
    np.testing.assert_allclose(ref[0].numpy(), np.asarray(jfp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ref[1].numpy(), np.asarray(jcn), rtol=1e-4,
                               atol=1e-4)
    for offset in (1 << 26, 1 << 31, 1 << 40):
        huge = small + offset
        # adjacent huge ids collide in a float32 cast
        assert np.float32(huge[0]) == np.float32(huge[1])
        got = fused_batch_hard_stats(_t(emb), _t(huge), None, "f32")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_no_grad_path_matches_grad_path(rng):
    """The forward without a gradient (the K2 path) gives the same stats
    as the one that tracks winners (K1), and the CPU path counts no kernel
    launch."""
    emb, labels = _clustered(rng, n=50)
    before = dict(LAUNCHES)
    with torch.no_grad():
        a = fused_batch_hard_stats(_t(emb), _t(labels), None, "bf16")
    e = _t(emb).clone().requires_grad_(True)
    b = fused_batch_hard_stats(e, _t(labels), None, "bf16")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.detach().numpy())
    assert LAUNCHES == before


def test_algo_dispatch():
    """On the CPU every algo takes the plain version: "tri" (K3 on a card)
    equals "row" (K1/K2); an unknown algo raises."""
    emb = torch.randn(8, 4)
    labels = torch.tensor([1, 1, 2, 2, 3, 3, 4, 4])
    tri = fused_batch_hard_stats(emb, labels, algo="tri")
    for x, y in zip(tri, fused_batch_hard_stats(emb, labels, algo="row")):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="algo"):
        fused_batch_hard_stats(emb, labels, algo="ring")
    auto = fused_batch_hard_stats(emb, labels, algo="auto")
    row = fused_batch_hard_stats(emb, labels, algo="row")
    for x, y in zip(auto, row):
        assert torch.equal(x, y)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("with_idx", [True, False])
@pytest.mark.parametrize("d", [1, 7, 8, 24, 72, 90, 100])
def test_pad_depth_keeps_stats(rng, d, with_idx, precision):
    """The zero columns that TMA's 16-byte rows need change no statistic
    and no winner: stats_plain on the padded operand is bit-identical."""
    emb, labels = _clustered(rng, n=45, dim=d)
    valid = (rng.rand(45) > 0.2).astype(np.float32)
    ops = prep_operands(_t(emb), _t(labels), _t(valid), precision)
    padded = pad_depth(ops.opd)
    assert padded.shape == (45, -(-d // 8) * 8)
    assert padded.dtype == ops.opd.dtype
    assert torch.equal(padded[:, :d], ops.opd)
    assert not padded[:, d:].any()
    for got, want in zip(stats_plain(ops._replace(opd=padded), with_idx),
                         stats_plain(ops, with_idx)):
        assert torch.equal(got, want)


def test_tma_operand_pads_and_aligns_bf16_only():
    """A bf16 operand is padded to a depth that is a multiple of 8 and
    copied when its base is not 16-byte aligned; one that qualifies, and
    any f32 operand, passes through as it is."""
    base = torch.randn(6 * 16 + 1).to(torch.bfloat16)
    view = base[1:].view(6, 16)               # 2 bytes past the base
    assert view.data_ptr() % 16 != 0
    fixed = tma_operand(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    ragged = torch.randn(5, 90).to(torch.bfloat16)
    out = tma_operand(ragged)
    assert out.shape == (5, 96) and torch.equal(out[:, :90], ragged)
    aligned = torch.randn(5, 64).to(torch.bfloat16)
    assert tma_operand(aligned) is aligned
    f32 = torch.randn(5, 90)
    assert tma_operand(f32) is f32
