"""The port's sqdist (ops/kernels/distance.py, K7) against the JAX
package's ``pallas_sqdist`` (interpret mode on the CPU), on the same numpy
inputs.  On a CPU tensor the port runs its plain PyTorch version; the CUDA
kernel itself is checked against that version on the card by
chip_smoke.py.  The kernel forms its products in 3xTF32 on the tensor
cores; a float64 model of those products, with the kernel's norms and
clamp, is held to ``pallas_sqdist`` here, and the operand preparation for
TMA (``tma_depth``) is checked.

Tolerance rtol/atol 1e-4, as the JAX package's own sqdist test (f32
summation order of the products differs between XLA and PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops.pallas import pallas_sqdist
from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES, sqdist
from multimodal_similarity_tpu_torch.ops.kernels.distance import (
    sqdist_kernel, sqdist_plain, tma_depth)
from multimodal_similarity_tpu_torch.ops.kernels.lifted import tf32_split


def _pair(rng, n, m, d):
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(m, d).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,m,d", [(70, 50, 24), (64, 64, 16), (33, 45, 7),
                                   (5, 90, 24)],
                         ids=["pallas-test-shape", "aligned", "ragged-all",
                              "ragged-m"])
def test_sqdist_matches_pallas(rng, n, m, d):
    a, b = _pair(rng, n, m, d)
    got = sqdist(torch.from_numpy(a), torch.from_numpy(b))
    want = pallas_sqdist(jnp.asarray(a), jnp.asarray(b), block_m=32,
                         block_n=32)
    assert got.shape == (n, m) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_sqdist_clamps_duplicate_rows_at_zero(rng):
    """Rows of b that repeat rows of a sit at distance 0 up to cancellation
    error, never below: both versions clamp."""
    a, b = _pair(rng, 40, 30, 24)
    a *= 10.0                       # large norms: cancellation shows
    b[:12] = a[:12]
    got = sqdist(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(pallas_sqdist(jnp.asarray(a), jnp.asarray(b),
                                    block_m=32, block_n=32))
    assert bool((got >= 0).all()) and (want >= 0).all()
    # what is left of |a|^2 + |a|^2 - 2 a.a is cancellation error: a few
    # f32 ulps of the summed norms (about 4800 here)
    ulp = np.finfo(np.float32).eps * 2 * float((a[:12] ** 2).sum(1).max())
    assert float(got.diagonal()[:12].max()) <= 8 * ulp
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=8 * ulp)


def test_sqdist_casts_to_f32(rng):
    """bf16 operands are cast to f32 before the norms and the product, as
    pallas_sqdist does."""
    a, b = _pair(rng, 20, 12, 8)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    got = sqdist(ta, tb)
    want = pallas_sqdist(jnp.asarray(ta.float().numpy()),
                         jnp.asarray(tb.float().numpy()), block_m=32,
                         block_n=32)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_cpu_counts_no_launch_and_no_fallback(rng):
    a, b = (torch.from_numpy(x) for x in _pair(rng, 10, 9, 4))
    before = dict(LAUNCHES)
    assert torch.equal(sqdist(a, b), sqdist_plain(a, b))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sqdist_kernel(a, b)
    with pytest.raises(ValueError, match="no sqdist kernel for device"):
        sqdist(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match=r"\[N, d\] and \[M, d\]"):
        sqdist(a, b[:, :3])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads an f32 operand in TF32: the low 13
    mantissa bits cleared."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _sqdist_model(a: torch.Tensor, b: torch.Tensor, products: str):
    """The card's K7 in plain PyTorch: the f32 row norms, <a_i, b_j> as
    the tensor cores form it ("3xtf32": hi lo + lo hi + hi hi with lo read
    as TF32, "tf32": hi hi alone, "exact": float64; summed in float64 and
    rounded to f32), then max(|a|^2 + |b|^2 - 2 <a, b>, 0)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if products == "exact":
        inner = a.double() @ b.double().T
    else:
        inner = ah.double() @ bh.double().T
        if products == "3xtf32":
            inner = (ah.double() @ _tf32(bl).double().T
                     + _tf32(al).double() @ bh.double().T + inner)
    na, nb = (a * a).sum(1), (b * b).sum(1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * inner.float(),
                       min=0.0)


@pytest.mark.parametrize("n,m,d", [(70, 50, 24), (33, 45, 7), (130, 75, 90),
                                   (64, 129, 128)],
                         ids=["pallas-test-shape", "ragged-all", "ragged-d90",
                              "ragged-m"])
def test_3xtf32_model_matches_pallas(rng, n, m, d):
    """The 3xTF32 model of K7 within 1e-4 of the JAX kernel at ragged N, M
    and d (d = 7 and 90 are padded to a multiple of 4 on the card; zero
    columns change nothing); plain TF32 products are at least 20 times
    further from exact ones."""
    a, b = _pair(rng, n, m, d)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _sqdist_model(ta, tb, "3xtf32")
    want = pallas_sqdist(jnp.asarray(a), jnp.asarray(b), block_m=32,
                         block_n=32)
    _close(got.numpy(), want)
    exact = _sqdist_model(ta, tb, "exact")
    plain = _sqdist_model(ta, tb, "tf32")
    err3 = float((got - exact).abs().max())
    err1 = float((plain - exact).abs().max())
    assert err3 * 20 < err1


def test_3xtf32_model_clamps_duplicate_unit_rows(rng):
    """Unit rows of b that repeat rows of a (chip_smoke.py's operands) come
    out of the 3xTF32 model at most 1e-5 from 0 and never below, as from
    the JAX kernel."""
    a, b = _pair(rng, 100, 60, 128)
    b[:25] = a[:25]
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    got = _sqdist_model(torch.from_numpy(a), torch.from_numpy(b), "3xtf32")
    want = np.asarray(pallas_sqdist(jnp.asarray(a), jnp.asarray(b),
                                    block_m=32, block_n=32))
    assert bool((got >= 0).all())
    assert float(got.diagonal()[:25].max()) <= 1e-5
    _close(got.numpy(), want)


@pytest.mark.parametrize("d", [0, 1, 4, 7, 90, 128])
def test_tma_depth(rng, d):
    """K7's operands as TMA reads them: zero columns up to a positive
    multiple of 4 (which add nothing to any distance), no copy when
    nothing is missing, and a 16-byte aligned base."""
    x = torch.from_numpy(rng.randn(9, d).astype(np.float32))
    got = tma_depth(x)
    assert got.shape == (9, max(4, -(-d // 4) * 4))
    assert torch.equal(got[:, :d], x) and not got[:, d:].any()
    assert got.data_ptr() % 16 == 0
    if d and d % 4 == 0:
        assert got.data_ptr() == x.data_ptr()
    y = torch.from_numpy(rng.randn(7, d).astype(np.float32))
    # the same distances up to the f32 product's blocking order
    np.testing.assert_allclose(sqdist_plain(got, tma_depth(y)).numpy(),
                               sqdist_plain(x, y).numpy(), rtol=1e-6,
                               atol=1e-5)


def test_tma_depth_copies_unaligned_base():
    flat = torch.arange(1 + 6 * 8, dtype=torch.float32)
    view = flat[1:].view(6, 8)
    assert view.data_ptr() % 16
    got = tma_depth(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
