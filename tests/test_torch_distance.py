"""The port's sqdist (ops/kernels/distance.py, K7) against the JAX
package's ``pallas_sqdist`` (interpret mode on the CPU), on the same numpy
inputs.  On a CPU tensor the port runs its plain PyTorch version; the CUDA
kernel itself is checked against that version on the card by
chip_smoke.py.

Tolerance rtol/atol 1e-4, as the JAX package's own sqdist test (f32
summation order of the products differs between XLA and PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops.pallas import pallas_sqdist
from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES, sqdist
from multimodal_similarity_tpu_torch.ops.kernels.distance import (
    sqdist_kernel, sqdist_plain)


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
