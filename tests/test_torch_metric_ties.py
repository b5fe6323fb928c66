"""The port's device retrieval metrics (``…_torch/eval/metrics.py``
``retrieval_metrics``) against the JAX package's
(``retrieval_metrics_device``) on embeddings with exact ties: every row
equal, and rows drawn with repeats from a few distinct ones.  Both rank a
tie by row index (a stable sort), so they agree within f32 rounding; the
NumPy oracle (``evaluate_simple``) groups tied scores for AP
(sklearn's rule), so on ties both device versions differ from it, as the
JAX docstring states ("matches the NumPy oracle on tie-free inputs")."""

import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.eval.metrics import (
    evaluate_simple, retrieval_metrics_device)
from multimodal_similarity_tpu_torch.eval.metrics import retrieval_metrics

# f32 sums of up to n terms in a different order
TIE_TOL = 1e-6


def _tied(kind, n, d, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, n)
    if kind == "all_equal":
        emb = np.tile(rng.randn(1, d), (n, 1))
    else:
        emb = rng.randn(max(n // 4, 2), d)[rng.randint(0, max(n // 4, 2), n)]
    return emb.astype(np.float32), labels


@pytest.mark.parametrize("kind", ["all_equal", "repeated_rows"])
@pytest.mark.parametrize("n,d", [(12, 8), (240, 128)])
def test_tied_embeddings_rank_as_jax(kind, n, d):
    """mAP, mPrec@0.5 and recall@{1..32} of the port equal JAX's within
    TIE_TOL on exactly tied embeddings."""
    emb, labels = _tied(kind, n, d, seed=n)
    want = retrieval_metrics_device(emb, labels)
    got = retrieval_metrics(torch.from_numpy(emb), labels)
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=TIE_TOL)
    assert got[2].keys() == want[2].keys()
    np.testing.assert_allclose(list(got[2].values()),
                               list(want[2].values()), rtol=0, atol=TIE_TOL)


def test_all_equal_rows_differ_from_the_numpy_oracle():
    """Where every row is equal, the oracle's tie-grouped AP is not the
    device versions' positional AP (so a card check against the oracle
    needs tie-free embeddings)."""
    emb, labels = _tied("all_equal", 12, 8, seed=12)
    oracle = evaluate_simple(emb, labels)[0]
    for dev in (retrieval_metrics_device(emb, labels)[0],
                retrieval_metrics(torch.from_numpy(emb), labels)[0]):
        assert abs(dev - oracle) > 1e-2
