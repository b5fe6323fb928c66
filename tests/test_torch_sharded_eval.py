"""The port's sharded-gallery retrieval (``parallel/sharded_eval.py`` and
``RetrievalIndex(mesh=...)``) at 2 and 4 gloo ranks against the JAX
package's ``sharded_retrieval_topk`` / ``_quantized`` on ``create_mesh(n)``
of the suite's virtual devices, and against the port's own index without
a mesh.  The ranks run as subprocesses (``test_torch_parallel.run_ranks``)
and never import JAX.  The queries sit 0.3 from gallery rows: nearer, a
distance is at the Gram form's f32 noise, where the two packages' values
differ while the ranking holds.  Tolerances at each assertion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import rank_array, run_ranks

from multimodal_similarity_tpu.parallel import create_mesh as jax_mesh
from multimodal_similarity_tpu.parallel.sharded_eval import (
    sharded_retrieval_topk as jax_topk,
    sharded_retrieval_topk_quantized as jax_topk_q)
from multimodal_similarity_tpu_torch.parallel import (
    sharded_retrieval_topk, sharded_retrieval_topk_quantized)
from multimodal_similarity_tpu_torch.parallel.mesh import ProcessMesh
from multimodal_similarity_tpu_torch.parallel.multihost import GlobalRows
from multimodal_similarity_tpu_torch.serving import RetrievalIndex

N, D, Q, K = 48, 16, 6, 5
# the index cases hold 45 rows: padded to 46 rows at 2 ranks, 48 at 4
N_ODD = 45
METRICS = ("euclidean", "squaredeuclidean")
# index case -> (int8 gallery, gallery chunk)
INDEX_CASES = {"f32": (False, 65536), "f32-chunked": (False, 8),
               "int8": (True, 65536)}

_BODY = """
import json
from multimodal_similarity_tpu_torch.parallel import (
    create_mesh, sharded_retrieval_topk, sharded_retrieval_topk_quantized)
from multimodal_similarity_tpu_torch.serving import RetrievalIndex
mesh = create_mesh(SIZE)
g, q, qg, sc, gsq = (np.load(os.path.join(IN, f + ".npy"))
                     for f in ("gallery", "queries", "qg", "scale", "gsq"))
rows = mesh.rows(len(g))
qt = torch.from_numpy(q)
for metric in {metrics!r}:
    d, i = sharded_retrieval_topk(mesh, qt, torch.from_numpy(g[rows]),
                                  k={k}, metric=metric)
    save("f32_" + metric + "_d", d)
    save("f32_" + metric + "_i", i)
    d, i = sharded_retrieval_topk_quantized(
        mesh, qt, torch.from_numpy(qg[rows]), torch.from_numpy(sc[rows]),
        torch.from_numpy(gsq[rows]), k={k}, metric=metric)
    save("int8_" + metric + "_d", d)
    save("int8_" + metric + "_i", i)
for case, (int8, chunk) in {cases!r}.items():
    index = RetrievalIndex({dim}, mesh=mesh, int8_gallery=int8,
                           gallery_chunk=chunk)
    index.add(g[:{n_odd}], metadata=[f"m{{j}}" for j in range({n_odd})])
    d, i, meta = index.query(q, k={k})
    save(case + "_d", d)
    save(case + "_i", i)
    with open(os.path.join(OUT, f"{{case}}_meta_{{RANK}}.json"), "w") as f:
        json.dump(meta, f)
    shard = index._device_gallery
    save(case + "_shard", shard[2] if int8 else shard)
loaded = RetrievalIndex.load(os.path.join(IN, "ix"), mesh=mesh)
d, i, meta = loaded.query(q, k={k})
save("loaded_d", d)
save("loaded_i", i)
save("loaded_rows", np.asarray(loaded._device_gallery.shape[0]))
""".format(metrics=METRICS, k=K, cases=INDEX_CASES, dim=D, n_odd=N_ODD)


def _inputs():
    rng = np.random.RandomState(0)
    g = rng.randn(N, D).astype(np.float32)
    q = rng.randn(Q, D).astype(np.float32)
    q[:4] = g[[3, 20, 31, 44]] + 0.3 * rng.randn(4, D).astype(np.float32)
    qg, scale, gsq = RetrievalIndex._quantize_rows(g)
    return g, q, qg, scale.reshape(-1), gsq


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    """One run of every sharded quantity at 2 or 4 ranks, and the inputs;
    the saved index the ranks load is written here, on one device."""
    n = request.param
    tmp_path = tmp_path_factory.mktemp(f"sharded{n}")
    inputs = _inputs()
    (tmp_path / "in").mkdir()
    for name, a in zip(("gallery", "queries", "qg", "scale", "gsq"),
                       inputs):
        np.save(tmp_path / "in" / f"{name}.npy", a)
    saved = RetrievalIndex(D, device="cpu")
    saved.add(inputs[0][:N_ODD], metadata=list(range(N_ODD)))
    saved.save(str(tmp_path / "in" / "ix"))
    run_ranks(tmp_path, n, _BODY, "sh")
    return tmp_path, n, inputs, saved


def _every_rank(tmp_path, n, name):
    """``name`` of rank 0, after checking every other rank holds the same
    array."""
    first = rank_array(tmp_path, "sh", name, 0)
    for r in range(1, n):
        np.testing.assert_array_equal(rank_array(tmp_path, "sh", name, r),
                                      first, err_msg=f"{name} rank {r}")
    return first


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_topk_matches_jax(ranks, metric):
    """``sharded_retrieval_topk`` on each rank's rows: the same answer on
    every rank, JAX's indices exactly and its distances within rtol 1e-5
    (JAX on ``create_mesh(n)``)."""
    tmp_path, n, (g, q, _, _, _), _ = ranks
    d = _every_rank(tmp_path, n, f"f32_{metric}_d")
    i = _every_rank(tmp_path, n, f"f32_{metric}_i")
    wd, wi = jax_topk(jax_mesh(n), jnp.asarray(q), jnp.asarray(g), k=K,
                      metric=metric)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(d, np.asarray(wd), rtol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_topk_quantized_matches_jax(ranks, metric):
    """``sharded_retrieval_topk_quantized`` over the int8 rows: JAX's
    indices exactly, distances within rtol 1e-5, the same on every
    rank."""
    tmp_path, n, (_, q, qg, scale, gsq), _ = ranks
    d = _every_rank(tmp_path, n, f"int8_{metric}_d")
    i = _every_rank(tmp_path, n, f"int8_{metric}_i")
    wd, wi = jax_topk_q(jax_mesh(n), jnp.asarray(q), jnp.asarray(qg),
                        jnp.asarray(scale), jnp.asarray(gsq), k=K,
                        metric=metric)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(d, np.asarray(wd), rtol=1e-5)


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_on_mesh_matches_unsharded(ranks, case):
    """``RetrievalIndex(mesh=)`` over 45 rows (padded to a multiple of the
    ranks: the padding rows 1e15 in f32, squared norm 1e30 in int8) gives
    every rank the answer of the index without a mesh: indices and
    metadata equal, distances within rtol 1e-6; the chunked local walk
    (``gallery_chunk`` 8) too."""
    tmp_path, n, (g, q, _, _, _), _ = ranks
    int8, chunk = INDEX_CASES[case]
    want = RetrievalIndex(D, device="cpu", int8_gallery=int8,
                          gallery_chunk=chunk)
    want.add(g[:N_ODD], metadata=[f"m{j}" for j in range(N_ODD)])
    wd, wi, wmeta = want.query(q, k=K)
    np.testing.assert_array_equal(_every_rank(tmp_path, n, f"{case}_i"),
                                  wi)
    np.testing.assert_allclose(_every_rank(tmp_path, n, f"{case}_d"), wd,
                               rtol=1e-6)
    import json
    for r in range(n):
        with open(tmp_path / "out_sh" / f"{case}_meta_{r}.json") as f:
            assert json.load(f) == wmeta
    padded = N_ODD + (-N_ODD) % n
    shards = [rank_array(tmp_path, "sh", f"{case}_shard", r)
              for r in range(n)]
    assert all(len(s) == padded // n for s in shards)
    last = shards[-1][N_ODD - padded:]
    assert (last == (1e30 if int8 else 1e15)).all()


def test_saved_index_loads_sharded(ranks):
    """An index saved on one device loads sharded (``load(mesh=)``), each
    rank uploading its own block: the saved instance's top-k exactly."""
    tmp_path, n, (_, q, _, _, _), saved = ranks
    wd, wi, _ = saved.query(q, k=K)
    np.testing.assert_array_equal(_every_rank(tmp_path, n, "loaded_i"), wi)
    np.testing.assert_allclose(_every_rank(tmp_path, n, "loaded_d"), wd,
                               rtol=1e-6)
    assert int(rank_array(tmp_path, "sh", "loaded_rows", 0)) == \
        (N_ODD + (-N_ODD) % n) // n


def test_indivisible_gallery_and_metric_raise():
    """A gallery that does not divide by the world size raises ValueError
    in both packages (before any collective); so does a rank holding
    another rank's block; the int8 variant raises NotImplementedError for
    l1, as JAX does."""
    g = torch.zeros((7, D))
    q = torch.zeros((2, D))
    fake = ProcessMesh(2, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by mesh 2"):
        sharded_retrieval_topk(fake, q, GlobalRows(g, 0, 7))
    with pytest.raises(ValueError, match="not divisible by mesh 2"):
        jax_topk(jax_mesh(2), jnp.zeros((2, D)), jnp.zeros((7, D)))
    with pytest.raises(ValueError, match="not its block"):
        sharded_retrieval_topk(fake, q, GlobalRows(g[:4], 4, 8))
    with pytest.raises(NotImplementedError, match="euclidean metrics"):
        sharded_retrieval_topk_quantized(fake, q, g, g[:, 0], g[:, 0],
                                         metric="l1")
    with pytest.raises(NotImplementedError, match="euclidean metrics"):
        jax_topk_q(jax_mesh(2), jnp.zeros((2, D)), jnp.zeros((8, D)),
                   jnp.ones(8), jnp.ones(8), metric="l1")
