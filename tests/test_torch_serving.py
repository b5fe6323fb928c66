"""The port's serving layer (``serving.py``: ``EmbeddingService``,
``RetrievalIndex``; ``ops/chunked_topk.py``) against the JAX package's on
the CPU, on the same NumPy inputs.

Top-k indices must equal JAX's, duplicate gallery rows included (the
lowest index first among equal distances) and k > N included (index -1,
distance 1e30 in the overflow slots); distances agree within rtol 1e-5
(f32 products summed in another order), the int8 gallery's within atol
3e-4 (``tests/test_serving.py``'s bound for it).  Saved indexes are
byte-identical between the packages and load in either.  Embeddings agree
within 1e-5, the JAX side's int8 dequantization pinned to bf16 as the JAX
function states (D1)."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.ops import chunked_topk as jax_topk
from multimodal_similarity_tpu.serving import (
    EmbeddingService as JaxService, RetrievalIndex as JaxIndex)
from multimodal_similarity_tpu.train import steps as jax_steps
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.data.device_feed import (
    quantize_features)
from multimodal_similarity_tpu_torch.models import RTSN
from multimodal_similarity_tpu_torch.ops import chunked_topk
from multimodal_similarity_tpu_torch.serving import (
    EmbeddingService, RetrievalIndex)

CPU = "cpu"


@contextlib.contextmanager
def world_one(tmp_path):
    """A one-rank gloo group in this process and its mesh, torn down
    after the block."""
    from multimodal_similarity_tpu_torch.parallel import create_mesh
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/pg_one", world_size=1,
        rank=0)
    try:
        yield create_mesh(1)
    finally:
        torch.distributed.destroy_process_group()
RTOL = 1e-5
INT8_ATOL = 3e-4


def _with_duplicates(rng, n, d, copies=((7, 20), (8, 21), (3, 33))):
    """[n, d] f32 rows, each (src, dst) pair of ``copies`` equal."""
    g = rng.randn(n, d).astype(np.float32)
    for src, dst in copies:
        if dst < n:
            g[dst] = g[src]
    return g


def _same_topk(got, want, atol=0.0):
    """Port (d, idx) against JAX (d, idx): indices equal, distances within
    RTOL (and ``atol``)."""
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=RTOL, atol=atol)


def _both_index(**kw):
    return JaxIndex(**kw), RetrievalIndex(device=CPU, **kw)


def _rtsn(seed):
    """A JAX RTSN (n_seg 3, emb_dim 16, n_input 8), its params and the port
    RTSN holding them."""
    model = jax_build("rtsn", num_seg=3, emb_dim=16, n_input=8)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((2, 3, 8)))["params"]
    port = load_flax_params(RTSN(3, 16, 8),
                            jax.tree.map(np.asarray, params))
    return model, params, port


def _rounded_dequant(x):
    """The JAX dequantization with its product rounded to bf16, as the
    function states (XLA's CPU step keeps it in f32: D1)."""
    if isinstance(x, dict) and "q" in x:
        return jax.lax.reduce_precision(
            x["q"].astype(jnp.float32)
            * x["scale"].astype(jnp.bfloat16).astype(jnp.float32),
            exponent_bits=8, mantissa_bits=7).astype(jnp.bfloat16)
    return x


# -- EmbeddingService --------------------------------------------------------

def test_embedding_service_padded_batches(rng):
    """10 events in batches of 4 (a ragged last batch) embed as the JAX
    service's padded batches do."""
    model, params, port = _rtsn(0)
    x = rng.randn(10, 3, 8).astype(np.float32)
    got = EmbeddingService(port, batch_size=4, device=CPU).embed(x)
    want = JaxService(model, params, batch_size=4).embed(x)
    assert got.shape == (10, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_embedding_service_zero_rows():
    """A zero-row request gives (0, emb_dim) on both request paths."""
    _, _, port = _rtsn(0)
    for int8 in (False, True):
        svc = EmbeddingService(port, batch_size=4, int8=int8, device=CPU)
        assert svc.embed(np.zeros((0, 3, 8), np.float32)).shape == (0, 16)
        assert svc.embed_quantized(np.zeros((0, 3, 8), np.int8),
                                   np.zeros((0, 3, 1), np.float32)
                                   ).shape == (0, 16)


def test_embedding_service_int8_matches_jax(rng, monkeypatch):
    """The int8 request path (host quantizing, bf16 dequantizing) against
    the JAX int8 service pinned to the stated bf16 rounding, within 1e-5,
    and within the JAX test's 0.05 of the f32 path; unit norms."""
    monkeypatch.setattr(jax_steps, "dequant_features", _rounded_dequant)
    model, params, port = _rtsn(0)
    events = rng.randn(37, 3, 8).astype(np.float32)
    i8 = EmbeddingService(port, batch_size=16, int8=True,
                          device=CPU).embed(events)
    want = JaxService(model, params, batch_size=16, int8=True).embed(events)
    f32 = EmbeddingService(port, batch_size=16, device=CPU).embed(events)
    assert i8.shape == f32.shape == (37, 16)
    np.testing.assert_allclose(i8, want, rtol=RTOL, atol=1e-5)
    assert float(np.max(np.abs(i8 - f32))) < 0.05
    np.testing.assert_allclose(np.linalg.norm(i8, axis=1), 1.0, rtol=1e-2)


def test_embedding_service_embed_quantized_and_hot_swap(rng):
    """A client-quantized request embeds as the server-quantizing path
    does; weights loaded into the service's module apply to both request
    paths."""
    _, _, port = _rtsn(0)
    _, _, other = _rtsn(9)
    events = rng.randn(21, 3, 8).astype(np.float32)
    svc = EmbeddingService(port, batch_size=8, int8=True, device=CPU)
    q, s = quantize_features(events)
    before = svc.embed_quantized(q, s)
    np.testing.assert_array_equal(before, svc.embed(events))
    np.testing.assert_array_equal(
        before, svc.embed_quantized(q.numpy(), s.numpy()))
    svc.model.load_state_dict(other.state_dict())
    after = svc.embed_quantized(q, s)
    assert float(np.max(np.abs(after - before))) > 1e-3
    np.testing.assert_array_equal(after, svc.embed(events))
    svc.int8 = False
    fresh = EmbeddingService(other, batch_size=8, device=CPU)
    np.testing.assert_array_equal(svc.embed(events), fresh.embed(events))


def test_service_default_device_needs_a_card(monkeypatch):
    """Both classes default to ``cuda`` and raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, port = _rtsn(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingService(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalIndex(8)


# -- top-k ---------------------------------------------------------------------

def test_smallest_k_tie_rule():
    """``smallest_k`` orders by (value, column): ties, -0.0 against 0.0 and
    the 1e30 sentinel, against a lexsort."""
    rs = np.random.RandomState(1)
    d = rs.randint(0, 4, size=(6, 40)).astype(np.float32)
    d[0, :5] = -0.0
    d[1, 10:] = 1e30
    vals, cols = chunked_topk.smallest_k(torch.from_numpy(d), 12)
    for r in range(d.shape[0]):
        want = np.lexsort((np.arange(40), d[r] + 0.0))[:12]
        np.testing.assert_array_equal(cols[r].numpy(), want)
        np.testing.assert_array_equal(vals[r].numpy(), d[r][want] + 0.0)


def test_ieee_f32_holds_tf32_off():
    """Inside ``ieee_f32`` cuBLAS runs IEEE f32 whichever TF32 API the
    caller set; the caller's setting is back after it."""
    flags = torch.backends.cuda.matmul
    new_api = hasattr(flags, "fp32_precision")
    flags.allow_tf32 = True
    try:
        with chunked_topk.ieee_f32():
            assert (flags.fp32_precision == "ieee" if new_api
                    else not flags.allow_tf32)
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = False
    assert not flags.allow_tf32
    if new_api:
        flags.fp32_precision = "tf32"
        try:
            with chunked_topk.ieee_f32():
                assert flags.fp32_precision == "ieee"
            assert flags.fp32_precision == "tf32"
        finally:
            flags.fp32_precision = "ieee"
        assert not flags.allow_tf32


@pytest.mark.parametrize("metric", ["euclidean", "squaredeuclidean"])
def test_chunked_topk_matches_jax(rng, metric):
    """103 rows (not a chunk multiple) with duplicate rows, chunks of 32:
    indices equal to JAX's, and to the port's dense top-k."""
    q = rng.randn(7, 12).astype(np.float32)
    g = _with_duplicates(rng, 103, 12)
    # near, not on, the rows: a distance at the Gram form's cancellation
    # noise would differ between the packages in every digit
    q[:3] = g[[7, 8, 3]] + 0.3 * rng.randn(3, 12).astype(np.float32)
    got = chunked_topk.chunked_topk(torch.from_numpy(q), torch.from_numpy(g),
                                    k=9, chunk=32, metric=metric)
    want = jax_topk.chunked_topk(jnp.asarray(q), jnp.asarray(g), k=9,
                                 chunk=32, metric=metric)
    _same_topk(got, want)
    # the duplicate of each near row follows it at the same distance
    np.testing.assert_array_equal(got[1][:3, :2].numpy(),
                                  [[7, 20], [8, 21], [3, 33]])
    assert torch.equal(got[0][:3, 0], got[0][:3, 1])
    dense = chunked_topk.chunked_topk(torch.from_numpy(q),
                                      torch.from_numpy(g), k=9, chunk=103,
                                      metric=metric)
    assert torch.equal(dense[1], got[1])


def test_chunked_topk_k_exceeds_gallery(rng):
    """k=8 over 5 rows in chunks of 4: the overflow slots are -1 and 1e30,
    as in JAX."""
    q = rng.randn(2, 4).astype(np.float32)
    g = rng.randn(5, 4).astype(np.float32)
    got = chunked_topk.chunked_topk(torch.from_numpy(q), torch.from_numpy(g),
                                    k=8, chunk=4)
    want = jax_topk.chunked_topk(jnp.asarray(q), jnp.asarray(g), k=8,
                                 chunk=4)
    _same_topk(got, want)
    assert (got[1][:, 5:] == -1).all() and (got[0][:, 5:] > 1e29).all()


def _quantize(gal):
    return RetrievalIndex._quantize_rows(gal)


def test_chunked_topk_quantized_edges(rng):
    """37 unit rows in 3 chunks of 16, k=40 > N: index-equal to the JAX
    scan, overflow slots -1 / 1e30, every real slot a real row."""
    gal = _with_duplicates(rng, 37, 16)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    qg, scale, gsq = _quantize(gal)
    queries = rng.randn(4, 16).astype(np.float32)
    got = chunked_topk.chunked_topk_quantized(
        *(torch.from_numpy(np.asarray(a)) for a in (queries, qg, scale, gsq)),
        k=40, chunk=16)
    want = jax_topk.chunked_topk_quantized(
        *(jnp.asarray(a) for a in (queries, qg, scale, gsq)), k=40, chunk=16)
    _same_topk(got, want, atol=INT8_ATOL)
    d_q, i_q = (t.numpy() for t in got)
    assert np.all(i_q[:, 37:] == -1) and np.all(d_q[:, 37:] > 1e29)
    assert np.all((i_q[:, :37] >= 0) & (i_q[:, :37] < 37))


def test_quantized_topk_near_ties():
    """The JAX near-tie case (512 integer rows in pairs one quantum apart,
    squared Euclidean): index-equal to JAX, distances within atol 3e-4 of
    the f32 oracle on the same quantized rows; the split product within
    2e-2 of the f32 contraction (the JAX test's bounds)."""
    rng = np.random.RandomState(11)
    n, d = 512, 96
    qg = rng.randint(-127, 128, size=(n, d)).astype(np.int8)
    qg[1::2] = qg[::2]
    qg[1::2, 0] += 1
    qg[5] = qg[4]  # one exact duplicate pair: a tie
    scale = np.full((n,), 1.0 / 127.0, np.float32)
    g = qg.astype(np.float32) * scale[:, None]
    gsq = np.sum(g * g, axis=1).astype(np.float32)
    q = rng.randn(8, d).astype(np.float32)
    q[0] = g[4]
    args = (q, qg, scale, gsq)
    got = chunked_topk.chunked_topk_quantized(
        *(torch.from_numpy(a) for a in args), k=16, chunk=128,
        metric="squaredeuclidean")
    want = jax_topk.chunked_topk_quantized(
        *(jnp.asarray(a) for a in args), k=16, chunk=128,
        metric="squaredeuclidean")
    _same_topk(got, want, atol=INT8_ATOL)
    np.testing.assert_array_equal(got[1][0, :2].numpy(), [4, 5])
    d_exact = (q ** 2).sum(1, keepdims=True) + gsq[None, :] - 2.0 * q @ g.T
    np.testing.assert_allclose(
        got[0].numpy(), np.take_along_axis(d_exact, got[1].numpy(), axis=1),
        rtol=0, atol=INT8_ATOL)
    inner = chunked_topk.split_bf16_inner(
        torch.from_numpy(q), torch.from_numpy(qg).to(torch.bfloat16))
    assert np.max(np.abs(inner.numpy() - q @ qg.astype(np.float32).T)) < 2e-2


# -- RetrievalIndex ----------------------------------------------------------

def test_retrieval_index_exact(rng):
    """Dense path on 50 rows with duplicates: indices, distances and
    metadata equal to JAX's; a duplicate ties its source and follows it."""
    gallery = _with_duplicates(rng, 50, 8)
    meta = [f"item{i}" for i in range(50)]
    jidx, pidx = _both_index(emb_dim=8)
    jidx.add(gallery, metadata=meta)
    pidx.add(gallery, metadata=meta)
    q = gallery[7:9] + 0.3 * rng.randn(2, 8).astype(np.float32)
    d, ids, m = pidx.query(q, k=3)
    _same_topk((d, ids), jidx.query(q, k=3)[:2])
    assert m == jidx.query(q, k=3)[2]
    np.testing.assert_array_equal(ids[:, :2], [[7, 20], [8, 21]])
    assert m[0][0] == "item7" and d[0, 0] == d[0, 1]
    assert (np.diff(d, axis=1) >= 0).all()


def test_retrieval_index_empty():
    idx = RetrievalIndex(emb_dim=4, device=CPU)
    with pytest.raises(ValueError):
        idx.query(np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError):
        idx.save("unused")


@pytest.mark.parametrize("metric", ["euclidean", "squaredeuclidean"])
def test_retrieval_index_chunked_path(rng, metric):
    """gallery_chunk 16 over 40 rows streams through ``chunked_topk``: equal
    to the JAX index's chunked path and to the port's dense path."""
    gallery = _with_duplicates(rng, 40, 8)
    q = rng.randn(3, 8).astype(np.float32)
    jbig, pbig = _both_index(emb_dim=8, gallery_chunk=16, metric=metric)
    psmall = RetrievalIndex(emb_dim=8, metric=metric, device=CPU)
    for idx in (jbig, pbig, psmall):
        idx.add(gallery)
    got = pbig.query(q, k=5)
    _same_topk(got[:2], jbig.query(q, k=5)[:2])
    d_small, i_small, _ = psmall.query(q, k=5)
    np.testing.assert_array_equal(got[1], i_small)
    np.testing.assert_allclose(got[0], d_small, rtol=RTOL)


def test_retrieval_index_gallery_cached_and_invalidated(rng):
    """The gallery uploads once per add() generation; an add invalidates it
    and the new row is retrievable."""
    idx = RetrievalIndex(8, device=CPU)
    idx.add(rng.randn(32, 8).astype(np.float32))
    q = rng.randn(4, 8).astype(np.float32)
    idx.query(q, k=3)
    cached = idx._device_gallery
    assert cached is not None
    idx.query(q, k=3)
    assert idx._device_gallery is cached
    idx.add(q[0:1] + 1e-4)
    assert idx._device_gallery is None
    assert int(idx.query(q[0:1], k=1)[1][0, 0]) == 32


def test_retrieval_index_guards_and_1d_query(rng, tmp_path):
    """Misaligned metadata raises; a 1-D query is Q=1; metadata stays
    aligned over several adds; k is clamped to the gallery's size; an
    index on a one-rank mesh (the sharded path at world 1) answers as the
    index without one, k clamped there too; l1 with int8 raises."""
    idx = RetrievalIndex(emb_dim=8, device=CPU)
    with pytest.raises(ValueError):
        idx.add(rng.randn(10, 8).astype(np.float32), metadata=["a"] * 5)
    idx.add(rng.randn(10, 8).astype(np.float32),
            metadata=[f"m{i}" for i in range(10)])
    idx.add(rng.randn(6, 8).astype(np.float32),
            metadata=[f"n{i}" for i in range(6)])
    assert len(idx) == 16
    d, ids, meta = idx.query(rng.randn(8).astype(np.float32), k=3)
    assert d.shape == (1, 3) and ids.shape == (1, 3)
    all_meta = [f"m{i}" for i in range(10)] + [f"n{i}" for i in range(6)]
    assert meta[0] == [all_meta[j] for j in ids[0]]
    assert idx.query(np.zeros(8, np.float32), k=50)[1].shape == (1, 16)
    with world_one(tmp_path) as mesh:
        sharded = RetrievalIndex(8, mesh=mesh)
        sharded.add(idx._gallery_host(), metadata=all_meta)
        queries = rng.randn(5, 8).astype(np.float32)
        for k in (3, 50):
            got, want = sharded.query(queries, k=k), idx.query(queries, k=k)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
            assert got[2] == want[2]
    with pytest.raises(NotImplementedError):
        RetrievalIndex(8, metric="l1", int8_gallery=True, device=CPU)


def test_retrieval_index_int8_gallery(rng):
    """5000 unit rows of width 64, int8: index-equal to the JAX int8 index
    (distances within atol 3e-4), top-10 overlap with the exact index at
    least 0.95, rank-1 distance within 0.02 of it."""
    d = 64
    gal = rng.randn(5000, d).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    queries = rng.randn(32, d).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    exact = RetrievalIndex(d, device=CPU)
    exact.add(gal, metadata=list(range(5000)))
    jq8, pq8 = _both_index(emb_dim=d, int8_gallery=True)
    jq8.add(gal, metadata=list(range(5000)))
    pq8.add(gal, metadata=list(range(5000)))
    de, ie, _ = exact.query(queries, k=10)
    dq, iq, meta = pq8.query(queries, k=10)
    _same_topk((dq, iq), jq8.query(queries, k=10)[:2], atol=INT8_ATOL)
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(ie, iq)])
    assert overlap >= 0.95, overlap
    np.testing.assert_allclose(dq[:, 0], de[:, 0], atol=0.02)
    assert meta[0][0] == int(iq[0][0])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_retrieval_index_save_load_roundtrip(tmp_path, int8):
    """A reload serves the saved instance's top-k exactly; an int8 reload
    uploads the artifacts verbatim and never builds the f32 gallery."""
    rng = np.random.RandomState(3 + int8)
    g = rng.randn(200, 24).astype(np.float32)
    metric = "squaredeuclidean" if int8 else "euclidean"
    idx = RetrievalIndex(emb_dim=24, metric=metric, int8_gallery=int8,
                         device=CPU)
    idx.add(g, metadata=[{"i": i} for i in range(200)])
    q = rng.randn(5, 24).astype(np.float32)
    d0, i0, m0 = idx.query(q, k=7)
    idx2 = RetrievalIndex.load(idx.save(str(tmp_path / "ix")), device=CPU)
    assert len(idx2) == 200 and idx2.metric == metric
    d1, i1, m1 = idx2.query(q, k=7)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    assert m0 == m1
    if int8:
        assert idx2._gallery is None and not idx2._blocks
    with world_one(tmp_path) as mesh:
        d2, i2, m2 = RetrievalIndex.load(str(tmp_path / "ix"),
                                         mesh=mesh).query(q, k=7)
    np.testing.assert_array_equal(i0, i2)
    np.testing.assert_array_equal(d0, d2)
    assert m0 == m2


def test_retrieval_index_save_in_place_over_loaded_dir(tmp_path):
    """Saving into the directory an index was loaded from (its mmaps the
    sources) leaves the same top-k."""
    rng = np.random.RandomState(7)
    q = rng.randn(4, 16).astype(np.float32)
    for int8 in (False, True):
        idx = RetrievalIndex(emb_dim=16, int8_gallery=int8, device=CPU)
        idx.add(rng.randn(120, 16).astype(np.float32),
                metadata=list(range(120)))
        d0, i0, _ = idx.query(q, k=5)
        path = idx.save(str(tmp_path / f"inplace{int8}"))
        RetrievalIndex.load(path, device=CPU).save(path)
        d1, i1, _ = RetrievalIndex.load(path, device=CPU).query(q, k=5)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)


def test_retrieval_index_add_after_load(tmp_path):
    rng = np.random.RandomState(6)
    idx = RetrievalIndex(emb_dim=8, int8_gallery=True, device=CPU)
    idx.add(rng.randn(50, 8).astype(np.float32))
    idx2 = RetrievalIndex.load(idx.save(str(tmp_path / "ixa")), device=CPU)
    extra = rng.randn(10, 8).astype(np.float32)
    idx2.add(extra, metadata=[f"new{i}" for i in range(10)])
    assert len(idx2) == 60
    d, i, m = idx2.query(extra[0], k=1)
    assert i[0][0] == 50 and m[0][0] == "new0"
    # the loaded rows re-quantize to the bytes they were saved as
    again = RetrievalIndex.load(idx2.save(str(tmp_path / "ixb")), device=CPU)
    np.testing.assert_array_equal(np.asarray(again._quant[0])[:50],
                                  np.asarray(idx2._quantize_rows(
                                      idx2._gallery_host())[0])[:50])


# -- across the packages -------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_saved_index_is_byte_identical_and_loads_across(tmp_path, int8):
    """The same gallery and metadata saved by each package give the same
    bytes in every file; a JAX-saved index served by the port, and a
    port-saved one by JAX, give the other package's top-k."""
    rng = np.random.RandomState(12)
    g = _with_duplicates(rng, 150, 16)
    meta = [{"session": f"s{i % 3}", "label": i % 5} for i in range(150)]
    jidx, pidx = _both_index(emb_dim=16, int8_gallery=int8,
                             metric="squaredeuclidean")
    for idx in (jidx, pidx):
        idx.add(g[:100], metadata=meta[:100])
        idx.add(g[100:], metadata=meta[100:])
    jpath = jidx.save(str(tmp_path / "jax"))
    ppath = pidx.save(str(tmp_path / "port"))
    files = sorted(os.listdir(jpath))
    assert files == sorted(os.listdir(ppath))
    assert files == (["gsq.npy", "manifest.json", "meta.pkl", "q.npy",
                      "scale.npy"] if int8 else
                     ["gallery.npy", "manifest.json", "meta.pkl"])
    for name in files:
        with open(os.path.join(jpath, name), "rb") as a, \
                open(os.path.join(ppath, name), "rb") as b:
            assert a.read() == b.read(), name
    q = rng.randn(6, 16).astype(np.float32)
    q[0] = g[7] + 0.3 * rng.randn(16).astype(np.float32)
    atol = INT8_ATOL if int8 else 0.0
    want = jidx.query(q, k=9)
    got = RetrievalIndex.load(jpath, device=CPU).query(q, k=9)
    _same_topk(got[:2], want[:2], atol=atol)
    assert got[2] == want[2]
    back = JaxIndex.load(ppath).query(q, k=9)
    _same_topk(pidx.query(q, k=9)[:2], back[:2], atol=atol)
    np.testing.assert_array_equal(got[1][0, :2], [7, 20])
