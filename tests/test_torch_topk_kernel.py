"""The fused exact top-k (``ops/kernels/topk.py``, ``csrc/topk.cu``) on
the CPU: a NumPy model of the kernel's algorithm held to the JAX package's
``chunked_topk`` and to the port's ``smallest_k``, the plain version (the
walk) bit for bit, the wrapper's checks and the routing of
``chunked_topk`` and ``RetrievalIndex``.  The kernel itself runs only on a
card (``chip_smoke.py`` holds it to the walk there).

The model follows the kernel step for step: distances as the card forms
them (3xTF32 products: hi lo + lo hi + hi hi with lo read as TF32, summed
in float64; f32 norms; one rounding for |q|^2 + |g|^2 - 2 <q, g>, clamped,
-0.0 made +0.0), keys (f32 bits << 32) | row, gallery slices of whole
128-row tiles, and in each slice each row's list of k keys with its buffer
behind it: the first tile's bound from each thread's three smallest, the
k-th key as the filter, a full buffer merged by rank and its refused
survivors offered again, a merge once MERGE_AT keys wait at a tile's end;
then the slices' lists merged by k rounds of a minimum.  Survivors are
offered in a shuffled order and extra merges happen at random, as the
card's threads may order them: the answer must not change.

On inputs exact in f32 and TF32 (small integers) the model's distances are
exact, so it must equal the JAX function bit for bit, ties included (the
lowest gallery row first); on float inputs it must equal the exact top-k
of its own distances (``smallest_k`` over the whole matrix)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.ops import chunked_topk as jax_topk
from multimodal_similarity_tpu_torch.ops import chunked_topk
from multimodal_similarity_tpu_torch.ops.distances import pairwise_distance
from multimodal_similarity_tpu_torch.ops.kernels import LAUNCHES
from multimodal_similarity_tpu_torch.ops.kernels import topk as kt
from multimodal_similarity_tpu_torch.serving import RetrievalIndex
from multimodal_similarity_tpu_torch.utils import profiling

# the kernel's constants (csrc/topk.cu)
TILE = 128
ROW_SMALL, ROW_LARGE, K_SMALL, MERGE_AT = 28, 80, 12, 8
SENT = np.uint64(0x7149F2CA) << np.uint64(32)
INF = np.float32(np.inf)


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 ``x`` as the tensor core reads it in TF32: the low 13 mantissa
    bits cleared."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray):
    """(hi, lo): hi rounded to the nearest TF32 value, lo = x - hi."""
    hi = ((x.view(np.uint32) + np.uint32(0x1000))
          & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, (x - hi).astype(np.float32)


def model_distances(q: np.ndarray, g: np.ndarray, metric: str) -> np.ndarray:
    """[Q, N] f32 distances as the kernel forms them."""
    qh, ql = _split(q)
    gh, gl = _split(g)
    f = np.float64
    dot = (qh.astype(f) @ _tf32(gl).astype(f).T
           + _tf32(ql).astype(f) @ gh.astype(f).T
           + qh.astype(f) @ gh.astype(f).T).astype(np.float32)
    na = (q.astype(f) ** 2).sum(1).astype(np.float32)
    nb = (g.astype(f) ** 2).sum(1).astype(np.float32)
    norms = (na[:, None] + nb[None, :]).astype(np.float32)
    s = (norms.astype(f) - 2.0 * dot.astype(f)).astype(np.float32)
    sq = np.where(s < 0, np.float32(0), s) + np.float32(0)
    if metric == "euclidean":
        return np.sqrt(sq + np.float32(1e-12)).astype(np.float32)
    return sq.astype(np.float32)


def _key(v: np.float32, row: int) -> np.uint64:
    return (np.uint64(np.float32(v).view(np.uint32)) << np.uint64(32)) \
        | np.uint64(row)


def _merge_row(lst: list, buf: list, k: int) -> None:
    """The warp's merge: each key goes to the place its rank gives, where
    that place is below k; a place no key takes keeps its key."""
    keys = lst + buf
    new = list(lst)
    for x in keys:
        rank = sum(1 for y in keys if y < x)
        if rank < k:
            new[rank] = x
    lst[:] = new
    buf.clear()


def _first_bound(d_tile: np.ndarray, valid: np.ndarray) -> np.float32:
    """The largest of the four threads' third-smallest distance (thread q
    holds tile columns 8 g + 2 q + c); infinity where one holds fewer."""
    bound = np.float32(-np.inf)
    for q in range(4):
        cols = [8 * g + 2 * q + c for g in range(16) for c in range(2)]
        vals = sorted(float(d_tile[c]) for c in cols
                      if valid[c] and not np.isnan(d_tile[c]))
        third = np.float32(vals[2]) if len(vals) >= 3 else INF
        bound = max(bound, third)
    return np.float32(bound)


def _slice_list(d_row: np.ndarray, t0: int, t1: int, k: int, rng) -> list:
    """One row of one CTA: the k keys it writes for tiles t0 .. t1 - 1."""
    n = d_row.shape[0]
    row_len = ROW_SMALL if k <= K_SMALL else ROW_LARGE
    cap = row_len - k
    lst, buf = [SENT] * k, []
    for tile in range(t0, t1):
        col0 = tile * TILE
        d_tile = np.full(TILE, np.nan, np.float32)
        real = min(TILE, n - col0)
        d_tile[:real] = d_row[col0:col0 + real]
        valid = np.arange(TILE) < real
        bound = (_first_bound(d_tile, valid)
                 if row_len == ROW_SMALL and tile == t0 else INF)
        pending = list(rng.permutation(real))
        while True:
            kth = lst[k - 1]
            lim = min(np.uint32(kth >> np.uint64(32)).view(np.float32), bound)
            refused = []
            for c in pending:
                v = d_tile[c]
                if not v <= lim:
                    continue
                key = _key(v, col0 + c)
                if key < kth:
                    if len(buf) < cap:
                        buf.append(key)
                    else:
                        refused.append(c)
            if not refused:
                break
            _merge_row(lst, buf, k)
            pending = refused
        if len(buf) >= MERGE_AT or (buf and rng.random() < 0.3):
            _merge_row(lst, buf, k)
    if buf:
        _merge_row(lst, buf, k)
    return lst


def model_topk(q, g, k, metric="squaredeuclidean", slices=3, seed=0):
    """-> (dists [Q, k] f32, rows [Q, k] int64, the model's distances)."""
    rng = np.random.RandomState(seed)
    d = model_distances(q, g, metric)
    tiles = -(-g.shape[0] // TILE)
    slices = max(1, min(slices, tiles))
    dist = np.zeros((q.shape[0], k), np.float32)
    idx = np.zeros((q.shape[0], k), np.int64)
    for i in range(q.shape[0]):
        keys = []
        for s in range(slices):
            keys += _slice_list(d[i], tiles * s // slices,
                                tiles * (s + 1) // slices, k, rng)
        low = np.uint64(0)
        for j in range(k):
            best = min((x for x in keys if x >= low),
                       default=np.uint64(2 ** 64 - 1))
            if best >= SENT:
                dist[i, j:], idx[i, j:] = 1e30, -1
                break
            dist[i, j] = np.uint32(best >> np.uint64(32)).view(np.float32)
            idx[i, j] = int(best & np.uint64(0xFFFFFFFF))
            low = best + np.uint64(1)
    return dist, idx, d


def _ints(rng, n, d, lo=-3, hi=4):
    """Small integers as f32: exact in TF32, every distance exact."""
    return rng.randint(lo, hi, size=(n, d)).astype(np.float32)


def _jax(q, g, k, metric, chunk=64):
    got = jax_topk.chunked_topk(jnp.asarray(q), jnp.asarray(g), k=k,
                                chunk=chunk, metric=metric)
    return np.asarray(got[0]), np.asarray(got[1])


# (Q, N, d, k, slices): ragged N (not a multiple of the tile or of the
# slices), one query, k = 1, k = 64 (the kernel's wide rows), N < k, and
# one tile at the largest k of the narrow rows, where the first tile's
# bound alone decides what enters
CASES = [(70, 1000, 16, 10, 3), (1, 777, 12, 10, 5), (33, 900, 8, 1, 4),
         (20, 700, 16, 64, 2), (9, 5, 8, 8, 1), (5, 129, 4, 12, 2),
         (64, 128, 8, 12, 1)]
IDS = ["ragged", "q1", "k1", "k64", "n-under-k", "k12-two-tiles",
       "k12-one-tile"]


@pytest.mark.parametrize("metric", ["squaredeuclidean", "euclidean"])
@pytest.mark.parametrize("nq,n,d,k,slices", CASES, ids=IDS)
def test_model_matches_jax_on_exact_inputs(rng, nq, n, d, k, slices, metric):
    """Integer rows, so many equal distances: the model's answer is the JAX
    function's bit for bit, the lowest gallery row first among ties and
    (1e30, -1) past the gallery's rows."""
    q, g = _ints(rng, nq, d), _ints(rng, n, d)
    got_d, got_i, _ = model_topk(q, g, k, metric, slices, seed=nq + n)
    want_d, want_i = _jax(q, g, k, metric)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("nq,n,d,k,slices", CASES, ids=IDS)
def test_model_is_exact_topk_of_its_distances(rng, nq, n, d, k, slices):
    """Float rows: the streaming lists, the first tile's bound, the merges
    and the slices' merge give the exact top-k of the model's own
    distances, as ``smallest_k`` takes it over the whole matrix."""
    q = rng.randn(nq, d).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    got_d, got_i, dist = model_topk(q, g, k, "squaredeuclidean", slices,
                                    seed=n)
    kk = min(k, n)
    want_d, want_i = chunked_topk.smallest_k(torch.from_numpy(dist), kk)
    np.testing.assert_array_equal(got_i[:, :kk], want_i.numpy())
    np.testing.assert_array_equal(got_d[:, :kk], want_d.numpy())
    assert (got_i[:, kk:] == -1).all() and (got_d[:, kk:] == 1e30).all()


def test_model_order_does_not_matter(rng):
    """Other offer orders and merge times, the same answer."""
    q = rng.randn(40, 16).astype(np.float32)
    g = rng.randn(1500, 16).astype(np.float32)
    g[700:760] = g[:60]                       # ties between far rows
    runs = [model_topk(q, g, 10, "squaredeuclidean", 4, seed=s)[:2]
            for s in range(3)]
    for d, i in runs[1:]:
        np.testing.assert_array_equal(i, runs[0][1])
        np.testing.assert_array_equal(d, runs[0][0])


def test_model_duplicates_and_zero_distances(rng):
    """Queries repeated in the gallery, twice, in different slices: each
    query's own copies come first at distance +0.0 (never -0.0), the lower
    row first (integer rows: the distances are exact)."""
    q = _ints(rng, 12, 16, -50, 51)
    g = _ints(rng, 1100, 16, -50, 51)
    g[300:312] = q
    g[900:912] = q
    d, i, _ = model_topk(q, g, 5, "squaredeuclidean", 3, seed=1)
    np.testing.assert_array_equal(i[:, 0], np.arange(300, 312))
    np.testing.assert_array_equal(i[:, 1], np.arange(900, 912))
    assert (d[:, :2] == 0).all() and not np.signbit(d[:, :2]).any()


@pytest.mark.parametrize("metric", ["squaredeuclidean", "euclidean"])
def test_model_padding_rows_as_the_walk(rng, metric):
    """A shard padded with rows of 1e15 (parallel/sharded_eval.py) and k
    over its real rows: at squared euclidean every padding row lies past
    1e30 and the walk's empty slots (1e30, -1) come first; at euclidean
    the padding rows enter.  The model's rows are the walk's."""
    q = rng.randn(6, 16).astype(np.float32)
    g = np.concatenate([rng.randn(5, 16).astype(np.float32),
                        np.full((3, 16), 1e15, np.float32)])
    d, i, _ = model_topk(q, g, 8, metric, 1)
    wd, wi = chunked_topk.chunked_topk(torch.from_numpy(q),
                                       torch.from_numpy(g), k=8, chunk=4,
                                       metric=metric)
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_allclose(d, wd.numpy(), rtol=1e-5)
    assert ((i == -1).sum() == 18) == (metric == "squaredeuclidean")


def _parent_walk(queries, gallery, k, chunk, metric):
    """The walk as the port ran it before the kernel: a copy of its loop."""
    q = queries.float()
    best_d = torch.full((q.shape[0], k), 1e30)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64)
    with chunked_topk.ieee_f32():
        for start in range(0, gallery.shape[0], chunk):
            d = pairwise_distance(q, gallery[start:start + chunk], metric)
            best_d, pos = chunked_topk.smallest_k(
                torch.cat([best_d, d], dim=1), k)
            from_best = best_i.gather(1, pos.clamp(max=k - 1))
            best_i = torch.where(pos < k, from_best, pos - k + start)
    return best_d, best_i


@pytest.mark.parametrize("metric", ["squaredeuclidean", "euclidean", "l1"])
@pytest.mark.parametrize("n,k,chunk", [(300, 10, 64), (7, 12, 4),
                                       (513, 1, 512)])
def test_plain_is_the_walk_bit_for_bit(rng, metric, n, k, chunk):
    q = torch.from_numpy(rng.randn(17, 24).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, 24).astype(np.float32))
    g[n // 2:n // 2 + 3] = g[:3]
    got = kt.sqdist_topk_plain(q, g, k, metric, chunk)
    want = _parent_walk(q, g, k, chunk, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    routed = chunked_topk.chunked_topk(q, g, k=k, chunk=chunk,
                                       metric=metric)
    assert torch.equal(routed[0], want[0]) and torch.equal(routed[1],
                                                           want[1])


def test_kernel_wrapper_checks(rng):
    """On the CPU the kernel raises (no fallback), as it does for a metric,
    k or shapes it does not take."""
    q = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(9, 8).astype(np.float32))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kt.sqdist_topk_kernel(q, g, 3)
    with pytest.raises(ValueError, match=r"\[Q, d\] and \[N, d\]"):
        kt.sqdist_topk_kernel(q, g[:, :5], 3)
    with pytest.raises(ValueError, match="operands on"):
        kt.sqdist_topk_kernel(q, g.to("meta"), 3)
    cuda_like = types.SimpleNamespace(is_cuda=True)
    assert LAUNCHES == before
    assert kt.takes_kernel(cuda_like, "euclidean", 64)
    assert kt.takes_kernel(cuda_like, "squaredeuclidean", 1)
    assert not kt.takes_kernel(cuda_like, "l1", 10)
    assert not kt.takes_kernel(cuda_like, "euclidean", 65)
    assert not kt.takes_kernel(q, "euclidean", 10)


@pytest.fixture
def on_card(monkeypatch):
    """The routing as on a card: ``takes_kernel`` judges a CPU tensor as a
    CUDA one, and the kernel is the model (counting its launches)."""
    calls = []

    def takes(queries, metric, k):
        return kt.takes_kernel(types.SimpleNamespace(is_cuda=True), metric,
                               k)

    def kernel(queries, gallery, k, metric="squaredeuclidean"):
        calls.append(k)
        d, i, _ = model_topk(queries.numpy(), gallery.numpy(), k, metric)
        return torch.from_numpy(d), torch.from_numpy(i)

    import multimodal_similarity_tpu_torch.serving as serving
    monkeypatch.setattr(chunked_topk, "takes_kernel", takes)
    monkeypatch.setattr(serving, "takes_kernel", takes)
    monkeypatch.setattr(chunked_topk, "sqdist_topk_kernel", kernel)
    profiling.reset_counts("topk.", ("fused", "walk"))
    return calls


@pytest.mark.parametrize("rows", [40, 300], ids=["one-chunk", "chunked"])
def test_index_routes_f32_to_the_kernel(rng, on_card, rows):
    """An f32 index at a euclidean metric takes the kernel at any size,
    its one-chunk branch included: one ``topk.fused`` a query, no walk;
    the answer is the JAX index's on exact rows."""
    g = _ints(rng, rows, 8)
    q = _ints(rng, 6, 8)
    index = RetrievalIndex(8, metric="squaredeuclidean", gallery_chunk=64,
                           device="cpu")
    index.add(g)
    d, i, _ = index.query(q, k=7)
    assert on_card == [7]
    assert profiling.counters("topk.") == {"fused": 1, "walk": 0}
    want_d, want_i = _jax(q, g, 7, "squaredeuclidean")
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("case", ["l1", "k65", "int8"])
def test_index_walks_where_the_kernel_does_not_apply(rng, on_card, case):
    """l1, k over 64 and the int8 gallery take the walk, as a CPU tensor
    does: ``topk.walk`` moves, the kernel is not called."""
    g = rng.randn(200, 8).astype(np.float32)
    index = RetrievalIndex(
        8, metric="l1" if case == "l1" else "euclidean",
        int8_gallery=case == "int8", gallery_chunk=64, device="cpu")
    index.add(g)
    index.query(g[:3], k=65 if case == "k65" else 5)
    assert on_card == []
    assert profiling.counters("topk.") == {"fused": 0, "walk": 1}


def test_cpu_walks_and_counts(rng):
    """Without the card's routing a CPU query walks: the dense branch and
    the chunked walk each count one ``topk.walk``."""
    g = rng.randn(100, 8).astype(np.float32)
    profiling.reset_counts("topk.", ("fused", "walk"))
    for chunk in (256, 16):
        index = RetrievalIndex(8, gallery_chunk=chunk, device="cpu")
        index.add(g)
        index.query(g[:4], k=3)
    assert profiling.counters("topk.") == {"fused": 0, "walk": 2}
