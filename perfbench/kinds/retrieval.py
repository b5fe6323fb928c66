"""Closed-loop retrieval: one caller sends a batch of fresh query rows to
``RetrievalIndex.query`` and waits for the top-k before it sends the
next.

Parameters (the traffic file's ``params``): ``gallery_rows``, ``classes``
(class centres the gallery and the queries are drawn around),
``noise_norm`` (the norm of a row's noise before it is normalised to unit
length), ``queries_per_call``, ``k``, ``query_pool_calls`` (distinct query
batches made at set-up and cycled) and ``sampled_calls`` (calls of the
window whose answers are checked, drawn from the seed).  The
configuration gives the width (``emb_dim``), the ``metric``, the
``gallery_chunk`` and whether the gallery is ``int8_gallery``.

Each call is timed from the host array in to the host results out.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import Reservoir, sub_seed
from perfbench.reference import topk as ref_topk


class State:
    pass


def _rows(run):
    """The gallery (on the device) and the query pool (host), from the
    seed; the same for the program and the reference."""
    p, cfg = run.params, run.config
    return ref_topk.make_rows(
        sub_seed(run.seed, 0), p["gallery_rows"], p["classes"],
        cfg["emb_dim"], p["noise_norm"], p["query_pool_calls"],
        p["queries_per_call"], run.device)


def setup(run):
    from multimodal_similarity_tpu_torch.serving import RetrievalIndex
    p, cfg = run.params, run.config
    st = State()
    st.run = run
    gallery, pool = _rows(run)
    st.pool = pool.cpu().numpy()
    index = RetrievalIndex(emb_dim=cfg["emb_dim"], metric=cfg["metric"],
                           gallery_chunk=cfg["gallery_chunk"],
                           int8_gallery=cfg.get("int8_gallery", False),
                           device=run.device)
    index.add(gallery.cpu().numpy())
    del gallery
    st.index = index
    st.k = p["k"]
    # warm: the gallery's upload and every shape a call uses
    for i in range(3):
        index.query(st.pool[i % len(st.pool)], st.k)
    st.kept = Reservoir(p["sampled_calls"], sub_seed(run.seed, 1))
    return st


def window(st, seconds):
    run = st.run
    index, pool, k, spans = st.index, st.pool, st.k, run.spans
    lat = []
    run.synchronize()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        with spans("RetrievalIndex.query"):
            d, idx, _ = index.query(pool[i % len(pool)], k)
        lat.append(time.perf_counter() - t)
        st.kept.add((i % len(pool), d, idx))
        i += 1
    window_s = time.perf_counter() - t0
    run.window_s = window_s
    q_rows = pool.shape[1]
    run.counters.update(attempted=i, failed=0, calls=i)
    run.log(f"{i} calls in {window_s:.3f} s; median "
            f"{1e3 * float(np.median(lat)):.3f} ms")
    return {"query_p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "queries_per_s": i * q_rows / window_s}


def outputs(st):
    return list(st.kept.items)


def release(st):
    st.index = None


def reference(run, got):
    """The exact top-k of the query batches ``got`` answered."""
    gallery, pool = _rows(run)
    return ref_topk.ReferenceTopK(gallery, pool, run.params["k"])


def control(run, got):
    """The reference put in the program's place at TF32: its answers to
    the same query batches, in the form of ``got``."""
    ref = reference(run, got)
    return [(pool_i, *ref.control(pool_i)) for pool_i, _, _ in got]


def compare(run, got, want):
    """``topk_gap``: the widest gap between a returned distance and the
    exact distance of the same rank; ``index_gap``: between a returned
    distance and the exact distance of the row returned with it.  Both in
    squared-distance units of unit rows."""
    topk_gap, index_gap = 0.0, 0.0
    for pool_i, d, idx in got:
        gaps = want.gaps(pool_i, d, idx)
        topk_gap = max(topk_gap, gaps["topk_gap"])
        index_gap = max(index_gap, gaps["index_gap"])
    if not got:
        return {"topk_gap": float("inf"), "index_gap": float("inf")}
    return {"topk_gap": topk_gap, "index_gap": index_gap}
