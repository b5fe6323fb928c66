"""Fixtures of the benchmark's own tests, and the ``card`` marker: a test
that needs a CUDA card takes the ``card`` fixture, which skips it here."""

import json
import os
import shutil
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at sizes a CPU test holds: every width cut, every path kept
TINY = {
    "configs/mm_flagship.json": dict(
        n_input=16, n_h=2, n_w=2, n_C=4, emb_dim=16, segment_dim=12,
        event_per_batch=60, triplet_per_batch=20, events_per_session=21,
        val_events=10),
    "configs/rtsn_base.json": dict(gallery_chunk=1024, image_size=75),
    "traffic/retrieval_400k.json": {"params": dict(
        gallery_rows=3000, classes=30, noise_norm=0.8, queries_per_call=64,
        k=10, query_pool_calls=4, sampled_calls=3)},
    "traffic/extract_720p.json": {"params": dict(
        frames_per_call=2, frame_hw=[90, 120], pool_calls=2,
        sampled_calls=2)},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none "
        "(run them on the card: python -m pytest perfbench/tests -m card)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")


def make_bench_root(dest: str) -> str:
    """A checkout-like root under ``dest``: BENCHMARK.json and a copy of
    perfbench/ with the cells cut to TINY."""
    pb = os.path.join(dest, "perfbench")
    shutil.copytree(PERFBENCH, pb,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for rel, change in TINY.items():
        path = os.path.join(pb, rel)
        with open(path) as f:
            data = json.load(f)
        if "params" in change:
            data["params"].update(change["params"])
        else:
            data.update(change)
        with open(path, "w") as f:
            json.dump(data, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_bench_root(str(tmp_path))
