"""Nothing the harness loads is JAX or the JAX package, and the plain
references import nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import PERFBENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_similarity_tpu")
PORT = "multimodal_similarity_tpu_torch"


def _load_everything():
    """A fresh interpreter that loads the harness, every kind of traffic,
    metric reader and reference, and the program modules they call;
    returns the top-level names of every module it then holds."""
    code = f"""
import glob, os, sys
sys.path.insert(0, {ROOT!r})
from perfbench import harness, flops, faults, devtrace, honda_data
import perfbench.calibrate
for d in ("kinds", "metrics", "reference"):
    for path in sorted(glob.glob(os.path.join({PERFBENCH!r}, d, "*.py"))):
        harness.load_module(path, "m_" + os.path.basename(path)
                            .replace(".", "_"))
import {PORT}.serving, {PORT}.preprocess.features
import {PORT}.train.trainers.multimodal_model
import {PORT}.train.trainers._honda, {PORT}.train.cached_steps
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_no_jax_loaded():
    names = _load_everything()
    assert PORT in names
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    paths = glob.glob(os.path.join(PERFBENCH, "reference", "*.py"))
    assert paths
    for path in paths:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {PORT, *FORBIDDEN}, (path, tops)


def test_harness_sources_import_no_jax():
    for path in glob.glob(os.path.join(PERFBENCH, "**", "*.py"),
                          recursive=True):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops)
