"""The port's slice-7 evaluation CLIs (``eval.export_index``,
``evaluate_baseline``, ``evaluate_hallucination``, ``evaluate_pairsim``,
``check_inconsistent``, ``analysis``) and the package dispatcher
(``__main__``) against the JAX package's, on one synthetic directory at
``tests/test_eval_tools.py``'s widths (RTSN on sensors (8,), emb_dim 16;
ConvRTSN on 2 x 2 x 8 resnet maps), each package reading a checkpoint of
the same parameters (``load_flax_params``).

Tolerances: mAP and Recall@1 within atol 1e-3 (as
``tests/test_torch_late_fusion.py``), the NumPy-only baseline within 1e-6,
embeddings within 1e-5, saved index metadata byte-equal.  Triplet and pair
index lists must be equal, except where the first difference sits at a
distance (or probability) within 1e-5 of its decision boundary: f32
products summed in another order may flip such a comparison, and every
later draw then differs."""

import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu import __main__ as jax_main
from multimodal_similarity_tpu.configs import EvalConfig as JaxEvalConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.eval import analysis as jax_analysis
from multimodal_similarity_tpu.eval import check_inconsistent as jax_check
from multimodal_similarity_tpu.eval import evaluate_baseline as jax_baseline
from multimodal_similarity_tpu.eval import (
    evaluate_hallucination as jax_hallucination)
from multimodal_similarity_tpu.eval import evaluate_pairsim as jax_pairsim
from multimodal_similarity_tpu.eval import export_index as jax_export
from multimodal_similarity_tpu.models import PDDM as JaxPDDM
from multimodal_similarity_tpu.models import PairSim as JaxPairSim
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.serving import RetrievalIndex as JaxIndex
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu_torch import __main__ as port_main
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.eval import (
    analysis, check_inconsistent, evaluate_baseline, evaluate_hallucination,
    evaluate_model, evaluate_pairsim, export_index)
from multimodal_similarity_tpu_torch.models import (
    PDDM, PairSim, build_encoder)
from multimodal_similarity_tpu_torch.serving import RetrievalIndex
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint

RTSN16 = dict(network="rtsn", feat="sensors", n_input=8, emb_dim=16)
CONV = dict(network="convrtsn", feat="resnet", n_input=8, n_h=2, n_w=2,
            n_C=4, emb_dim=16)
BOUNDARY = 1e-5
# the heads' output layers times this: confident probabilities, so that
# check_inconsistent's lists fill at its 0.9 threshold
HEAD_SCALE = 30.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _encoder(key, emb_dim=16, network="rtsn"):
    kw = dict(RTSN16 if network == "rtsn" else CONV, emb_dim=emb_dim)
    x0 = jnp.zeros((2, 3, 8) if network == "rtsn" else (2, 3, 2, 2, 8))
    shape = {k: v for k, v in kw.items() if k not in ("network", "feat")}
    return (_np(jax_build(network, num_seg=3, **shape).init(key, x0)[
        "params"]), build_encoder(network, num_seg=3, **shape))


def _head(key, cls, port_cls, n, layer):
    e = jnp.zeros((2, n))
    tree = _np(cls(n_input=n).init(key, e, e, method="score")["params"])
    tree["score"][layer]["kernel"] = tree["score"][layer]["kernel"] \
        * HEAD_SCALE
    return tree, port_cls(n)


def _pair(root, name, tree, module):
    """The same parameters as a JAX checkpoint and a port checkpoint, in
    two directories (the CLIs write beside their checkpoint)."""
    jpath = os.path.join(root, "jax", name, "model.msgpack")
    ppath = os.path.join(root, "port", name, "model.ckpt-1")
    for p in (jpath, ppath):
        os.makedirs(os.path.dirname(p), exist_ok=True)
    save_pytree(jpath, {"params": tree})
    save_checkpoint(ppath, load_flax_params(module, tree), None, 1)
    return jpath, ppath


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The directory (6 sessions of resnet maps and sensors, the last 2 the
    test split) and the checkpoints: an RTSN encoder, a pairsim_model
    (encoder + ver), a pddm_model (emb_dim 32, encoder + pddm) and a
    modality_hallucination (modality_core + hallucination_sensors)."""
    base = tmp_path_factory.mktemp("eval_tools")
    root = str(base / "data")
    generate_synthetic_honda(
        root, n_sessions=6, frames_per_session=400,
        modal_dims={"resnet": (2, 2, 8), "sensors": (8,)},
        class_scale=1.5, noise_scale=1.0, seed=2)
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    ckpts = {"encoder": _pair(str(base), "encoder", *_encoder(keys[0]))}
    enc, enc_mod = _encoder(keys[1])
    head, head_mod = _head(keys[2], JaxPairSim, PairSim, 16, "out")
    ckpts["pairsim"] = _pair(
        str(base), "pairsim", {"encoder": enc, "ver": head},
        torch.nn.ModuleDict({"encoder": enc_mod, "ver": head_mod}))
    enc, enc_mod = _encoder(keys[3], emb_dim=32)
    head, head_mod = _head(keys[4], JaxPDDM, PDDM, 32, "s")
    ckpts["pddm"] = _pair(
        str(base), "pddm", {"encoder": enc, "pddm": head},
        torch.nn.ModuleDict({"encoder": enc_mod, "pddm": head_mod}))
    core, core_mod = _encoder(keys[5], network="convrtsn")
    hal, hal_mod = _encoder(keys[6], emb_dim=32, network="convrtsn")
    ckpts["hallucination"] = _pair(
        str(base), "hallucination",
        {"modality_core": core, "hallucination_sensors": hal},
        torch.nn.ModuleDict({"modality_core": core_mod,
                             "hallucination_sensors": hal_mod}))
    return root, ckpts, base


def _cfgs(root, ckpt=None, **kw):
    """(JAX, port) EvalConfigs of the same flags, each on its package's
    checkpoint of ``ckpt``."""
    args = dict(DATA_ROOT=root, **kw)
    jcfg = JaxEvalConfig(**args).resolve()
    pcfg = EvalConfig(device="cpu", **args).resolve()
    if ckpt is not None:
        jcfg.model_path, pcfg.model_path = ckpt
    return jcfg, pcfg


def _close(got, want, atol=1e-3):
    assert np.isfinite(got["mAP"]) and 0 < got["mAP"] <= 1
    np.testing.assert_allclose(got["mAP"], want["mAP"], atol=atol)
    np.testing.assert_allclose(got["recall"], want["recall"], atol=atol)
    assert sorted(got["mAP_event"]) == sorted(want["mAP_event"])


# -- export_index ----------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_export_index_matches_jax(setup, tmp_path, int8):
    """The port's index of the test split against the JAX CLI's: the same
    manifest (a Euclidean index: EvalConfig has no --metric) and metadata
    bytes, rows within 1e-5 (int8: codes within one step, each row's scale
    within 1e-5), the same top-k on both packages' loads; a second save of
    the loaded index is byte-equal to the first."""
    root, ckpts, _ = setup
    jcfg, pcfg = _cfgs(root, ckpts["encoder"], **RTSN16)
    jdir = jax_export.run(jcfg, str(tmp_path / "jax"), int8_gallery=int8)
    pdir = export_index.run(pcfg, str(tmp_path / "port"), int8_gallery=int8)
    for name in ("manifest.json", "meta.pkl"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jidx, pidx = JaxIndex.load(jdir), RetrievalIndex.load(pdir, device="cpu")
    assert pidx.metric == "euclidean" and pidx.int8_gallery == int8
    assert len(pidx) == len(jidx) > 0
    if int8:
        (qj, sj, _), (qp, sp, _) = jidx._quant, pidx._quant
        assert np.abs(qj.astype(int) - qp.astype(int)).max() <= 1
        np.testing.assert_allclose(sp, sj, rtol=1e-5)
    else:
        np.testing.assert_allclose(pidx._gallery_host(),
                                   jidx._gallery_host(), atol=1e-5)
    q = np.asarray(pidx._gallery_host()[:5]) + 0.05
    got, want = pidx.query(q, k=5), jidx.query(q, k=5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert {"session", "label", "start", "end"} <= set(got[2][0][0])
    again = pidx.save(str(tmp_path / "again"))
    for name in os.listdir(pdir):
        with open(os.path.join(pdir, name), "rb") as a, \
                open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name


def test_export_index_cli(setup, tmp_path):
    """``main`` with --device cpu writes an int8 index; --index_dir is
    required."""
    root, ckpts, _ = setup
    out = str(tmp_path / "ix")
    args = ["--DATA_ROOT", root, "--model_path", ckpts["encoder"][1],
            "--feat", "sensors", "--network", "rtsn", "--emb_dim", "16",
            "--n_input", "8", "--device", "cpu"]
    export_index.main(["--index_dir", out, "--int8_gallery",
                       "--index_split", "test"] + args)
    idx = RetrievalIndex.load(out, device="cpu")
    assert len(idx) > 0 and idx.int8_gallery
    with pytest.raises(SystemExit):
        export_index.main(args)


# -- evaluate_baseline, evaluate_hallucination ---------------------------------

@pytest.mark.parametrize("pool", ["mean", "max"])
def test_evaluate_baseline_matches_jax(setup, pool):
    """Pooled raw features: the same metrics as the JAX CLI (NumPy in
    both, within 1e-6)."""
    root, _, _ = setup
    jcfg, pcfg = _cfgs(root, feat="sensors", preprocess_func=pool)
    got, want = evaluate_baseline.run(pcfg), jax_baseline.run(jcfg)
    _close(got, want, atol=1e-6)
    assert got["embeddings"].shape[1] == 8


def test_evaluate_hallucination_matches_jax(setup):
    """The core (emb_dim 16) and hallucinated-sensors (32) ConvRTSN
    embeddings concatenated: 48 wide, unit norm a half, metrics within
    1e-3 of the JAX CLI's."""
    root, ckpts, _ = setup
    jcfg, pcfg = _cfgs(root, ckpts["hallucination"], **CONV)
    got, want = evaluate_hallucination.run(pcfg), jax_hallucination.run(jcfg)
    _close(got, want)
    emb = got["embeddings"]
    assert emb.shape[1] == 16 + 32
    np.testing.assert_allclose(np.linalg.norm(emb[:, :16], axis=1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(emb[:, 16:], axis=1), 1.0,
                               rtol=1e-5)


# -- evaluate_pairsim -------------------------------------------------------------

def _first_difference_at_boundary(got, want, dist, alpha=0.2):
    """``got`` equal to ``want`` (flat triplet lists), or their first
    differing triplet's anchor-positive pair has a negative whose hard or
    easy comparison lies within BOUNDARY of flipping."""
    if got == want:
        return
    got, want = np.reshape(got, (-1, 3)), np.reshape(want, (-1, 3))
    t = next(i for i in range(min(len(got), len(want)))
             if not np.array_equal(got[i], want[i]))
    a, p = want[t][:2]
    margins = np.concatenate([dist[a] - dist[a, p] - alpha,
                              dist[a] - dist[a, p]])
    assert np.min(np.abs(margins)) < BOUNDARY, (t, got[t], want[t])


def test_select_eval_triplets_matches_jax(setup):
    """On the same embeddings and labels, from the same seed: the port's
    hard + easy triplets are the JAX function's, index for index."""
    rs = np.random.RandomState(3)
    emb = rs.randn(120, 16).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lab = rs.randint(0, 5, size=(120, 1))
    for seed in (0, 12345):
        want = jax_pairsim.select_eval_triplets(
            lab, emb, 100, alpha=0.2, rng=random.Random(seed))
        got = evaluate_pairsim.select_eval_triplets(
            lab, torch.from_numpy(emb), 100, alpha=0.2,
            rng=random.Random(seed))
        assert len(want) > 150 and len(want) % 6 == 0
        dist = ((emb[:, None] - emb[None]) ** 2).sum(-1)
        _first_difference_at_boundary(got, want, dist)


def test_evaluate_pairsim_matches_jax(setup):
    """The PairSim head's accuracy over the test sessions equals the JAX
    CLI's, per session, over the same number of pairs."""
    root, ckpts, _ = setup
    jcfg, pcfg = _cfgs(root, ckpts["pairsim"], normalized=False, **RTSN16)
    got, want = evaluate_pairsim.run(pcfg), jax_pairsim.run(jcfg)
    assert got["pairs"] == want["pairs"] > 0
    assert got["accuracy"] == want["accuracy"]
    assert got["per_session"] == want["per_session"]
    assert sorted(got["triplets"]) == sorted(want["per_session"])


# -- check_inconsistent ---------------------------------------------------------

def _same_pairs(got, want, threshold):
    """Equal lists of (session, i, j, label_i, label_j, prob), probs within
    1e-5; where they differ, the first difference's probability sits within
    BOUNDARY of its threshold."""
    for a, b in zip(got, want):
        if a[:5] != b[:5]:
            edge = min(abs(x[5] - threshold) for x in (a, b)) if \
                a[3] != a[4] else min(abs(1 - x[5] - threshold)
                                      for x in (a, b))
            assert edge < BOUNDARY, (a, b)
            return
        np.testing.assert_allclose(a[5], b[5], atol=1e-5)
    assert len(got) == len(want)


@pytest.mark.parametrize("head", ["pddm", "pairsim"])
def test_check_inconsistent_matches_jax(setup, head):
    """Both heads: the confident false positives and negatives are the JAX
    CLI's, in the same row-major order, and the pickle beside the port
    checkpoint holds them."""
    root, ckpts, _ = setup
    kw = dict(RTSN16, emb_dim=32) if head == "pddm" else RTSN16
    jcfg, pcfg = _cfgs(root, ckpts[head], normalized=False, **kw)
    got = check_inconsistent.run(pcfg, head_kind=head)
    want = jax_check.run(jcfg, head_kind=head)
    assert got["false_pos"] or got["false_neg"]
    for key in ("false_pos", "false_neg"):
        _same_pairs(got[key], want[key], 0.9)
        assert all(r[1] < r[2] for r in got[key])
    path = os.path.join(os.path.dirname(pcfg.model_path),
                        f"inconsistent_{head}.pkl")
    with open(path, "rb") as f:
        assert pickle.load(f) == got


def test_check_inconsistent_cli(setup):
    """``--head pairsim`` taken out of the flags; a missing value exits."""
    root, ckpts, _ = setup
    check_inconsistent.main(
        ["--head", "pairsim", "--DATA_ROOT", root, "--model_path",
         ckpts["pairsim"][1], "--feat", "sensors", "--network", "rtsn",
         "--n_input", "8", "--emb_dim", "16", "--device", "cpu"])
    assert os.path.exists(os.path.join(
        os.path.dirname(ckpts["pairsim"][1]), "inconsistent_pairsim.pkl"))
    with pytest.raises(SystemExit):
        check_inconsistent.main(["--head"])


# -- analysis, the dispatcher -------------------------------------------------------

def test_analysis_matches_jax(setup, tmp_path, capsys):
    """On a port ``evaluate_model`` results.pkl, the port's label table,
    confusion text and summary are the JAX module's, character for
    character; the CLI prints the summary and reports the PNG."""
    root, ckpts, _ = setup
    _, pcfg = _cfgs(root, ckpts["encoder"], **RTSN16)
    evaluate_model.run(pcfg)
    pkl = os.path.join(os.path.dirname(pcfg.model_path), "results.pkl")
    labels = np.array([0, 1, 1, 3, 3, 3])
    assert analysis.label_distribution(labels) == \
        jax_analysis.label_distribution(labels)
    conf = {"confusion_matrix": np.array([[0.8, 0.2], [0.3, 0.7]]),
            "labels": [1, 2]}
    assert analysis.format_confusion(conf).splitlines()[1].split() == \
        ["1", "0.800", "0.200"]
    text = analysis.summarize_results(pkl)
    assert text == jax_analysis.summarize_results(pkl)
    assert "per-class mAP" in text and "Recall@1" in text
    capsys.readouterr()
    png = str(tmp_path / "conf.png")
    assert port_main.main(["eval.analysis", pkl, "--png", png]) == 0
    out = capsys.readouterr().out
    assert text in out
    try:
        import matplotlib  # noqa: F401
        assert os.path.exists(png)
    except ImportError:
        assert "matplotlib unavailable" in out


def test_dispatcher_matches_jax(capsys):
    """The port's command lists are the JAX package's; every train.*,
    eval.*, preprocess.* and tools.* resolves to a port module with
    ``main``, and a preprocess.* or tools.* command runs its CLI (here its
    argument check); an unknown command returns 2; no command lists them
    all."""
    import importlib
    for name in ("TRAINERS", "EVALS", "PREPROCESS", "TOOLS"):
        assert getattr(port_main, name) == getattr(jax_main, name)
    assert len(port_main.TRAINERS) == 23 and len(port_main.EVALS) == 8
    for prefix, names in (("train.trainers.", port_main.TRAINERS),
                          ("eval.", port_main.EVALS),
                          ("preprocess.", port_main.PREPROCESS),
                          ("tools.", port_main.TOOLS)):
        for name in names:
            module = importlib.import_module(
                "multimodal_similarity_tpu_torch." + prefix + name)
            assert callable(module.main), name
    for cmd in ["preprocess." + n for n in port_main.PREPROCESS] + \
            ["tools." + n for n in port_main.TOOLS]:
        with pytest.raises(SystemExit):       # argparse: a required flag
            port_main.main([cmd])
    assert port_main.main(["train.nope"]) == 2
    assert port_main.main(["bogus"]) == 2
    assert port_main.main([]) == 0
    out = capsys.readouterr().out
    assert all(n in out for n in port_main.TRAINERS + port_main.EVALS)


def test_eval_package_exports():
    """The CLIs' public functions load from ``eval`` at first access."""
    from multimodal_similarity_tpu_torch import eval as port_eval
    assert port_eval.select_eval_triplets is \
        evaluate_pairsim.select_eval_triplets
    assert port_eval.summarize_results is analysis.summarize_results
    with pytest.raises(AttributeError):
        port_eval.nope
