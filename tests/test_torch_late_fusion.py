"""The port's evaluation CLIs (``eval.evaluate_model``, plain and
``--use_output``, and ``eval.evaluate_late_fusion``, sensors and
``--use_output``) against the JAX package's on a JAX checkpoint and a port
checkpoint that hold the same parameters: mAP and Recall@1 within atol
1e-3, as the trainer tests hold val mAP.  Also the strict restore, the
CLIs under ``--device cpu`` and the raise for ``--device cuda`` without a
card.  Small sizes: ConvRTSN 2 x 2 x 8 with n_C 4 and emb_dim 16."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.configs import EvalConfig as JaxEvalConfig
from multimodal_similarity_tpu.data import generate_synthetic_honda
from multimodal_similarity_tpu.eval import evaluate_late_fusion as jax_fusion
from multimodal_similarity_tpu.eval import evaluate_model as jax_eval
from multimodal_similarity_tpu.models import PDDM as JaxPDDM
from multimodal_similarity_tpu.models import RTSN as JaxRTSN
from multimodal_similarity_tpu.models import (
    ConvTSNClassifier as JaxClassifier)
from multimodal_similarity_tpu.models import OutputLayer as JaxOutputLayer
from multimodal_similarity_tpu.models import build_encoder as jax_build
from multimodal_similarity_tpu.train.checkpoints import save_pytree
from multimodal_similarity_tpu_torch.configs import EvalConfig
from multimodal_similarity_tpu_torch.convert import load_flax_params
from multimodal_similarity_tpu_torch.eval import (
    evaluate_late_fusion, evaluate_model)
from multimodal_similarity_tpu_torch.models import (
    PDDM, RTSN, ConvTSNClassifier, OutputLayer, build_encoder)
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint

CONV = dict(n_input=8, n_h=2, n_w=2, n_C=4, num_seg=3, emb_dim=16)
X0 = jnp.zeros((2, 3, 2, 2, 8))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """6 sessions (the last 2 the test split) of resnet maps and sensors."""
    path = str(tmp_path_factory.mktemp("fusion") / "data")
    generate_synthetic_honda(path, n_sessions=6, frames_per_session=300,
                             modal_dims={"resnet": (2, 2, 8),
                                         "sensors": (8,)},
                             seed=0, length_range=(4, 16))
    return path


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _core(key, network="convrtsn"):
    return _np(jax_build(network, **CONV).init(key, X0)["params"])


def _pair(tmp_path, name, jax_tree, port_module):
    """The same parameters as a JAX checkpoint ({"params": tree}) and a
    port checkpoint of ``port_module`` loaded from them, in two
    directories (each CLI writes beside its checkpoint)."""
    jpath = str(tmp_path / "jax" / f"{name}.msgpack")
    os.makedirs(os.path.dirname(jpath), exist_ok=True)
    save_pytree(jpath, {"params": jax_tree})
    load_flax_params(port_module, jax_tree)
    ppath = str(tmp_path / "port" / f"{name}.ckpt-1")
    save_checkpoint(ppath, port_module, None, 1)
    return jpath, ppath


def _cfgs(root, **kw):
    args = dict(CONV, DATA_ROOT=root, **{"network": "convrtsn", **kw})
    return (JaxEvalConfig(**args).resolve(),
            EvalConfig(device="cpu", **args).resolve())


def _close(got, want):
    assert np.isfinite(got["mAP"]) and 0 < got["mAP"] <= 1
    np.testing.assert_allclose(got["mAP"], want["mAP"], atol=1e-3)
    np.testing.assert_allclose(got["recall"][0], want["recall"][0],
                               atol=1e-3)


@pytest.mark.parametrize("use_output", [False, True],
                         ids=["core", "use_output"])
def test_evaluate_model_matches_jax(tmp_path, root, use_output):
    """``evaluate_model`` on a multitask checkpoint's core
    (``--variable_name modality_core``) or, with ``--use_output``, on a
    classifier's logits (head width from the checkpoint): mAP and Recall@1
    within atol 1e-3 of the JAX CLI's, mAP_event's classes equal, and
    ``results.pkl`` beside the port checkpoint."""
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    if use_output:
        tree = _np(JaxClassifier(
            n_seg=3, n_output=5, **{k: v for k, v in CONV.items()
                                    if k != "num_seg"}).init(keys[0], X0)[
            "params"])
        module = ConvTSNClassifier(
            n_seg=3, n_output=5, **{k: v for k, v in CONV.items()
                                    if k != "num_seg"})
        kw = dict(use_output=True, network="convtsn")
    else:
        tree = {"modality_core": _core(keys[0]),
                "modality_sensors": _np(JaxRTSN(n_seg=3, emb_dim=32).init(
                    keys[1], jnp.zeros((2, 3, 8)))["params"])}
        module = torch.nn.ModuleDict({
            "modality_core": build_encoder("convrtsn", **CONV),
            "modality_sensors": RTSN(3, 32, 8)})
        kw = dict(variable_name="modality_core")
    jpath, ppath = _pair(tmp_path, "model", tree, module)
    jcfg, pcfg = _cfgs(root, **kw)
    jcfg.model_path, pcfg.model_path = jpath, ppath
    want = jax_eval.run(jcfg)
    got = evaluate_model.run(pcfg)
    _close(got, want)
    assert sorted(got["mAP_event"]) == sorted(want["mAP_event"])
    with open(os.path.join(os.path.dirname(ppath), "results.pkl"),
              "rb") as f:
        assert pickle.load(f)["mAP"] == got["mAP"]


@pytest.mark.parametrize("use_output", [False, True],
                         ids=["sensors", "use_output"])
def test_evaluate_late_fusion_matches_jax(tmp_path, root, use_output):
    """``evaluate_late_fusion``: the core embedding with the sensors RTSN of
    a ``pddm_model`` checkpoint on the sensor features, or with
    ``--use_output`` the head of a ``cross_prediction`` checkpoint on that
    checkpoint's own encoder; mAP and Recall@1 within atol 1e-3 of the JAX
    CLI's."""
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    jcore, pcore = _pair(tmp_path, "core", _core(keys[0]),
                         build_encoder("convrtsn", **CONV))
    if use_output:
        tree = {"encoder": _core(keys[1]),
                "head": _np(JaxOutputLayer(n_output=8).init(
                    keys[2], jnp.zeros((2, 16)))["params"])}
        module = torch.nn.ModuleDict({
            "encoder": build_encoder("convrtsn", **CONV),
            "head": OutputLayer(16, 8)})
    else:
        e32 = jnp.zeros((2, 32))
        tree = {"encoder": _np(JaxRTSN(n_seg=3, emb_dim=32).init(
                    keys[1], jnp.zeros((2, 3, 8)))["params"]),
                "pddm": _np(JaxPDDM(n_input=32).init(
                    keys[2], e32, e32, method="score")["params"])}
        module = torch.nn.ModuleDict({"encoder": RTSN(3, 32, 8),
                                      "pddm": PDDM(32)})
    jside, pside = _pair(tmp_path, "side", tree, module)
    jcfg, pcfg = _cfgs(root, feat="resnet,sensors", use_output=use_output)
    jcfg.model_path, jcfg.sensors_path = jcore, jside
    pcfg.model_path, pcfg.sensors_path = pcore, pside
    want = jax_fusion.run(jcfg)
    got = evaluate_late_fusion.run(pcfg)
    _close(got, want)


def test_restore_is_strict(tmp_path):
    """``restore_encoder_params`` selects a scope and then a group where
    the checkpoint has it; loading into a module whose keys differ raises,
    and so does a scope the checkpoint lacks."""
    model = torch.nn.ModuleDict({"encoder": RTSN(3, 32, 8),
                                 "pddm": PDDM(32)})
    path = str(tmp_path / "m.ckpt-1")
    save_checkpoint(path, model, None, 1)
    enc = evaluate_model.restore_encoder_params(path, subkey="encoder")
    assert sorted(enc) == sorted(model["encoder"].state_dict())
    assert evaluate_model.restore_encoder_params(path, subkey="nope") \
        .keys() == model.state_dict().keys()
    with pytest.raises(KeyError, match="no scope"):
        evaluate_model.restore_encoder_params(path, "modality_core")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        evaluate_model.load_params(
            RTSN(3, 32, 8), evaluate_model.restore_encoder_params(path),
            torch.device("cpu"))
    with pytest.raises(RuntimeError, match="Missing key"):
        evaluate_model.load_params(RTSN(3, 32, 8), {}, torch.device("cpu"))


CLIS = {
    "evaluate_model": (evaluate_model, ["--feat", "resnet"]),
    "evaluate_late_fusion": (evaluate_late_fusion,
                             ["--feat", "resnet,sensors"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs_on_cpu_and_cuda_raises(tmp_path, root, monkeypatch, name):
    """``main([... --device cpu])`` prints the metrics; ``--device cuda``
    and the default raise when no card is visible."""
    module, extra = CLIS[name]
    core = build_encoder("convrtsn", **CONV)
    path = str(tmp_path / "core.ckpt-1")
    save_checkpoint(path, core, None, 1)
    side = torch.nn.ModuleDict({"encoder": RTSN(3, 32, 8), "pddm": PDDM(32)})
    side_path = str(tmp_path / "side.ckpt-1")
    save_checkpoint(side_path, side, None, 1)
    args = ["--DATA_ROOT", root, "--model_path", path, "--sensors_path",
            side_path, "--network", "convrtsn", *extra]
    for key, value in CONV.items():
        args += [f"--{key}", str(value)]
    module.main(args + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(args + dev)
