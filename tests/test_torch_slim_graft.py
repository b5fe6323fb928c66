"""The port's slim graft (``…_torch/models/slim_graft.py``, and
InceptionV2's ``graft_slim_variables``) against the JAX one: each tower's
graft of a slim checkpoint leaf by leaf against the JAX graft carried
through ``convert.py``, literal slim names onto the port's state keys, the
same exception in both packages for each fault; and
``base_CUB(slim_checkpoint=...)`` against the JAX trainer.  The fake
checkpoints and the JAX shapes come from test_torch_backbones.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.configs import TrainConfig as JaxTrainConfig
from multimodal_similarity_tpu.models import CUBLayer as JaxCUBLayer
from multimodal_similarity_tpu.models import inception_v2 as jax_iv2
from multimodal_similarity_tpu.models import slim_graft as jax_graft
from multimodal_similarity_tpu.train.trainers import base_CUB as jax_base_CUB
from multimodal_similarity_tpu_torch import convert
from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params)
from multimodal_similarity_tpu_torch.models import (
    InceptionResNetV2, InceptionV1, InceptionV2)
from multimodal_similarity_tpu_torch.models import inception_v2 as iv2
from multimodal_similarity_tpu_torch.models import slim_graft
from multimodal_similarity_tpu_torch.train.trainers import base_CUB
from test_torch_backbones import (  # noqa: F401 (grafted: a fixture)
    TOWERS, _shapes, _slim, fake_slim, grafted)


def test_graft_matches_jax_graft_leaf_by_leaf(grafted):
    """For each tower, and InceptionV2 with its depthwise stem: the port's
    graft of a slim checkpoint equals the JAX graft of it carried through
    convert.py, every parameter and buffer bit for bit."""
    for name, (_, _, prefix, _) in TOWERS.items():
        variables, model = grafted[name]
        want = flax_to_state_dict(variables["params"], model,
                                  variables["batch_stats"])
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    shapes = jax.eval_shape(jax_iv2.InceptionV2().init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    slim = fake_slim(shapes, "InceptionV2", seed=4)
    jv = jax.tree.map(np.asarray, jax_iv2.graft_slim_variables(shapes, slim))
    model = iv2.graft_slim_variables(InceptionV2(), slim)
    want = flax_to_state_dict(jv["params"], model, jv["batch_stats"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_real_slim_names_map_to_port_keys():
    """Literal names of the released slim checkpoints map as the JAX
    mapper maps them, onto these state keys (the trunk's units hold its
    scopes); Logits are skipped."""
    cases = [
        ("InceptionResnetV2/Repeat_1/block17_12/Branch_1/Conv2d_0b_1x7/"
         "weights", "InceptionResnetV2", InceptionResNetV2,
         "units.24.Repeat_1_block17_12_Branch_1_Conv2d_0b_1x7.weight"),
        ("InceptionResnetV2/Repeat/block35_3/Conv2d_1x1/biases",
         "InceptionResnetV2", InceptionResNetV2,
         "units.4.Repeat_block35_3_Conv2d_1x1.bias"),
        ("InceptionResnetV2/Conv2d_7b_1x1/BatchNorm/moving_variance",
         "InceptionResnetV2", InceptionResNetV2,
         "units.43.Conv2d_7b_1x1_BatchNorm.running_var"),
        ("InceptionV1/Mixed_4e/Branch_2/Conv2d_0b_3x3/BatchNorm/beta",
         "InceptionV1", InceptionV1,
         "Mixed_4e_Branch_2_Conv2d_0b_3x3_BatchNorm.bias"),
        ("InceptionV1/Mixed_5b/Branch_2/Conv2d_0a_3x3/weights",
         "InceptionV1", InceptionV1,
         "Mixed_5b_Branch_2_Conv2d_0a_3x3.weight"),
        ("InceptionV2/Conv2d_1a_7x7/depthwise_weights", "InceptionV2",
         InceptionV2, "Conv2d_1a_7x7_depthwise.weight"),
    ]
    with torch.device("meta"):
        models = {cls: cls() for cls in (InceptionResNetV2, InceptionV1,
                                         InceptionV2)}
    for slim_name, prefix, cls, key in cases:
        assert slim_graft.slim_to_flax(slim_name, prefix) == \
            jax_graft.slim_to_flax(slim_name, prefix)
        got = slim_graft.slim_to_torch(slim_name, prefix, models[cls])
        assert got == key, slim_name
        assert key in models[cls].state_dict()
    assert slim_graft.slim_to_torch("InceptionV1/Logits/Conv2d_0c_1x1/"
                                    "weights", "InceptionV1",
                                    models[InceptionV1]) is None


def _edits(slim):
    """(case, edited checkpoint): each fault the graft must refuse."""
    conv = "InceptionV1/Mixed_4b_Branch_0_Conv2d_0a_1x1/weights"
    var = "InceptionV1/Mixed_3b_Branch_3_Conv2d_0b_1x1/BatchNorm/" \
          "moving_variance"

    return [
        ("unrecognized", {**slim, "InceptionV1/Mixed_4b/odd": np.zeros(1)}),
        ("no such module", {**slim, "InceptionV1/Mixed_9z/Conv2d/weights":
                            np.zeros((1, 1, 1, 1), np.float32)}),
        ("gamma", {**slim, "InceptionV1/Conv2d_1a_7x7/BatchNorm/gamma":
                   np.ones(64, np.float32)}),
        ("shape", {**slim, conv: slim[conv][..., :-1]}),
        ("missing kernel", {k: v for k, v in slim.items() if k != conv}),
        ("missing stat", {k: v for k, v in slim.items() if k != var}),
    ]


@pytest.mark.parametrize("case", ["unrecognized", "no such module", "gamma",
                                  "shape", "missing kernel", "missing stat"])
def test_graft_errors_are_loud_in_both(case):
    """The same faults raise the same exception type in both packages:
    an unrecognized name, a module or leaf the tower lacks (slim's gamma
    on a beta-only batch norm) and a leaf left unset (KeyError), a shape
    that does not fit (ValueError)."""
    shapes = _shapes("inception_v1", 32)
    slim = dict(_edits(_slim("inception_v1", 32)))[case]
    with pytest.raises((KeyError, ValueError)) as want:
        jax_graft.graft_slim_variables(shapes, slim, "InceptionV1")
    with torch.device("meta"):
        model = InceptionV1()
    with pytest.raises(want.type) as got:
        slim_graft.graft_slim_state(model, slim, "InceptionV1")
    if case.startswith("missing"):
        assert "unset" in str(got.value)


def test_irv2_scope_table_and_twice_filled_keys_raise():
    """The trunk's ``flax_scopes()`` names each of its flat scopes once,
    in the unit that holds it; only a model with such a table resolves a
    scope it lacks (InceptionV1 has none).  A state key that two leaves
    would fill raises KeyError in ``flax_to_state_dict`` (the flat scope
    and its module path both given) and in the graft (the same variable
    with and without the slim prefix)."""
    with torch.device("meta"):
        trunk, v1 = InceptionResNetV2(), InceptionV1()
    table = trunk.flax_scopes()
    children = [n for unit in trunk.units for n, _ in unit.named_children()]
    assert len(table) == len(children) == len(set(children))
    assert table["Repeat_1_block17_12_Branch_1_Conv2d_0b_1x7"] == \
        "units.24.Repeat_1_block17_12_Branch_1_Conv2d_0b_1x7"
    assert {k.rsplit(".", 1)[0] for k in trunk.state_dict()} == \
        set(table.values())
    assert convert.flax_scopes(v1) == {}
    with pytest.raises(KeyError, match="no torch counterpart|no parameter"):
        convert.flax_to_state_dict(
            {"units": {"0": {"Conv2d_1a_7x7": {"kernel": np.zeros(
                (7, 7, 3, 64), np.float32)}}}}, v1)
    bn = {"bias": np.zeros(32, np.float32)}
    with pytest.raises(KeyError, match="filled twice"):
        convert.flax_to_state_dict(
            {"Conv2d_1a_3x3_BatchNorm": bn,
             "units": {"0": {"Conv2d_1a_3x3_BatchNorm": bn}}}, trunk)
    slim = _slim("inception_v1", 32)
    name = "InceptionV1/Conv2d_1a_7x7/weights"
    with pytest.raises(KeyError, match="filled twice"):
        slim_graft.graft_slim_state(
            v1, {**slim, name.split("/", 1)[1]: slim[name]}, "InceptionV1")


def test_base_cub_slim_checkpoint_grafts_as_jax(tmp_path, monkeypatch):
    """``base_CUB.train(slim_checkpoint=...)`` with ``--network
    inception_v2``: the port grafts the same initial tower as the JAX
    trainer (every leaf bit for bit), and with the JAX head carried in,
    one semi-hard triplet step's loss matches the JAX trainer's at rtol
    1e-4 (test_torch_inception.py's step tolerance)."""
    rng = np.random.RandomState(0)
    size, n_cls = 32, 8
    tint = rng.rand(n_cls, 1, 1, 3)
    lab = np.repeat(np.arange(n_cls), 6)
    lab_te = np.repeat(np.arange(1, 5), 4)
    data = {
        "image_train": np.clip(tint[lab] + 0.3 * rng.rand(48, size, size, 3),
                               0, 1).astype(np.float32),
        "label_train": lab,
        "image_test": np.clip(tint[lab_te - 1]
                              + 0.3 * rng.rand(16, size, size, 3),
                              0, 1).astype(np.float32),
        "label_test": lab_te}
    kw = dict(name="t", silent_mode=True, emb_dim=16, learning_rate=1e-3,
              keep_prob=1.0, max_epochs=1, network="inception_v2",
              loss="triplet", DATA_ROOT=str(tmp_path))
    jcfg, pcfg = JaxTrainConfig(**kw).resolve(), TrainConfig(**kw).resolve()
    shapes = jax.eval_shape(jax_iv2.InceptionV2().init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    npz = str(tmp_path / "v2.npz")
    np.savez(npz, **fake_slim(shapes, "InceptionV2", seed=9))

    key = jax.random.PRNGKey(jcfg.seed)
    head = jax.tree.map(np.asarray, JaxCUBLayer(n_output=16).init(
        key, jnp.zeros((2, 1024)))["params"])
    jv = jax.tree.map(np.asarray, jax_iv2.graft_slim_npz(shapes, npz))
    built = {}

    def build_model(cfg, device):
        model = build(cfg, device)
        load_flax_params(model.CUBLayer, head)
        built["model"] = model
        return model

    build = base_CUB.build_model
    monkeypatch.setattr(base_CUB, "build_model", build_model)
    grafted = {}
    graft = base_CUB.graft_slim_npz

    def graft_and_keep(tower, path):
        out = graft(tower, path)
        grafted.update({k: v.clone() for k, v in tower.state_dict().items()})
        return out

    monkeypatch.setattr(base_CUB, "graft_slim_npz", graft_and_keep)
    monkeypatch.setattr(jax_iv2.InceptionV2, "init",
                        lambda self, k, x: jax.tree.map(
                            lambda s: jnp.zeros(s.shape, s.dtype), shapes))
    _, _, jax_dir = jax_base_CUB.train(jcfg, data=data, crop=size,
                                       slim_checkpoint=npz,
                                       result_dir=str(tmp_path / "jax"))
    res = base_CUB.train(pcfg, data=data, crop=size, slim_checkpoint=npz,
                         result_dir=str(tmp_path / "port"), device="cpu")
    want = flax_to_state_dict(jv["params"], InceptionV2(),
                              jv["batch_stats"])
    assert grafted.keys() == want.keys()
    for k in want:
        assert torch.equal(grafted[k], want[k]), k

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f
                    if '"loss"' in line]

    assert len(losses(res.result_dir)) == 1
    np.testing.assert_allclose(losses(res.result_dir), losses(jax_dir),
                               rtol=1e-4)
