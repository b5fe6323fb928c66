"""The port's TF1 checkpoint import (``…_torch/utils/tf1_import.py``,
``…_torch/tools/import_tf1.py``) against the JAX one: for every model the
JAX tests import, the port module's state equals ``convert.py`` applied to
the JAX import of the same TF1 variables, bit for bit; the CLI from an
``.npz`` through the dispatcher (``--scope``, ``--print_vars``) writes a
port checkpoint that ``restore_encoder_params`` reads and that equals the
JAX CLI's output carried through ``convert.py``; optimizer slots are
dropped; the loud errors.  The real TF1 ``.ckpt`` round trip is ``slow``
and needs tensorflow, as in JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_similarity_tpu.tools import import_tf1 as jax_cli
from multimodal_similarity_tpu.train.checkpoints import load_pytree
from multimodal_similarity_tpu.utils import tf1_import as jax_tf1
from multimodal_similarity_tpu_torch import __main__ as port_main
from multimodal_similarity_tpu_torch.convert import flax_to_state_dict
from multimodal_similarity_tpu_torch.tools import import_tf1 as cli
from multimodal_similarity_tpu_torch.train.checkpoints import (
    restore_encoder_params)
from multimodal_similarity_tpu_torch.utils import tf1_import
from test_tf1_import import _TF1_WRITER, _variables_for

MODELS = ["tsn", "rtsn", "convtsn", "convtsnclassifier", "convrtsn",
          "convbirtsn", "convlstm", "sae", "seq2seqtsn", "pairsim",
          "pairsim2", "pddm", "outputlayer", "cublayer"]


def _jax_params(model, variables, dims=(3, 2, 3, 4)):
    mod, args, kwargs = jax_cli._build(model, variables, *dims)
    template = mod.init(jax.random.PRNGKey(0), *args, **kwargs)["params"]
    return jax.tree.map(np.asarray, jax_tf1.convert_tf1_variables(
        model, variables, template))


@pytest.mark.parametrize("model", MODELS)
def test_every_model_imports_as_jax(model):
    """The port module built from the checkpoint's shapes holds, leaf by
    leaf, what convert.py makes of the JAX import (the conv embeds' zero
    bias included)."""
    variables = _variables_for(model)
    module = cli._build(model, variables, 3, 2, 3, 4)
    got = tf1_import.convert_tf1_variables(model, variables, module)
    want = flax_to_state_dict(_jax_params(model, variables), module)
    assert got.keys() == want.keys() == module.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), (model, k)


def test_the_tables_are_the_jax_tables():
    assert tf1_import.MAPPINGS == jax_tf1.MAPPINGS
    assert tf1_import._SLOT_MARKERS == jax_tf1._SLOT_MARKERS


def test_cli_from_npz_through_the_dispatcher(tmp_path, capsys):
    """``tools.import_tf1`` on an .npz of the flagship's two branches:
    ``--print_vars`` lists them, ``--scope`` picks one, and the port
    checkpoint holds the JAX CLI's params carried through convert.py; the
    eval CLIs' restore reads it; optimizer slots are dropped."""
    sens = _variables_for("rtsn")
    seg = {k: v + 1.0 for k, v in _variables_for("rtsn").items()}
    both = {f"modality_sensors/{k}": v for k, v in sens.items()}
    both.update({f"modality_segment/{k}": v for k, v in seg.items()})
    both["modality_sensors/RTSN/W_1/Adam"] = np.zeros_like(sens["RTSN/W_1"])
    both["global_step"] = np.int64(9)
    npz = str(tmp_path / "flagship.npz")
    np.savez(npz, **both)
    assert port_main.main(["tools.import_tf1", "--ckpt", npz, "--model",
                           "rtsn", "--print_vars"]) == 0
    listed = capsys.readouterr().out
    assert "modality_segment/RTSN/W_1  (5, 8)" in listed
    assert "Adam" not in listed and "global_step" not in listed
    out = str(tmp_path / "sensors.ckpt-0")
    jax_out = str(tmp_path / "sensors.msgpack")
    args = ["--ckpt", npz, "--model", "rtsn", "--scope", "modality_sensors"]
    assert port_main.main(["tools.import_tf1"] + args
                          + ["--output", out]) == 0
    assert "imported rtsn" in capsys.readouterr().out
    jax_cli.main(args + ["--output", jax_out])
    module = cli._build("rtsn", sens, 3, 8, 8, 90)
    want = flax_to_state_dict(
        jax.tree.map(np.asarray, load_pytree(jax_out, None)["params"]),
        module)
    got = restore_encoder_params(out)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(got["lstm.cell.kernel.weight"].numpy(),
                                  sens["RTSN/lstm_cell/kernel"].T)
    with pytest.raises(SystemExit):
        port_main.main(["tools.import_tf1", "--ckpt", npz, "--model",
                        "rtsn", "--scope", "nope", "--output", out])
    with pytest.raises(SystemExit):
        port_main.main(["tools.import_tf1", "--ckpt", npz, "--model",
                        "rtsn"])


def test_import_errors_are_loud(tmp_path):
    """Ambiguous or missing variables and a shape that does not fit raise
    the JAX import's exception types; so do an unknown model, a ConvTSN
    grid that does not fit, a table leaf the module lacks and a module
    parameter the table leaves unfilled."""
    sens = _variables_for("rtsn")
    both = {**{f"a/{k}": v for k, v in sens.items()},
            **{f"b/{k}": v for k, v in sens.items()}}
    module = cli._build("rtsn", sens, 3, 2, 3, 4)
    template = jax_cli._build("rtsn", sens, 3, 2, 3, 4)
    jmod, jargs, jkw = template
    jtemplate = jmod.init(jax.random.PRNGKey(0), *jargs, **jkw)["params"]
    bad_shape = dict(sens, **{"RTSN/b_1": np.zeros(3, np.float32)})
    missing = {k: v for k, v in sens.items() if k != "RTSN/b_1"}
    for variables, err in ((both, KeyError), (missing, KeyError),
                           (bad_shape, ValueError)):
        with pytest.raises(err):
            jax_tf1.convert_tf1_variables("rtsn", variables, jtemplate)
        with pytest.raises(err):
            tf1_import.convert_tf1_variables("rtsn", variables, module)
    with pytest.raises(ValueError, match="no TF1 mapping"):
        tf1_import.convert_tf1_variables("nope", sens, module)
    with pytest.raises(ValueError, match="n_h"):
        cli._build("convtsn", _variables_for("convtsn"), 3, 8, 8, 4)
    with pytest.raises(KeyError, match="has no leaf fc2"):
        tf1_import.convert_tf1_variables("tsn", _variables_for("tsn"),
                                         module)
    classifier = cli._build("convtsnclassifier",
                            _variables_for("convtsnclassifier"), 3, 2, 3, 4)
    with pytest.raises(KeyError, match="unfilled.*head"):
        tf1_import.convert_tf1_variables(
            "convtsn", _variables_for("convtsn"), classifier)


@pytest.mark.slow
def test_real_tf1_ckpt_roundtrip(tmp_path):
    """A name-based .ckpt written by ``tf.compat.v1`` Saver in a
    subprocess, imported through the port CLI: the TF reader drops
    ``global_step`` and the checkpoint holds the variables."""
    pytest.importorskip("tensorflow")
    prefix = str(tmp_path / "ref_model.ckpt")
    r = subprocess.run([sys.executable, "-c", _TF1_WRITER, prefix],
                       capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-2000:]
    variables = tf1_import.read_tf1_checkpoint(prefix)
    assert "global_step" not in variables
    out = str(tmp_path / "model.ckpt-0")
    cli.main(["--ckpt", prefix, "--model", "rtsn", "--output", out])
    got = restore_encoder_params(out)
    np.testing.assert_array_equal(got["lstm.cell.kernel.weight"].numpy(),
                                  variables["RTSN/rnn/lstm_cell/kernel"].T)
    np.testing.assert_array_equal(got["fc1.weight"].numpy(),
                                  variables["RTSN/W_1"].T)
