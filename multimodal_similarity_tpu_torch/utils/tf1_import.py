"""Import trained TF1 reference checkpoints into the port's model zoo.

The port of the JAX package's ``utils/tf1_import.py``.  The reference
saves ``tf.train.Saver`` name-based checkpoints over the models of its
``networks.py``; this module maps their variables onto the port's encoders
and heads, and ``tools/import_tf1.py`` writes the result as a port
checkpoint (``train/checkpoints.py``) that ``--model_path`` restores and
the eval CLIs read.

The mapping tables are the JAX ones, keyed by flax parameter paths; the
port's modules mirror those scopes, so ``convert.torch_leaf`` turns each
path into its state key (a Dense ``kernel`` [in, out] into the transposed
``weight``).  Layout facts the tables rely on (the reference's
``networks.py``):

- ``tf.nn.xw_plus_b`` weights are ``[in, out]``, flax Dense kernels too.
- ``tf.contrib.rnn.LSTMCell`` stores one fused kernel ``[in + units,
  4 * units]`` over ``concat([x, h])`` with gate order (i, j, f, o) and a
  runtime ``forget_bias``: ``models/lstm.TFLSTMCell``'s layout.
- The 1x1 conv embeds store ``[1, 1, in, C]`` filters with no bias; the
  port's ``ConvEmbed`` is a Linear over the channel axis, so the filter
  reshapes to ``[in, C]`` and the (extra) bias is zero.

Variable names resolve by exact match first, then by unique ``.../suffix``
match, so both TF1 RNN scopings (``RTSN/lstm_cell/kernel`` and
``RTSN/rnn/lstm_cell/kernel``) resolve, and optimizer slot variables never
collide with model weights.  Ambiguity is a loud error listing the
candidates.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch.convert import flax_scopes, torch_leaf

# sentinel source: fill the leaf with zeros (parameters the port model has
# but the reference model does not: the conv-embed bias).
ZEROS = "__zeros__"


def _conv_filter(a: np.ndarray) -> np.ndarray:
    """[1, 1, n_input, n_C] conv filter -> [n_input, n_C] Dense kernel."""
    a = np.asarray(a)
    if a.ndim != 4 or a.shape[0] != 1 or a.shape[1] != 1:
        raise ValueError(
            f"expected a [1, 1, in, C] 1x1 conv filter, got shape {a.shape}")
    return a.reshape(a.shape[2], a.shape[3])


_TRANSFORMS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "conv1x1": _conv_filter,
}

# One table per model: (tf variable name/suffix, flax params path, transform),
# the JAX package's tables.  The paths follow the module names of
# models/encoders.py / heads.py; LSTM cells live at
# <lstm-name>/cell/kernel/{kernel,bias} (models/lstm.py).
Spec = Tuple[str, Tuple[str, ...], Optional[str]]

_LSTM = lambda *prefix: (  # noqa: E731 - table-building shorthand
    ("lstm_cell/kernel", (*prefix, "cell", "kernel", "kernel"), None),
    ("lstm_cell/bias", (*prefix, "cell", "kernel", "bias"), None),
)

MAPPINGS: Dict[str, Tuple[Spec, ...]] = {
    # networks.py:425-465 — root-scope W_1/b_1/W_2/b_2
    "tsn": (
        ("W_1", ("fc1", "kernel"), None),
        ("b_1", ("fc1", "bias"), None),
        ("W_2", ("fc2", "kernel"), None),
        ("b_2", ("fc2", "bias"), None),
    ),
    # networks.py:383-422 — scope RTSN + dynamic_rnn(scope="RTSN")
    "rtsn": (
        ("RTSN/W_1", ("fc1", "kernel"), None),
        ("RTSN/b_1", ("fc1", "bias"), None),
        ("lstm_cell/kernel", ("lstm", "cell", "kernel", "kernel"), None),
        ("lstm_cell/bias", ("lstm", "cell", "kernel", "bias"), None),
    ),
    # networks.py:611-654 — root-scope W_emb/W/b, biasless 1x1 conv
    "convtsn": (
        ("W_emb", ("embed", "conv1x1", "kernel"), "conv1x1"),
        (ZEROS, ("embed", "conv1x1", "bias"), None),
        ("W", ("fc", "kernel"), None),
        ("b", ("fc", "bias"), None),
    ),
    # networks.py:659-716 — ConvTSN + classification head W_o/b_o
    "convtsnclassifier": (
        ("W_emb", ("embed", "conv1x1", "kernel"), "conv1x1"),
        (ZEROS, ("embed", "conv1x1", "bias"), None),
        ("W", ("fc", "kernel"), None),
        ("b", ("fc", "bias"), None),
        ("W_o", ("head", "kernel"), None),
        ("b_o", ("head", "bias"), None),
    ),
    # networks.py:519-559
    "convrtsn": (
        ("ConvRTSN/W_emb", ("embed", "conv1x1", "kernel"), "conv1x1"),
        (ZEROS, ("embed", "conv1x1", "bias"), None),
        *_LSTM("lstm"),
    ),
    # networks.py:468-515 — bidirectional, emb_dim//2 per direction
    "convbirtsn": (
        ("ConvBiRTSN/W_emb", ("embed", "conv1x1", "kernel"), "conv1x1"),
        (ZEROS, ("embed", "conv1x1", "bias"), None),
        ("fw/lstm_cell/kernel",
         ("bilstm", "fw", "cell", "kernel", "kernel"), None),
        ("fw/lstm_cell/bias",
         ("bilstm", "fw", "cell", "kernel", "bias"), None),
        ("bw/lstm_cell/kernel",
         ("bilstm", "bw", "cell", "kernel", "kernel"), None),
        ("bw/lstm_cell/bias",
         ("bilstm", "bw", "cell", "kernel", "bias"), None),
    ),
    # networks.py:563-606
    "convlstm": (
        ("ConvLSTM/W_emb", ("embed", "conv1x1", "kernel"), "conv1x1"),
        (ZEROS, ("embed", "conv1x1", "bias"), None),
        *_LSTM("lstm"),
    ),
    # networks.py:119-164 — flax SAE uses the reference's own param names
    "sae": (
        ("W_1", ("W_1",), None), ("b_1", ("b_1",), None),
        ("W_2", ("W_2",), None), ("b_2", ("b_2",), None),
        ("b_3", ("b_3",), None), ("b_4", ("b_4",), None),
    ),
    # networks.py:8-115 — scope Seq2seqTSN; encoder/decoder dynamic_rnn /
    # raw_rnn scopes "Seq2seqTSN/encoder" / "Seq2seqTSN/decoder"
    "seq2seqtsn": (
        ("W_encode", ("W_encode",), None),
        ("b_encode", ("b_encode",), None),
        ("W_decode1", ("W_decode1",), None),
        ("b_decode1", ("b_decode1",), None),
        ("b_decode2", ("b_decode2",), None),
        ("encoder/lstm_cell/kernel",
         ("encoder", "cell", "kernel", "kernel"), None),
        ("encoder/lstm_cell/bias",
         ("encoder", "cell", "kernel", "bias"), None),
        ("decoder/lstm_cell/kernel",
         ("decoder", "cell", "kernel", "kernel"), None),
        ("decoder/lstm_cell/bias",
         ("decoder", "cell", "kernel", "bias"), None),
    ),
    # networks.py:166-211 / 213-258 — both reference PairSim variants share
    # scope "PairSim" and variable names; only shapes differ (the flax
    # PairSim is the concat variant, PairSim2 the squared-difference one).
    # Head params nest under the "score" compact_name_scope (heads.py).
    "pairsim": (
        ("W_pairwise", ("score", "pairwise", "kernel"), None),
        ("b_pairwise", ("score", "pairwise", "bias"), None),
        ("W_o", ("score", "out", "kernel"), None),
        ("b_o", ("score", "out", "bias"), None),
    ),
    # networks.py:271-318
    "pddm": (
        ("W_u", ("score", "u", "kernel"), None),
        ("b_u", ("score", "u", "bias"), None),
        ("W_v", ("score", "v", "kernel"), None),
        ("b_v", ("score", "v", "bias"), None),
        ("W_c", ("score", "c", "kernel"), None),
        ("b_c", ("score", "c", "bias"), None),
        ("W_s", ("score", "s", "kernel"), None),
        ("b_s", ("score", "s", "bias"), None),
    ),
    # networks.py:322-354
    "outputlayer": (
        ("OutputLayer/W", ("fc", "kernel"), None),
        ("OutputLayer/b", ("fc", "bias"), None),
        ("W_o", ("out", "kernel"), None),
        ("b_o", ("out", "bias"), None),
    ),
    # networks.py:356-380
    "cublayer": (
        ("CUBLayer/W", ("fc", "kernel"), None),
        ("CUBLayer/b", ("fc", "bias"), None),
    ),
}
MAPPINGS["pairsim2"] = MAPPINGS["pairsim"]

# TF1 optimizer slot / bookkeeping variables a full training checkpoint
# carries next to the model weights — dropped on read.  Covers every
# optimizer the reference's factory offers (utils.py:12-15: ADAM,
# ADADELTA, ADAGRAD, MOMENTUM, SGD — SGD keeps no slots) plus RMSProp.
_SLOT_MARKERS = ("/Adam", "/Adadelta", "/Adagrad", "/RMSProp", "/Momentum",
                 "beta1_power", "beta2_power", "global_step", "save_counter")


def read_tf1_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a name-based TF1 ``.ckpt`` (or an ``.npz`` with the same
    variable names) into a plain dict, dropping optimizer slots."""
    if path.endswith(".npz"):
        raw = dict(np.load(path))
    else:
        import tensorflow as tf  # heavyweight — imported only on demand
        reader = tf.train.load_checkpoint(path)
        raw = {name: reader.get_tensor(name)
               for name in reader.get_variable_to_shape_map()}
    return {name: np.asarray(val) for name, val in raw.items()
            if not any(m in name for m in _SLOT_MARKERS)}


def _find(variables: Mapping[str, np.ndarray], name: str) -> np.ndarray:
    """Exact name match, else unique ``.../name`` suffix match."""
    if name in variables:
        return variables[name]
    hits = [k for k in variables if k.endswith("/" + name)]
    if len(hits) == 1:
        return variables[hits[0]]
    if not hits:
        raise KeyError(
            f"no checkpoint variable matches {name!r}; "
            f"available: {sorted(variables)}")
    raise KeyError(f"checkpoint variable {name!r} is ambiguous: {hits}")


def convert_tf1_variables(model: str, variables: Mapping[str, np.ndarray],
                          module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map reference TF1 ``variables`` onto the port ``module`` and return
    its ``state_dict``.  Coverage is total: every parameter and buffer of
    the module must come from the model's mapping table, and every
    produced array must fit its shape."""
    key = model.lower()
    if key not in MAPPINGS:
        raise ValueError(
            f"no TF1 mapping for model {model!r}; "
            f"supported: {sorted(MAPPINGS)}")
    expected = module.state_dict()
    scopes = flax_scopes(module)
    out: Dict[str, torch.Tensor] = {}
    for src, path, transform in MAPPINGS[key]:
        zeros = src == ZEROS
        arr = np.zeros(0) if zeros else np.asarray(_find(variables, src))
        if transform is not None:
            arr = _TRANSFORMS[transform](arr)
        try:
            name, arr = torch_leaf(path, arr, expected, scopes)
        except KeyError:
            raise KeyError(
                f"{model}: the port module has no leaf {'/'.join(path)}; "
                f"its parameters: {sorted(expected)}") from None
        if name in out:
            raise KeyError(f"{model}: {'/'.join(path)} -> {name}: filled "
                           "twice")
        want = tuple(expected[name].shape)
        if zeros:
            arr = np.zeros(want, np.float32)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{model}: {src} -> {'/'.join(path)} shape mismatch: "
                f"checkpoint {tuple(arr.shape)} vs port {want}")
        out[name] = torch.from_numpy(np.array(arr)).to(expected[name].dtype)
    left = sorted(set(expected) - set(out))
    if left:
        raise KeyError(
            f"{model}: mapping table left port parameters unfilled: {left}")
    return out
