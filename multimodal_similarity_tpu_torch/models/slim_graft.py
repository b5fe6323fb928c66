"""TF-slim checkpoint -> the port's towers.

The port of the JAX package's ``models/slim_graft.py``, with its rules and
its errors.  A slim conv scope ``A/B/Conv2d_x`` is the flat module name
``A_B_Conv2d_x`` (``_BatchNorm`` for its batch norm, ``_depthwise`` /
``_pointwise`` for a separable stem), the module of that name or, where
the model has a ``flax_scopes()`` table (the Inception-ResNet-v2 trunk's
units), the module the table names.  The leaves map as:

* ``weights`` [kh, kw, in, out] -> the conv's ``weight`` [out, in, kh, kw];
* ``depthwise_weights`` [kh, kw, C, M] -> the grouped conv's ``weight``
  [C M, 1, kh, kw] (output channel c M + m, as ``tf.nn.depthwise_conv2d``);
* ``pointwise_weights`` as ``weights``; ``biases`` -> ``bias``;
* ``BatchNorm/beta`` -> ``bias``, ``BatchNorm/gamma`` -> ``scale`` (no
  port batch norm has one: it raises, as in JAX), ``moving_mean`` /
  ``moving_variance`` -> the ``running_mean`` / ``running_var`` buffers.

Logits, AuxLogits, optimizer slots, moving averages and ``global_step``
are skipped.  Every mapped variable must land on a parameter or buffer of
its shape, and every parameter and buffer must be covered.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_similarity_tpu_torch.convert import flax_scopes

# scopes with no trunk counterpart in any of the slim nets
_SKIP_PREFIXES = ("Logits", "AuxLogits")
_SKIP_SUFFIXES = ("/Momentum", "/RMSProp", "/RMSProp_1", "/Adam", "/Adam_1")

# flax leaf -> the port's parameter or buffer name
_TORCH_LEAF = {"kernel": "weight", "bias": "bias", "scale": "scale",
               "mean": "running_mean", "var": "running_var"}


def slim_to_flax(slim_name: str, prefix: str) -> Optional[Tuple[str, ...]]:
    """One slim variable name -> (collection, flat module, flax leaf), as
    the JAX function maps it; None for a variable with no trunk
    counterpart (Logits, optimizer slots)."""
    name = slim_name
    if name.startswith(prefix + "/"):
        name = name[len(prefix) + 1:]
    if name.startswith(_SKIP_PREFIXES) or name == "global_step" \
            or "/ExponentialMovingAverage" in name \
            or name.endswith(_SKIP_SUFFIXES):
        return None
    parts = name.split("/")
    leaf = parts[-1]
    if leaf == "depthwise_weights":
        return ("params", "_".join(parts[:-1]) + "_depthwise", "kernel")
    if leaf == "pointwise_weights":
        return ("params", "_".join(parts[:-1]) + "_pointwise", "kernel")
    if leaf == "weights":
        return ("params", "_".join(parts[:-1]), "kernel")
    if leaf == "biases":
        return ("params", "_".join(parts[:-1]), "bias")
    if len(parts) >= 2 and parts[-2] == "BatchNorm":
        scope = "_".join(parts[:-2]) + "_BatchNorm"
        if leaf == "beta":
            return ("params", scope, "bias")
        if leaf == "gamma":
            return ("params", scope, "scale")
        if leaf == "moving_mean":
            return ("batch_stats", scope, "mean")
        if leaf == "moving_variance":
            return ("batch_stats", scope, "var")
    raise KeyError(f"unrecognized slim variable: {slim_name}")


def slim_to_torch(slim_name: str, prefix: str, model: nn.Module
                  ) -> Optional[str]:
    """The state key of ``model`` that the slim variable fills (whether or
    not the model has it); None where ``slim_to_flax`` skips it."""
    return _torch_name(slim_to_flax(slim_name, prefix), flax_scopes(model))


def _torch_name(dest, scopes: Mapping[str, str]) -> Optional[str]:
    if dest is None:
        return None
    _, module, leaf = dest
    return scopes.get(module, module) + "." + _TORCH_LEAF[leaf]


def graft_slim_state(model: nn.Module, slim_vars: Mapping[str, np.ndarray],
                     prefix: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` holding a slim checkpoint (a name ->
    array dict, e.g. an .npz conversion of the slim .ckpt).  A variable
    with no parameter raises KeyError, a shape that does not fit
    ValueError, and a parameter or buffer no variable covers KeyError."""
    expected = model.state_dict()
    scopes = flax_scopes(model)
    out: Dict[str, torch.Tensor] = {}
    for slim_name, value in slim_vars.items():
        dest = slim_to_flax(slim_name, prefix)
        if dest is None:
            continue
        name = _torch_name(dest, scopes)
        if name not in expected:
            raise KeyError(f"{slim_name} -> {dest}: no such port "
                           f"parameter ({name})")
        if name in out:
            raise KeyError(f"{slim_name} -> {name}: filled twice")
        value = np.asarray(value)
        if value.ndim == 4:
            if slim_name.split("/")[-1] == "depthwise_weights":
                h, w, c, m = value.shape
                value = value.reshape(h, w, 1, c * m)
            value = value.transpose(3, 2, 0, 1)
        want = tuple(expected[name].shape)
        if tuple(value.shape) != want:
            raise ValueError(
                f"{slim_name}: shape {value.shape} != port {want}")
        out[name] = torch.from_numpy(np.array(value)).to(
            expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"slim checkpoint leaves {len(missing)} port "
                       f"parameters unset, e.g. {missing[:4]}")
    return out


def graft_slim_variables(model: nn.Module,
                         slim_vars: Mapping[str, np.ndarray],
                         prefix: str) -> nn.Module:
    """Fill ``model`` in place from a slim checkpoint dict; returns it."""
    state = graft_slim_state(model, slim_vars, prefix)
    model.load_state_dict(state)
    return model


def graft_slim_npz(model: nn.Module, path: str, prefix: str) -> nn.Module:
    """Graft from an .npz of {slim variable name: array}."""
    with np.load(path) as data:
        return graft_slim_variables(model, dict(data), prefix)
