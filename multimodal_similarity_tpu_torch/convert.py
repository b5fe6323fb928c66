"""Map the JAX package's params onto the port's modules.

``params`` is the flax ``params`` collection as a nested mapping of numpy
arrays (``jax.tree.map(np.asarray, variables["params"])``).  The port's
module paths mirror the flax scopes, so the map is by name:

* a flax Dense ``<scope>/kernel [in, out]`` becomes the torch
  ``<scope>.weight [out, in]`` (transposed);
* ``<scope>/bias`` becomes ``<scope>.bias``;
* the LSTM cell's fused gate Dense, ``lstm/cell/kernel/{kernel,bias}``,
  becomes ``lstm.cell.kernel.{weight,bias}``, the cell's one fused
  ``[x; h]`` weight with the gates in the same (i, j, f, o) order.

Every leaf must be consumed and every torch parameter filled: a missing or
extra leaf, or a shape that does not fit, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def flax_to_state_dict(params: Mapping,
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """The torch ``state_dict`` of ``model`` holding the flax ``params``."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *scope, leaf = path
        where = "/".join(path)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{where}: only 2-D Dense kernels map, "
                                 f"got shape {arr.shape}")
            name, arr = ".".join(scope + ["weight"]), arr.T
        elif leaf == "bias":
            name = ".".join(scope + ["bias"])
        else:
            raise KeyError(f"JAX leaf {where} has no torch counterpart")
        if name not in expected:
            raise KeyError(f"extra JAX leaf {where}: the model has no "
                           f"parameter {name}")
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(f"{where} -> {name}: shape {arr.shape} does "
                             f"not fit {tuple(expected[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(
            expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"no JAX leaf for the model's parameters {missing}")
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``model`` in place with the flax ``params``; returns it."""
    state = flax_to_state_dict(params, model)
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    return model
