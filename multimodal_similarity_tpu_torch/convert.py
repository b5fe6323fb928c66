"""Map the JAX package's params onto the port's modules.

``params`` is the flax ``params`` collection as a nested mapping of numpy
arrays (``jax.tree.map(np.asarray, variables["params"])``), and
``batch_stats``, where the model has batch norms, the flax ``batch_stats``
collection in the same form.  The port's module paths mirror the flax
scopes, so the map is by name:

* a flax Dense ``<scope>/kernel [in, out]`` becomes the torch
  ``<scope>.weight [out, in]`` (transposed);
* a flax Conv ``<scope>/kernel [kh, kw, in / groups, out]`` (HWIO)
  becomes ``<scope>.weight [out, in / groups, kh, kw]`` (OIHW), the
  depthwise stem's ``[7, 7, 1, 24]`` with 3 groups included: both frames
  give group g the outputs [g out / groups, (g + 1) out / groups);
* ``<scope>/bias`` becomes ``<scope>.bias``;
* the batch stats ``<scope>/mean`` and ``<scope>/var`` become the buffers
  ``<scope>.running_mean`` and ``<scope>.running_var``;
* the LSTM cell's fused gate Dense, ``lstm/cell/kernel/{kernel,bias}``,
  becomes ``lstm.cell.kernel.{weight,bias}``, the cell's one fused
  ``[x; h]`` weight with the gates in the same (i, j, f, o) order (so do
  the autoencoder's ``encoder/cell/...`` and ``decoder/cell/...``);
* any other leaf, a raw ``self.param`` such as ``W_encode`` or ``b_4``,
  becomes the torch parameter of the same name, untransposed.

Every leaf must be consumed and every torch parameter and buffer filled: a
missing or extra leaf, or a shape that does not fit, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params: Mapping, model: nn.Module,
                       batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """The torch ``state_dict`` of ``model`` holding the flax ``params``
    (and ``batch_stats``)."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leaves = [(path, arr, False) for path, arr in _flatten(params)]
    leaves += [(path, arr, True) for path, arr in _flatten(batch_stats or {})]
    for path, arr, is_stat in leaves:
        *scope, leaf = path
        where = "/".join(path)
        if is_stat:
            if leaf not in _STATS:
                raise KeyError(f"batch stat {where} has no torch "
                               "counterpart")
            name = ".".join(scope + [_STATS[leaf]])
        elif leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{where}: only 2-D Dense and 4-D Conv "
                                 f"kernels map, got shape {arr.shape}")
            name = ".".join(scope + ["weight"])
        elif leaf == "bias":
            name = ".".join(scope + ["bias"])
        else:
            name = ".".join(scope + [leaf])
            if name not in expected:
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
        raise KeyError(f"no JAX leaf for the model's parameters and "
                       f"buffers {missing}")
    return out


def load_flax_params(model: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``model`` in place with the flax ``params`` (and
    ``batch_stats``); returns it."""
    state = flax_to_state_dict(params, model, batch_stats)
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in state.items()})
    return model
