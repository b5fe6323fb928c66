"""Checkpointing in the port's own format.

One file per step, ``<name>.ckpt-<step>``, holding a ``torch.save`` dict of
the model's ``state_dict``, the optimizer's ``state_dict`` and the step,
pruned to ``max_to_keep`` like the reference's ``tf.train.Saver``.  Files
are read with ``weights_only=True``: plain tensors and containers only.
The JAX package's msgpack checkpoints are not read here; ``convert.py``
maps JAX params onto the port's modules.
"""

from __future__ import annotations

import glob
import os
import re
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    step: int, state: Optional[tuple] = None) -> str:
    """Write-then-rename: a crash mid-write never leaves a truncated file at
    the final path.  ``state``: the (model, optimizer) state dicts to write
    in place of ``model``'s and ``optimizer``'s (a tensor-parallel run's
    whole state, ``parallel.tensor_parallel.gather_state_tp``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    if state is None:
        state = (model.state_dict(),
                 optimizer.state_dict() if optimizer is not None else None)
    torch.save({"model": state[0], "optimizer": state[1],
                "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Restore ``model`` (and ``optimizer``, when the file has its state)
    in place; returns the saved step."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None and ckpt["optimizer"] is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["step"])


def _select(params: Dict[str, torch.Tensor], scope: str):
    prefix = scope.strip("/").replace("/", ".") + "."
    return OrderedDict((k[len(prefix):], v) for k, v in params.items()
                       if k.startswith(prefix))


def restore_encoder_params(model_path: str, variable_name: str = "",
                           subkey: Optional[str] = None
                           ) -> Dict[str, torch.Tensor]:
    """The parameters of a port checkpoint, on the CPU: those under scope
    ``variable_name`` (raises when it has none), then those under
    ``subkey`` where the checkpoint has that group, each prefix dropped."""
    ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
    params = ckpt.get("model", ckpt)
    if variable_name:
        params = _select(params, variable_name)
        if not params:
            raise KeyError(f"{model_path} has no scope {variable_name!r}")
    if subkey:
        params = _select(params, subkey) or params
    return params


class CheckpointManager:
    def __init__(self, directory: str, name: str = "model",
                 max_to_keep: int = 10):
        self.directory = directory
        self.name = name
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.name}.ckpt-{step}")

    def all_steps(self):
        pat = re.compile(re.escape(self.name) + r"\.ckpt-(\d+)$")
        steps = []
        for p in glob.glob(os.path.join(self.directory,
                                        f"{self.name}.ckpt-*")):
            m = pat.search(p)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, model: nn.Module, optimizer, step: int,
             state: Optional[tuple] = None) -> str:
        path = save_checkpoint(self._path(step), model, optimizer, step,
                               state)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, model: nn.Module, optimizer=None,
                step: Optional[int] = None) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint for '{self.name}' in {self.directory}")
        return load_checkpoint(self._path(step), model, optimizer)
