"""Tensor parallelism on ``torch.distributed``: a data x model process mesh
and column-sharded parameters and optimizer moments (the JAX package's
``parallel/tensor_parallel.py``).

The encoders are small enough that data parallelism usually suffices, but
wide configurations (emb_dim >= 1024) can shard their weight matrices over
a "model" axis.  JAX places the leaves and lets XLA SPMD partition every
product; here one process drives one device (ROADMAP D6), so the layers
do it themselves:

* the rule (:func:`tp_spec_for`) is JAX's, decided on the flax leaf's
  shape: a leaf is split along its trailing flax dim when that divides by
  the model axis and is at least twice it.  Through ``convert.py``'s
  layouts that dim is torch dim 0 of a Linear or Conv weight (flax [in,
  out] and HWIO kernels become [out, in] and OIHW), of a bias, and of the
  LSTM's fused gate weight (whose four gates then split over the model
  ranks); a raw parameter keeps its last dim;
* a Linear or Conv2d whose weight is split computes only this rank's
  output columns with its bias slice; the columns rejoin through an
  all-gather over the model group whose backward keeps this rank's
  columns, and the layer's input gradient is all-reduced over the model
  group (Megatron's column-parallel layer with a gathered output).  Any
  other split leaf is all-gathered where it is used;
* the shards' gradients are complete on their own rank, so the trainers
  sum gradients over the data group alone, and an optimizer built on the
  shards holds sharded moments and steps with no collective, as in JAX.

Every model rank of one data row runs the same replicated computation
around the split layers: the same batch rows, the same dropout masks and
the same miner draws.  A checkpoint is written from
:func:`gather_state_tp`'s whole state, the file a run without tensor
parallelism writes; ``--model_path`` restores it whole before sharding.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from multimodal_similarity_tpu_torch.parallel.mesh import (
    ProcessMesh, create_mesh, world_size)


class TPMesh(NamedTuple):
    """A (data, model) process mesh: rank r sits at data row r // mp and
    model column r % mp, as JAX's ``create_2d_mesh`` places device r, so
    each model group is mp consecutive ranks.  ``data`` is this rank's data
    sub-group (size the data axis, rank its data row): the rings, the
    data-parallel steps and the sharded cache run on it.  ``model`` is its
    model group (size mp, rank its column).  ``world`` is the whole
    group, whose rank 0 owns the checkpoints."""

    data: ProcessMesh
    model: ProcessMesh
    world: ProcessMesh

    @property
    def shape(self):
        return {"data": self.data.size, "model": self.model.size}


class TPShard(NamedTuple):
    """What :func:`shard_module_tp` records on a split parameter
    (``param.tp_shard``): the torch dim split, its whole size, the
    parameter's name on its module, and the model group."""

    dim: int
    full: int
    leaf: str
    mesh: ProcessMesh

    def whole_sum(self, part: torch.Tensor) -> torch.Tensor:
        """The sum over the model group of ``part``, a function of this
        rank's shard alone; the gradient flows to the shard unchanged."""
        return _SumOverModel.apply(part, self.mesh)


def _flax_trailing_dim(module: nn.Module, leaf: str,
                       param: torch.Tensor) -> int:
    """The torch dim holding the trailing dim of the flax leaf that
    ``convert.py`` maps onto ``module.<leaf>``."""
    if isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)) and \
            leaf in ("weight", "bias"):
        return 0
    return param.ndim - 1


def tp_spec_for(module: nn.Module, leaf: str, param: torch.Tensor,
                size: int) -> Optional[int]:
    """The torch dim along which ``module.<leaf>`` is split over a model
    axis of ``size``, or None (replicated): JAX's rule on the flax leaf's
    trailing dim, which must divide by ``size`` and be at least twice
    it.  Scalars are replicated."""
    if param.ndim == 0:
        return None
    dim = _flax_trailing_dim(module, leaf, param)
    n = param.shape[dim]
    return dim if n % size == 0 and n >= 2 * size else None


def _direct_params(model: nn.Module):
    """(qualified name, module, leaf, parameter) of every parameter, each
    on the module that owns it."""
    for mod_name, module in model.named_modules():
        for leaf, param in module._parameters.items():
            if param is not None:
                yield (f"{mod_name}.{leaf}" if mod_name else leaf, module,
                       leaf, param)


def tp_sharded_leaves(model: nn.Module, size: int) -> List[Tuple[str, int]]:
    """[(parameter name, torch dim)] of the leaves a model axis of ``size``
    splits: the trainers' check that --model_parallel shards something (an
    all-replicated "tp" run would be a silent no-op)."""
    out = []
    for name, module, leaf, param in _direct_params(model):
        dim = tp_spec_for(module, leaf, param, size)
        if dim is not None:
            out.append((name, dim))
    return out


def _group(ranks: List[int], world: int):
    """A new process group over ``ranks`` (the default group when that is
    all of them).  Every rank must call this for every group, in the same
    order."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def create_2d_mesh(n_devices: Optional[int] = None,
                   model_parallel: int = 2) -> TPMesh:
    """The (n / model_parallel) x model_parallel mesh over the initialised
    process group; ``n_devices``, when given, must be its world size."""
    world = create_mesh(n_devices)
    n, mp = world.size, model_parallel
    if mp < 1 or n % mp:
        raise ValueError(f"model axis {mp} does not divide the {n}-process "
                         "group")
    model_groups = [_group(list(range(d * mp, (d + 1) * mp)), n)
                    for d in range(n // mp)]
    data_groups = [_group(list(range(c, n, mp)), n) for c in range(mp)]
    r = world.rank
    return TPMesh(
        data=ProcessMesh(n // mp, r // mp, data_groups[r % mp], world.device),
        model=ProcessMesh(mp, r % mp, model_groups[r // mp], world.device),
        world=world)


def auto_mesh_tp(batch_axis_size: int, model_parallel: int,
                 verbose: bool = True):
    """(mesh, rounded_batch_axis_size) for --model_parallel N: the
    (processes / N) x N data x model mesh over the process group, with the
    batch axis rounded up to a multiple of the data axis.  N must divide
    the processes (one device a process; without a process group there is
    one) and, on more than one host, the processes of one host: a model
    group must not span hosts.  N == the processes is pure tensor
    parallelism (a data axis of 1)."""
    n_devices = world_size()
    if model_parallel > n_devices or n_devices % model_parallel:
        raise ValueError(
            f"--model_parallel {model_parallel} does not divide the "
            f"{n_devices} visible devices")
    # the processes of this host: torchrun sets LOCAL_WORLD_SIZE; without
    # it (--multihost's coordinator flags) a process is a host
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if n_devices // local > 1 and local % model_parallel:
        raise ValueError(
            f"--model_parallel {model_parallel} does not divide the "
            f"{local} devices per host; a tp group must not span hosts")
    data = n_devices // model_parallel
    rounded = -(-batch_axis_size // data) * data
    if verbose:
        print(f"[parallel] dp x tp mesh {data} x {model_parallel}"
              + (f"; batch axis {batch_axis_size} -> {rounded}"
                 if rounded != batch_axis_size else ""))
    return create_2d_mesh(n_devices, model_parallel), rounded


# -- the collectives of a split layer -----------------------------------------


def _all_gather_cat(x: torch.Tensor, dim: int, mesh: ProcessMesh
                    ) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order:
    one ``all_gather_into_tensor`` under NCCL (a [size, ...] buffer whose
    leading axis moves next to ``dim``), a list all-gather on gloo."""
    x = x.contiguous()
    if dist.get_backend(mesh.group) != "nccl":
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts, dim=dim)
    buf = x.new_empty((mesh.size,) + x.shape)
    dist.all_gather_into_tensor(buf, x, group=mesh.group)
    dim %= x.ndim
    return buf.movedim(0, dim).reshape(
        x.shape[:dim] + (mesh.size * x.shape[dim],) + x.shape[dim + 1:])


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's columns contribute a part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's block concatenated along ``dim`` (rank order);
    the backward keeps this rank's block of the gradient: every model rank
    computes the same function of the gathered tensor."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.width = dim, mesh, x.shape[dim]
        return _all_gather_cat(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.width
        return (grad.narrow(ctx.dim, ctx.mesh.rank * w, w).contiguous(),
                None, None)


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group; the gradient passes to this rank's
    part unchanged (every rank's loss holds the same sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        x = x.detach().clone()
        dist.all_reduce(x, group=mesh.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gathered(nn.Module):
    """The parametrization of a split leaf that is not a column-parallel
    layer's: the whole tensor, all-gathered where it is used."""

    def __init__(self, dim: int, mesh: ProcessMesh):
        super().__init__()
        self.dim, self.mesh = dim, mesh

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _GatherFromModel.apply(shard, self.dim, self.mesh)


def _column_parallel(module: nn.Module, out_dim: int,
                     mesh: ProcessMesh) -> None:
    """Hooks making ``module`` (its weight and bias already this rank's
    output columns) column-parallel: the input enters through
    ``_CopyToModel``, the output columns leave through
    ``_GatherFromModel``."""
    module.register_forward_pre_hook(
        lambda m, args: (_CopyToModel.apply(args[0], mesh),) + args[1:])
    module.register_forward_hook(
        lambda m, args, out: _GatherFromModel.apply(out, out_dim, mesh))


def _is_column_layer(module: nn.Module) -> bool:
    return isinstance(module, nn.Linear) or (
        isinstance(module, nn.Conv2d) and module.groups == 1)


def shard_module_tp(model: nn.Module, mesh: TPMesh, optimizer=None
                    ) -> List[Tuple[str, int]]:
    """Split ``model``'s parameters over the model group of ``mesh`` by
    :func:`tp_spec_for`, in place: each split parameter keeps its identity
    and holds this rank's contiguous block, and so does every state tensor
    ``optimizer`` already holds for it (Adam's moments after
    ``--model_path``; a fresh optimizer creates them at the shards' shape).
    Run it after ``replicate`` (the whole parameters equal on every rank).
    Linear and Conv2d layers with split weights become column-parallel;
    any other split leaf is all-gathered where it is used.  Returns
    ``tp_sharded_leaves``."""
    tp = mesh.model
    sharded = tp_sharded_leaves(model, tp.size)
    split = dict(sharded)
    gathered = []
    for name, module, leaf, param in list(_direct_params(model)):
        if name not in split:
            continue
        dim = split[name]
        full = param.shape[dim]
        width = full // tp.size
        whole_shape = param.shape

        def block(t, dim=dim, width=width):
            return t.narrow(dim, tp.rank * width, width).clone()

        with torch.no_grad():
            param.data = block(param.data)
        param.tp_shard = TPShard(dim, full, leaf, tp)
        if optimizer is not None:
            state = optimizer.state.get(param, {})
            for key, value in list(state.items()):
                if torch.is_tensor(value) and value.shape == whole_shape:
                    state[key] = block(value)
        if _is_column_layer(module):
            if leaf == "weight":
                _column_parallel(module, -1 if isinstance(
                    module, nn.Linear) else 1, tp)
        else:
            gathered.append((module, leaf, dim))
    for module, leaf, dim in gathered:
        parametrize.register_parametrization(module, leaf,
                                             _Gathered(dim, tp), unsafe=True)
    return sharded


_PARAMETRIZED = re.compile(r"(^|\.)parametrizations\.([^.]+)\.original$")


def plain_name(name: str) -> str:
    """A parameter's name as in the model without tensor parallelism (a
    gathered leaf's shard sits under ``parametrizations.<leaf>.original``)."""
    return _PARAMETRIZED.sub(r"\1\2", name)


def _whole(t: torch.Tensor, shard: TPShard) -> torch.Tensor:
    return _all_gather_cat(t.detach(), shard.dim, shard.mesh)


def gather_state_tp(model: nn.Module, optimizer=None):
    """(model state_dict, optimizer state_dict or None) holding the whole
    parameters and optimizer moments of a model split by
    :func:`shard_module_tp`, named and shaped as without tensor
    parallelism.  A collective over each model group: every rank of the
    group must call it."""
    state = OrderedDict()
    for key, value in model.state_dict(keep_vars=True).items():
        shard = getattr(value, "tp_shard", None)
        state[plain_name(key)] = (value.detach() if shard is None
                                  else _whole(value, shard))
    if optimizer is None:
        return state, None
    opt = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    moments = {}
    for idx, entry in opt["state"].items():
        shard = getattr(params[idx], "tp_shard", None)
        if shard is not None:
            entry = {k: (_whole(v, shard) if torch.is_tensor(v)
                         and v.shape == params[idx].shape and v.ndim else v)
                     for k, v in entry.items()}
        moments[idx] = entry
    opt["state"] = moments
    return state, opt


def sharded_bytes(model: nn.Module, optimizer=None) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the whole) of ``model``'s split
    parameters and ``optimizer``'s state tensors of their shape."""
    held = whole = 0
    for param in model.parameters():
        shard = getattr(param, "tp_shard", None)
        if shard is None:
            continue
        tensors = [param] + ([v for v in optimizer.state.get(
            param, {}).values() if torch.is_tensor(v)
            and v.shape == param.shape] if optimizer is not None else [])
        for t in tensors:
            held += t.numel() * t.element_size()
            whole += t.numel() * t.element_size() * shard.full // \
                t.shape[shard.dim]
    return held, whole


__all__ = ["TPMesh", "TPShard", "tp_spec_for", "tp_sharded_leaves",
           "create_2d_mesh", "auto_mesh_tp", "shard_module_tp", "gather_state_tp", "plain_name",
           "sharded_bytes"]
