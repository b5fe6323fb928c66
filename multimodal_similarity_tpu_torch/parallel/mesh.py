"""The port's mesh: one process per device over ``torch.distributed``.

JAX runs a single controller: one process drives every local device, and a
1-D "data" mesh shards one host batch over them (the JAX package's
``parallel/mesh.py``).  PyTorch's idiom is one process per GPU, so the
port's mesh is the process group itself (ROADMAP deviation D6): a
:class:`ProcessMesh` names the world size, this rank, the group and the
rank's device.  Each rank holds the contiguous rows ``[r m, (r + 1) m)`` of
a global batch of ``n m`` rows, which is how the JAX ``shard_batch`` places
a batch over a 1-D mesh.  On it run the rings and the data-parallel steps
(slice 8c-i), the sharded retrieval index, the sharded device cache and
the flagship's data-parallel step (slice 8c-ii).  Under tensor parallelism
(slice 8c-iii, parallel/tensor_parallel.py) a mesh is the data sub-group of
a data x model mesh: its group is not the default one, so a peer or a
source is named by its rank in the group and addressed through
:func:`global_rank`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class ProcessMesh(NamedTuple):
    """A process group as a 1-D "data" mesh: its size, this process's rank
    in it, the group (the default group, or a sub-group) and the rank's
    device."""

    size: int
    rank: int
    group: Optional[object]
    device: torch.device

    @property
    def shape(self):
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This rank's rows of a global axis of ``n`` (a multiple of the
        world size)."""
        if n % self.size:
            raise ValueError(f"global axis {n} is not a multiple of the "
                             f"{self.size}-process mesh")
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)


def group_device() -> torch.device:
    """The device a collective of the default group runs on: the rank's
    current CUDA device under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def world_size() -> int:
    """Processes in the default group (1 when none is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank(mesh: ProcessMesh, rank: int) -> int:
    """The default group's rank of rank ``rank`` of ``mesh``'s group:
    point-to-point peers and broadcast sources are global ranks."""
    if mesh.group is None or mesh.group == dist.group.WORLD:
        return rank
    return dist.get_global_rank(mesh.group, rank)


def create_mesh(n_devices: Optional[int] = None) -> ProcessMesh:
    """The mesh over the initialised process group; ``n_devices``, when
    given, must be its world size (a rank is a device)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(parallel.multihost.initialize_distributed, or "
                           "torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the process group "
                         f"has {size} (one device a process)")
    return ProcessMesh(size, dist.get_rank(), dist.group.WORLD,
                       group_device())


def auto_mesh(batch_axis_size: int, min_devices: int = 2,
              verbose: bool = True):
    """(mesh | None, rounded_batch_axis_size) for transparent data
    parallelism: the process group's mesh when it holds ``min_devices``
    ranks or more, with the batch axis rounded UP to a multiple of the
    world size (batches are fixed-shape and mask-padded, so rounding up is
    free).  No process group, or a smaller one: (None, unchanged).
    ``verbose=False`` suppresses the rounding notice."""
    n = world_size()
    if n < min_devices:
        return None, batch_axis_size
    rounded = -(-batch_axis_size // n) * n
    if verbose and rounded != batch_axis_size:
        print(f"[parallel] batch axis {batch_axis_size} rounded up to "
              f"{rounded} for {n}-device data parallelism")
    return create_mesh(n), rounded


def map_arrays(fn, tree):
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: ProcessMesh):
    """This rank's rows of every array (tensor or NumPy) in ``batch``:
    the leading axis split in ``mesh.size`` contiguous blocks; scalars and
    0-d arrays pass through.  No trainer of the port calls it (they slice
    ``mesh.rows``); the tests do."""
    def take(x):
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return x[mesh.rows(x.shape[0])]
        return x

    return map_arrays(take, batch)


def replicate(tree, mesh: ProcessMesh):
    """The value of the mesh's rank 0 of every tensor in ``tree`` on every
    rank (an in-place broadcast over the mesh's group); returns ``tree``."""
    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=global_rank(mesh, 0), group=mesh.group)
        return x

    return map_arrays(bcast, tree)
