"""Multi-process bootstrap and input feeding.

``initialize_distributed`` starts the ``torch.distributed`` process group:
from explicit coordinator settings (``--multihost --coordinator_address
--num_processes --process_id``) or from ``torchrun``'s environment.  Each
process's loader produces its local slice of the global batch; no feature
bytes cross processes (the JAX package's ``parallel/multihost.py``).  With
one process everything reduces to the local arrays, so the same trainer
code runs everywhere.

The backend follows the device: NCCL for ``cuda``, gloo for the CPU.  A
failed initialisation raises: there is no fallback to another backend or
to independent single-process runs.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from multimodal_similarity_tpu_torch.parallel.mesh import (
    ProcessMesh, map_arrays, world_size)


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def env_world_size() -> int:
    """``WORLD_SIZE`` of a ``torchrun`` launch (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _bind_local_device(backend: str, rank: int) -> None:
    """Under NCCL each rank drives its own card: ``LOCAL_RANK`` (torchrun)
    or the rank modulo the visible cards."""
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Start the default process group (no-op when one is running).

    Explicit form: ``coordinator_address`` (``host:port``, or any
    ``init_method`` URL such as ``file://...``) with ``num_processes`` and
    ``process_id``; a failure raises, so a misconfigured run dies loudly
    instead of degrading into N independent trainings.  A partial explicit
    config raises ``ValueError``.  Zero-argument form: ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a no-op when no such environment is set."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator_address needs --num_processes and "
                "--process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        _bind_local_device(backend, process_id)
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
        return
    if num_processes is not None or process_id is not None:
        # partial explicit config: without the coordinator every process
        # would train independently under the same experiment name
        raise ValueError(
            "--num_processes/--process_id were given without "
            "--coordinator_address; pass all three (or none, under "
            "torchrun)")
    if "WORLD_SIZE" not in os.environ:
        return
    _bind_local_device(backend, int(os.environ.get("RANK", "0")))
    dist.init_process_group(backend, init_method="env://")


class GlobalRows(NamedTuple):
    """One process's rows of a global array: ``local`` holds rows
    ``[offset, offset + len(local))`` of a global axis of
    ``global_rows``.  The port's mesh has no global-array type, so this
    metadata is all of it.  The sharded top-k
    (parallel/sharded_eval.py) takes one as a gallery whose size it
    checks; no trainer of the port reads it (the data-parallel step
    gathers what it needs itself)."""

    local: Any
    offset: int
    global_rows: int


def put_global(mesh: Optional[ProcessMesh], x) -> GlobalRows:
    """ONE process-local array as its rows of the global array: every
    process holds the same number of rows, in rank order.  The rows stay
    where they are; only the metadata says which global rows they are.
    Only the tests call it (see :class:`GlobalRows`)."""
    m = x.shape[0]
    if mesh is None:
        return GlobalRows(x, 0, m)
    return GlobalRows(x, mesh.rank * m, m * mesh.size)


def make_global_batch(mesh: Optional[ProcessMesh], local_batch: Any) -> Any:
    """Per-process local arrays -> :class:`GlobalRows` (global batch size =
    local rows x process count, rank-ordered).  Only the tests call it
    (see :class:`GlobalRows`)."""
    return map_arrays(lambda x: put_global(mesh, x), local_batch)


def host_local_sessions(sessions, process_id=None, process_count=None):
    """Partition a session list across processes (each loads only its
    shard of the sessions): session i goes to process i % count."""
    pid = (dist.get_rank() if dist.is_initialized() else 0) \
        if process_id is None else process_id
    pcount = world_size() if process_count is None else process_count
    return [s for i, s in enumerate(sessions) if i % pcount == pid]
