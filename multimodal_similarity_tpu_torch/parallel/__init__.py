"""Data parallelism on ``torch.distributed``: the process mesh, the
multi-process bootstrap and feeding, the batch-hard and lifted rings and
the data-parallel triplet step (ROADMAP slice 8c-i).  Sharded evaluation,
tensor parallelism and the pipelined backbone are slice 8c-ii."""

from multimodal_similarity_tpu_torch.parallel.data_parallel import (
    make_dp_triplet_step,
)
from multimodal_similarity_tpu_torch.parallel.mesh import (
    ProcessMesh,
    auto_mesh,
    create_mesh,
    replicate,
    shard_batch,
)
from multimodal_similarity_tpu_torch.parallel.multihost import (
    host_local_sessions,
    initialize_distributed,
    make_global_batch,
    put_global,
)
from multimodal_similarity_tpu_torch.parallel.ring_lifted import (
    make_ring_lifted_loss,
    make_ring_lifted_stats_grad,
)
from multimodal_similarity_tpu_torch.parallel.ring_mining import (
    make_ring_batch_hard_loss,
    make_ring_batch_hard_stats_grad,
    ring_batch_hard_stats,
)

__all__ = [
    "ProcessMesh",
    "auto_mesh",
    "create_mesh",
    "shard_batch",
    "replicate",
    "make_dp_triplet_step",
    "ring_batch_hard_stats",
    "make_ring_batch_hard_stats_grad",
    "make_ring_batch_hard_loss",
    "make_ring_lifted_stats_grad",
    "make_ring_lifted_loss",
    "initialize_distributed",
    "make_global_batch",
    "put_global",
    "host_local_sessions",
]
