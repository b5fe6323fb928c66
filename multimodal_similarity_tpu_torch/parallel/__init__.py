"""Parallelism on ``torch.distributed``: the process mesh, the
multi-process bootstrap and feeding, the batch-hard and lifted rings and
the data-parallel triplet step (ROADMAP slice 8c-i), sharded-gallery
retrieval (slice 8c-ii; the mesh-sharded device cache and the flagship's
data-parallel step live beside their single-device versions), tensor
parallelism over a data x model mesh (slice 8c-iii), and the pipelined
feature-extraction backbone (slice 9)."""

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
from multimodal_similarity_tpu_torch.parallel.pipeline import (
    INCEPTION_RESNET_V2_UNIT_COSTS,
    PipelinedBackbone,
    profile_unit_costs,
    split_units_balanced,
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
from multimodal_similarity_tpu_torch.parallel.sharded_eval import (
    sharded_retrieval_topk,
    sharded_retrieval_topk_quantized,
)
from multimodal_similarity_tpu_torch.parallel.tensor_parallel import (
    TPMesh,
    auto_mesh_tp,
    create_2d_mesh,
    gather_state_tp,
    shard_module_tp,
    tp_sharded_leaves,
    tp_spec_for,
)

__all__ = [
    "ProcessMesh",
    "auto_mesh",
    "create_mesh",
    "shard_batch",
    "replicate",
    "make_dp_triplet_step",
    "sharded_retrieval_topk",
    "sharded_retrieval_topk_quantized",
    "ring_batch_hard_stats",
    "make_ring_batch_hard_stats_grad",
    "make_ring_batch_hard_loss",
    "make_ring_lifted_stats_grad",
    "make_ring_lifted_loss",
    "initialize_distributed",
    "make_global_batch",
    "put_global",
    "host_local_sessions",
    "PipelinedBackbone",
    "split_units_balanced",
    "profile_unit_costs",
    "INCEPTION_RESNET_V2_UNIT_COSTS",
    "TPMesh",
    "create_2d_mesh",
    "auto_mesh_tp",
    "tp_spec_for",
    "tp_sharded_leaves",
    "shard_module_tp",
    "gather_state_tp",
]
