"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Counterpart of the JAX package's ``ops/pallas``."""

from multimodal_similarity_tpu_torch.ops.kernels._build import LAUNCHES
from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    batch_hard_fused,
    fused_batch_hard_stats,
    winning_pair_grad,
)
from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
    fused_lifted_stats,
    lifted_loss_fused,
)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, of every kernel module, to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


__all__ = ["LAUNCHES", "batch_hard_fused", "fused_batch_hard_stats",
           "fused_lifted_stats", "lifted_loss_fused", "reset_launch_counts",
           "winning_pair_grad"]
