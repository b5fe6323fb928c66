"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Counterpart of the JAX package's ``ops/pallas``."""

from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
    LAUNCHES,
    batch_hard_fused,
    fused_batch_hard_stats,
    winning_pair_grad,
)


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


__all__ = ["LAUNCHES", "batch_hard_fused", "fused_batch_hard_stats",
           "reset_launch_counts", "winning_pair_grad"]
