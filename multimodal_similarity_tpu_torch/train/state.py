"""Optimizer factory, learning-rate schedule and L2 regularisation.

Hyperparameters are the reference's ``utils.optimize``: Adam with its
unusual epsilon=0.1.  ``torch.optim.Adam`` and optax's adam compute the same
update, m_hat / (sqrt(v_hat) + eps).  The reference's 0.1 gradient
multiplier on pretrained branch scopes is a per-parameter-group gradient
scale applied before the update (Adam with eps=0.1 is not scale-invariant,
so it cannot be folded into the learning rate).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# branch scopes whose gradients are scaled by 0.1
PRETRAINED_BRANCH_SCOPES = ("modality_sensors", "modality_segment",
                            "InceptionV2")


def _in_scope(name: str, scope: str) -> bool:
    prefix = scope.replace("/", ".")
    return name == prefix or name.startswith(prefix + ".")


def build_optimizer(
    optimizer: str,
    model: nn.Module,
    learning_rate: float = 0.05,
    branch_scopes: Sequence[str] = PRETRAINED_BRANCH_SCOPES,
    branch_scale: float = 0.1,
) -> torch.optim.Optimizer:
    """Optimizer keyed by the reference --optimizer flag.  Parameters under
    ``branch_scopes`` form a group whose gradients :func:`apply_gradients`
    scales by ``branch_scale``.  Only ADAM is ported."""
    if optimizer != "ADAM":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (ROADMAP slice 3); "
            "use ADAM")
    plain, branch = [], []
    for name, p in model.named_parameters():
        (branch if any(_in_scope(name, s) for s in branch_scopes)
         else plain).append(p)
    groups = [{"params": plain, "grad_scale": 1.0}]
    if branch:
        groups.append({"params": branch, "grad_scale": branch_scale})
    return torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999),
                            eps=0.1)


def apply_gradients(opt: torch.optim.Optimizer, learning_rate: float) -> None:
    """Scale the branch groups' gradients, set the step's learning rate,
    and step."""
    for group in opt.param_groups:
        group["lr"] = learning_rate
        if group["grad_scale"] != 1.0:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(group["grad_scale"])
    opt.step()


def learning_rate_schedule(epoch: float, learning_rate: float,
                           static_epochs: int, max_epochs: int,
                           decay_base: float = 0.001) -> float:
    """Constant for ``static_epochs``, then decay_base**frac decay."""
    if epoch < static_epochs:
        return learning_rate
    frac = (epoch - static_epochs) / max(max_epochs - static_epochs, 1)
    return learning_rate * decay_base ** frac


def l2_regularization(model: nn.Module) -> torch.Tensor:
    """0.5 * sum(w^2) over weight matrices (the reference's
    ``l2_regularizer(1.0)``).  Biases are exempt, and so are the LSTM's
    weights: the reference regularises only its hand-declared matrices, and
    ``tf.contrib.rnn.LSTMCell`` variables never joined that collection."""
    total = None
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "cell" in parts or parts[-1].startswith("b"):
            continue
        term = 0.5 * (p * p).sum()
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), device=next(model.parameters()).device)
    return total
