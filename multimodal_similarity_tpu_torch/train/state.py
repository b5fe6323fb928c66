"""Optimizer factory, learning-rate schedule and L2 regularisation.

Hyperparameters are the reference's ``utils.optimize``, as the JAX
package's optax chain holds them: Adam with epsilon=0.1, RMSProp with
decay 0.9 / momentum 0.9 / epsilon 1.0 and its mean square starting at
1.0, Nesterov momentum 0.9, Adadelta rho 0.9 / eps 1e-6, Adagrad with its
accumulator starting at 0.1.  ``torch.optim`` computes the same update for
ADAM, ADADELTA, MOMENTUM and SGD; RMSPROP and ADAGRAD are written out
below, since torch's differ (eps outside the root, accumulators from 0,
the learning rate applied after the momentum).  The reference's 0.1 gradient
multiplier on pretrained branch scopes, and ``frozen_scopes`` (a multiplier
of 0), scale the gradients of a parameter group before the update, as the
first links of the optax chain do (no update here is scale-invariant, so
they cannot be folded into the learning rate).
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


class RMSProp(torch.optim.Optimizer):
    """optax ``rmsprop(lr, decay, eps, momentum, initial_scale)``:
    nu = decay nu + (1 - decay) g^2 from ``initial_scale``, u = -lr g
    rsqrt(nu + eps), then the momentum trace m = u + momentum m (the
    learning rate enters before the momentum, as in optax's chain)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1.0, momentum: float = 0.9,
                 initial_scale: float = 1.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum,
                                      initial_scale=initial_scale))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                    st["trace"] = torch.zeros_like(p)
                g = p.grad
                st["nu"].mul_(group["decay"]).add_(
                    (1.0 - group["decay"]) * (g * g))
                u = -group["lr"] * (g * torch.rsqrt(st["nu"] + group["eps"]))
                st["trace"].mul_(group["momentum"]).add_(u)
                p.add_(st["trace"])


class Adagrad(torch.optim.Optimizer):
    """optax ``adagrad(lr)``: acc = acc + g^2 from
    ``initial_accumulator_value``, update -lr g rsqrt(acc + eps) (0 where
    acc is 0)."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = st["sum_of_squares"]
                acc.add_(p.grad * p.grad)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                  torch.zeros_like(acc))
                p.add_(-group["lr"] * (inv * p.grad))


def build_optimizer(
    optimizer: str,
    model: nn.Module,
    learning_rate: float = 0.05,
    branch_scopes: Sequence[str] = PRETRAINED_BRANCH_SCOPES,
    branch_scale: float = 0.1,
    frozen_scopes: Sequence[str] = (),
) -> torch.optim.Optimizer:
    """Optimizer keyed by the reference --optimizer flag (ADAM, ADAGRAD,
    ADADELTA, RMSPROP, MOMENTUM; anything else is plain SGD, as in the JAX
    package).  Parameters are grouped by the gradient scale
    :func:`apply_gradients` applies: ``branch_scale`` under
    ``branch_scopes``, 0 under ``frozen_scopes`` ('/'-joined prefixes)."""
    scales = {}
    for name, p in model.named_parameters():
        scale = 1.0
        if any(_in_scope(name, s) for s in branch_scopes):
            scale *= branch_scale
        if any(_in_scope(name, s) for s in frozen_scopes):
            scale *= 0.0
        scales.setdefault(scale, []).append(p)
    groups = [{"params": ps, "grad_scale": scale}
              for scale, ps in sorted(scales.items(), reverse=True)]
    if optimizer == "ADAM":
        return torch.optim.Adam(groups, lr=learning_rate,
                                betas=(0.9, 0.999), eps=0.1)
    if optimizer == "ADAGRAD":
        return Adagrad(groups, lr=learning_rate)
    if optimizer == "ADADELTA":
        return torch.optim.Adadelta(groups, lr=learning_rate, rho=0.9,
                                    eps=1e-6)
    if optimizer == "RMSPROP":
        return RMSProp(groups, lr=learning_rate)
    if optimizer == "MOMENTUM":
        return torch.optim.SGD(groups, lr=learning_rate, momentum=0.9,
                               nesterov=True)
    return torch.optim.SGD(groups, lr=learning_rate)


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
    ``tf.contrib.rnn.LSTMCell`` variables never joined that collection.  A
    tensor-parallel shard (parallel/tensor_parallel.py) adds its term summed
    over its model group: the whole matrix's."""
    total = None
    for name, p in model.named_parameters():
        parts = name.split(".")
        shard = getattr(p, "tp_shard", None)
        leaf = parts[-1] if shard is None else shard.leaf
        if "cell" in parts or leaf.startswith("b"):
            continue
        term = 0.5 * (p * p).sum()
        if shard is not None:
            term = shard.whole_sum(term)
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), device=next(model.parameters()).device)
    return total
