"""Loss functions and optimizer construction (counterpart of
mpgcn_tpu/train/objectives.py).

Losses match the reference's torch criteria (Model_Trainer.py:61-70):
MSE -> nn.MSELoss, MAE -> nn.L1Loss, Huber -> nn.SmoothL1Loss (beta 1).
The residual is upcast to float32 before any reduction, whatever dtype
the operands arrive in.

The optimizer is torch's Adam(lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay=decay_rate): torch's L2 ``weight_decay`` adds decay * param
to the gradient before the moment updates, which is optax's
``add_decayed_weights`` placed before ``adam`` in the JAX chain.
"""

from __future__ import annotations

import torch

LOSSES = ("MSE", "MAE", "Huber")


def elementwise_loss(kind: str, pred: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """The per-element loss of ``kind`` on the f32 residual."""
    d = pred.float() - target.float()
    if kind == "MSE":
        return d * d
    if kind == "MAE":
        return d.abs()
    if kind == "Huber":
        a = d.abs()
        return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)
    raise NotImplementedError("Invalid loss function.")


def make_loss_fn(kind: str):
    """``loss(pred, target)``: the mean of ``elementwise_loss``."""
    if kind not in LOSSES:
        raise NotImplementedError("Invalid loss function.")
    return lambda pred, target: elementwise_loss(kind, pred, target).mean()


def make_optimizer(kind: str, params, learn_rate: float,
                   decay_rate: float = 0.0) -> torch.optim.Optimizer:
    if kind != "Adam":
        raise NotImplementedError("Invalid optimizer name.")
    return torch.optim.Adam(params, lr=learn_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=decay_rate)
