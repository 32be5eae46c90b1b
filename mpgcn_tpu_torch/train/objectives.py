"""Loss functions and optimizer construction (counterpart of
mpgcn_tpu/train/objectives.py).

Losses match the reference's torch criteria (Model_Trainer.py:61-70):
MSE -> nn.MSELoss, MAE -> nn.L1Loss, Huber -> nn.SmoothL1Loss (beta 1).
The residual is upcast to float32 before any reduction, whatever dtype
the operands arrive in.

The optimizer is the JAX package's optax chain (objectives.py:47-86):
``clip_by_global_norm(clip_norm)`` when ``clip_norm`` is set, then L2
decay, then Adam(betas=(0.9, 0.999), eps=1e-8) at the scheduled rate.
torch's L2 ``weight_decay`` adds decay * param to the gradient before the
moment updates, which is optax's ``add_decayed_weights`` placed before
``adam``; ``ChainAdam.step`` clips the gradients before that and reads the
step's rate from the schedule, tabulated on the device.
"""

from __future__ import annotations

import math

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


def lr_at(learn_rate: float, lr_schedule: str, total_steps: int):
    """``step -> rate`` of ``lr_schedule`` over ``total_steps`` (at least
    1): optax's ``cosine_decay_schedule(lr, total_steps)`` (alpha 0, the
    step clipped at total_steps) or ``exponential_decay(lr, total_steps,
    0.1)`` (continuous, not clipped)."""
    steps = max(total_steps, 1)
    if lr_schedule == "none":
        return lambda step: learn_rate
    if lr_schedule == "cosine":
        return lambda step: learn_rate * 0.5 * (
            1 + math.cos(math.pi * min(step, steps) / steps))
    if lr_schedule == "exponential":
        return lambda step: learn_rate * 0.1 ** (step / steps)
    raise ValueError(f"invalid lr_schedule: {lr_schedule}")


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: below ``max_norm`` the
    gradients stay as they are; at or above it each becomes
    ``g / norm * max_norm`` (no epsilon; a non-finite norm spreads to
    every gradient, as in optax). Multi-tensor ops: a handful of launches
    whatever the number of gradients, and no host sync. Where the norm
    is below ``max_norm`` the gradients are divided and multiplied by 1,
    which leaves their bits."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0,
                                           torch.full_like(norm, max_norm)))


class ChainAdam(torch.optim.Adam):
    """Adam with L2 ``weight_decay``, after a global-norm gradient clip
    (``clip_norm`` > 0), at the rate ``schedule(i)`` on its i-th step
    (from 0), as optax counts its updates.

    The rate lives on the parameters' device, so a CUDA graph of the step
    replays the schedule: ``lr_table`` holds ``schedule(i)`` in f32 for
    every step the run can take (``total_steps``; grown on the host when
    a step reaches its end), ``step_t`` is the device step counter that
    indexes it, and Adam reads the rate as a tensor. On the card Adam is
    built ``capturable=True`` (its step counts on the device too), on the
    per-step and the captured path alike, so both run the same arithmetic;
    the CPU keeps ``capturable=False``, which torch requires there.
    ``count`` is the host's mirror of ``step_t``: ``step`` advances both,
    ``update`` (the device part, what a graph captures) only ``step_t``,
    and whoever replays ``update`` adds the replays with ``advance``."""

    def __init__(self, params, schedule, decay_rate: float = 0.0,
                 clip_norm: float = 0.0, total_steps: int = 0):
        params = list(params)
        device = params[0].device if params and torch.is_tensor(
            params[0]) else params[0]["params"][0].device
        self.schedule, self.clip_norm, self.count = schedule, clip_norm, 0
        self.lr_table = self._table(max(total_steps, 1), device)
        self.step_t = torch.zeros((1,), dtype=torch.long, device=device)
        self.lr_t = self.lr_table[:1].clone()
        super().__init__(params, lr=self.lr_t, betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=decay_rate,
                         capturable=device.type == "cuda")
        # the per-step path runs capturable Adam uncaptured on purpose
        self._warned_capturable_if_run_uncaptured = True

    def _table(self, n: int, device) -> torch.Tensor:
        return torch.tensor([self.schedule(i) for i in range(n)],
                            dtype=torch.float32).to(device)

    def reserve(self, n: int) -> bool:
        """Make ``lr_table`` cover steps 0..n-1; True when it had to be
        reallocated (a graph that captured the old one must be dropped)."""
        if n <= self.lr_table.shape[0]:
            return False
        self.lr_table = self._table(max(n, 2 * self.lr_table.shape[0]),
                                    self.lr_table.device)
        return True

    @torch.no_grad()
    def update(self):
        """The step on the device: clip, the rate ``lr_table[step_t]``,
        Adam, ``step_t + 1``; no host sync, nothing read back."""
        if self.clip_norm:
            clip_by_global_norm_([p.grad for g in self.param_groups
                                  for p in g["params"]
                                  if p.grad is not None], self.clip_norm)
        torch.index_select(self.lr_table, 0, self.step_t, out=self.lr_t)
        super().step()
        self.step_t += 1

    def advance(self, n: int) -> None:
        """Count ``n`` updates that ran without ``step`` (graph replays)."""
        self.count += n

    def step(self):
        self.reserve(self.count + 1)
        self.update()
        self.count += 1


def make_optimizer(kind: str, params, learn_rate: float,
                   decay_rate: float = 0.0, clip_norm: float = 0.0,
                   lr_schedule: str = "none",
                   total_steps: int = 0) -> ChainAdam:
    """The JAX package's optimizer chain: clip, decay, Adam at
    ``lr_schedule``'s rate over ``total_steps`` optimizer steps."""
    if kind != "Adam":
        raise NotImplementedError("Invalid optimizer name.")
    return ChainAdam(params, lr_at(learn_rate, lr_schedule, total_steps),
                     decay_rate, clip_norm, total_steps)
