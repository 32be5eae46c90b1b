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
step's rate from the schedule, tabulated on the device. With
``sentinels`` a step that goes non-finite is undone inside the step
(resilience/sentinels.py). With a ``scaler`` (bf16 training, quant/
scaling.py) the gradients arrive scaled: the update unscales them before
the clip and skips itself where they are not finite, as the JAX package's
outermost ``dynamic_loss_scaling`` transform does.
"""

from __future__ import annotations

import math

import torch

from mpgcn_tpu_torch.quant.scaling import DynamicLossScaler
from mpgcn_tpu_torch.resilience.sentinels import StepGuard, mark_loss

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
    and whoever replays ``update`` adds the replays with ``advance``.

    Adam's state (moments and step) is made here, not at the first step,
    so its storage never moves. With ``sentinels`` a ``StepGuard`` keeps
    the weights, Adam's state, ``lr_t`` and ``step_t`` from before each
    update and puts them back where the update (or the loss) went
    non-finite: a skipped step does not advance ``step_t``, so ``count``
    may then run ahead of it; ``step_t`` is the truth. ``chain`` names the
    optax chain these settings stand for (``chain_signature``).

    With a ``scaler`` (``DynamicLossScaler``) the guard keeps the same
    state around every update, and a step whose (scaled) gradients are not
    finite puts it all back and halves the scale: a scaler skip, which
    does not mark the loss. Composed with the sentinels as in the JAX
    trainer's ``_train_step_fn``: a sentinel reject with finite gradients
    also keeps the scaler's state from before the step (its streak does
    not advance), a scaler skip keeps its halved scale, and a scaler skip
    at a scale already at ``min_scale`` counts as a sentinel skip. Both
    verdicts go into one select of the guarded state."""

    def __init__(self, params, schedule, decay_rate: float = 0.0,
                 clip_norm: float = 0.0, total_steps: int = 0,
                 sentinels: bool = False, chain: tuple = (),
                 scaler: DynamicLossScaler | None = None):
        params = list(params)
        device = params[0].device if params and torch.is_tensor(
            params[0]) else params[0]["params"][0].device
        self.schedule, self.clip_norm, self.count = schedule, clip_norm, 0
        self.chain = chain
        self.lr_table = self._table(max(total_steps, 1), device)
        self.step_t = torch.zeros((1,), dtype=torch.long, device=device)
        self.lr_t = self.lr_table[:1].clone()
        super().__init__(params, lr=self.lr_t, betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=decay_rate,
                         capturable=device.type == "cuda")
        # the per-step path runs capturable Adam uncaptured on purpose
        self._warned_capturable_if_run_uncaptured = True
        self._init_state()
        self.sentinels, self.scaler = sentinels, scaler
        self.guard = (StepGuard(self.guarded())
                      if sentinels or scaler is not None else None)

    def _init_state(self) -> None:
        """Adam's lazy state, made now (as ``Adam._init_group`` makes it)."""
        dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
                 else torch.float32)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if st:
                    continue
                st["step"] = (torch.zeros((), dtype=dtype, device=p.device)
                              if group["capturable"]
                              else torch.tensor(0.0, dtype=dtype))
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    def all_params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def guarded(self) -> list:
        """What an update writes: the weights, Adam's state, the rate and
        the step counter."""
        state = [self.state[p][k] for p in self.all_params()
                 for k in ("exp_avg", "exp_avg_sq", "step")]
        return [*self.all_params(), *state, self.lr_t, self.step_t]

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
    def update(self, loss=None):
        """The step on the device: unscale (with a scaler), clip, the rate
        ``lr_table[step_t]``, Adam, ``step_t + 1``; no host sync, nothing
        read back. Returns ``loss``, under sentinels marked NaN where the
        step was undone."""
        if self.guard is not None:
            self.guard.save()
        grads = [p.grad for p in self.all_params() if p.grad is not None]
        scaler, finite = self.scaler, None
        if scaler is not None:
            scaler.save()
            finite = scaler.unscale_(grads)
        if self.clip_norm:
            clip_by_global_norm_(grads, self.clip_norm)
        torch.index_select(self.lr_table, 0, self.step_t, out=self.lr_t)
        super().step()
        self.step_t += 1
        judged = self.sentinels and loss is not None
        if judged:
            # one select for both: the sentinel's verdict and the scaler's
            # (a scaler skip leaves it all; its update ran on zeroed
            # gradients, so the sentinel judges finite numbers there)
            ok = self.guard.keep_if_finite(loss, finite)
        elif scaler is not None:
            self.guard.select(finite)
        if scaler is not None:
            scaler.advance(finite)
        if not judged:
            return loss
        if scaler is not None:
            # the sentinel undid the step: the scaler's state goes back
            # too, unless the scaler itself skipped (its halving stands)
            scaler.select(ok | ~finite)
            # a scaler skip at the floor scale is no scale overflow
            ok = ok & ~(~finite & (scaler.saved_scale() <= scaler.min_scale))
        return mark_loss(ok, loss)

    def advance(self, n: int) -> None:
        """Count ``n`` updates that ran without ``step`` (graph replays)."""
        self.count += n

    def step(self, loss=None):
        self.reserve(self.count + 1)
        loss = self.update(loss)
        self.count += 1
        return loss

    @torch.no_grad()
    def set_count(self, n: int) -> None:
        """Set the update count (resume): ``step_t``, Adam's steps, the
        host mirror and ``lr_t``, in place."""
        self.reserve(n + 1)
        self.count = n
        self.step_t.fill_(n)
        for p in self.all_params():
            self.state[p]["step"].fill_(n)
        # the rate of the last update, as n updates leave it
        self.lr_t.copy_(self.lr_table[max(n - 1, 0): max(n, 1)])

    @torch.no_grad()
    def reset(self) -> None:
        """A fresh optimizer state (reseed, or a checkpoint without one),
        in place."""
        for p in self.all_params():
            self.state[p]["exp_avg"].zero_()
            self.state[p]["exp_avg_sq"].zero_()
        self.set_count(0)
        if self.scaler is not None:
            self.scaler.reset()

    @torch.no_grad()
    def set_schedule(self, schedule) -> None:
        """Rate backoff (rollback): tabulate ``schedule`` into ``lr_table``
        in place; the next update reads it."""
        self.schedule = schedule
        self.lr_table.copy_(self._table(self.lr_table.shape[0],
                                        self.lr_table.device))


def chain_signature(clip_norm: float, decay_rate: float,
                    lr_schedule: str) -> tuple:
    """The class names of the optax state the JAX package's optimizer chain
    holds for these settings (mpgcn_tpu/train/objectives.py
    ``make_optimizer``): the clip and the decay hold ``EmptyState``, Adam
    ``(ScaleByAdamState, EmptyState | ScaleByScheduleState)``; one
    transform is not wrapped in a chain."""
    adam = ("ScaleByAdamState",
            "EmptyState" if lr_schedule == "none" else "ScaleByScheduleState")
    txs = (["EmptyState"] if clip_norm else []) \
        + (["EmptyState"] if decay_rate else []) + [adam]
    return tuple(txs) if len(txs) > 1 else adam


def make_optimizer(kind: str, params, learn_rate: float,
                   decay_rate: float = 0.0, clip_norm: float = 0.0,
                   lr_schedule: str = "none",
                   total_steps: int = 0,
                   sentinels: bool = False, loss_scaling: bool = False,
                   loss_scale_init: float = 65536.0,
                   loss_scale_growth_interval: int = 200,
                   loss_scale_min: float = 1.0) -> ChainAdam:
    """The JAX package's optimizer chain: clip, decay, Adam at
    ``lr_schedule``'s rate over ``total_steps`` optimizer steps; with
    ``sentinels``, each step guarded; with ``loss_scaling``, the dynamic
    loss scaler outermost (quant/scaling.py)."""
    if kind != "Adam":
        raise NotImplementedError("Invalid optimizer name.")
    params = list(params)
    scaler = None
    if loss_scaling:
        scaler = DynamicLossScaler(
            params, init_scale=loss_scale_init,
            growth_interval=loss_scale_growth_interval,
            min_scale=loss_scale_min)
    return ChainAdam(params, lr_at(learn_rate, lr_schedule, total_steps),
                     decay_rate, clip_norm, total_steps, sentinels,
                     chain_signature(clip_norm, decay_rate, lr_schedule),
                     scaler)
