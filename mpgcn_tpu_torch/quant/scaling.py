"""Dynamic loss scaling for bf16 training with f32 master weights
(counterpart of mpgcn_tpu/quant/scaling.py).

The scaler's three scalars (``scale``, ``good_steps``, ``skipped``) live on
the device and nothing of them is read back inside a step, so the scaler
runs inside the captured train step (train/graphs.py) as it runs eagerly.
Every choice is a ``torch.where``, never a host branch. Protocol, as the
JAX package's:

  * the trainer multiplies the loss by ``scale`` before ``backward``
    (``scale_loss``: the cotangents start from the scale, which keeps
    small bf16 gradient intermediates from flushing to zero);
  * the optimizer (train/objectives.py ``ChainAdam.update``) unscales the
    gradients before the clip (``unscale_``); then
      - finite gradients: the update runs; after ``growth_interval``
        consecutive clean steps the scale doubles (capped at
        ``MAX_SCALE``);
      - non-finite gradients: the step is skipped -- the weights and
        Adam's state (moments, steps, rate, step counter) are put back as
        they were -- and the scale halves (floored at ``min_scale``).

The scaler owns scale-induced overflow (finite loss, non-finite scaled
gradients), which does not count against ``cfg.skip_budget``; the step
sentinels keep owning non-finite losses and weights
(resilience/sentinels.py). Scales are powers of two, so scaling and
unscaling are exact in f32 absent overflow: a clean run with the scaler
on equals one with it off bit for bit.
"""

from __future__ import annotations

import torch

from mpgcn_tpu_torch.resilience.sentinels import (
    all_finite,
    copy_all,
    flat_views,
)

#: the scale's growth and backoff factor and its cap (the JAX defaults)
FACTOR = 2.0
MAX_SCALE = 2.0 ** 32


class DynamicLossScaler:
    """The scaler's state on the device of ``params`` (the weights whose
    gradients it unscales): f32 ``scale``, int32 ``good_steps`` and
    ``skipped``, 0-d tensors whose storage never moves, and its update.
    ``save`` / ``select`` keep the three as they were before a step and
    put them back where a sentinel undid the step. The gradients are
    judged and unscaled on one flat scratch buffer per (device, dtype) of
    the weights, allocated here, so a step pays a handful of launches for
    it whatever the number of gradients."""

    def __init__(self, params, init_scale: float = 65536.0,
                 growth_interval: int = 200, min_scale: float = 1.0):
        if init_scale <= 0:
            raise ValueError(f"init_scale must be > 0, got {init_scale}")
        if growth_interval < 1:
            raise ValueError(
                f"growth_interval must be >= 1, got {growth_interval}")
        if not min_scale <= init_scale <= MAX_SCALE:
            raise ValueError(
                f"init_scale {init_scale} must lie in [min_scale "
                f"{min_scale}, {MAX_SCALE}]")
        self.init_scale, self.growth_interval = init_scale, growth_interval
        self.min_scale = min_scale
        params = list(params)
        device = params[0].device
        sizes = {}
        for p in params:
            key = (p.device, p.dtype)
            sizes[key] = sizes.get(key, 0) + p.numel()
        self._flat = {(d, t): torch.empty(n, dtype=t, device=d)
                      for (d, t), n in sizes.items()}
        self.scale = torch.full((), init_scale, dtype=torch.float32,
                                device=device)
        self.good_steps = torch.zeros((), dtype=torch.int32, device=device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=device)
        self._backup = [torch.empty_like(t) for t in self.tensors()]

    def tensors(self) -> list:
        return [self.scale, self.good_steps, self.skipped]

    def buffers(self) -> list:
        """Every tensor a captured step reads or writes."""
        return [*self.tensors(), *self._backup, *self._flat.values()]

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """loss x scale, read as a tensor (no host read)."""
        return loss * self.scale.to(loss.dtype)

    @torch.no_grad()
    def unscale_(self, grads) -> torch.Tensor:
        """Divide ``grads`` (of some of the weights) by the scale in place,
        all zeroed where any is not finite (so the update computes on clean
        numbers; its result is then discarded). Returns the device bool:
        all were finite. The gradients are copied into the flat scratch,
        judged, unscaled and copied back: a few launches a (device, dtype)
        group."""
        groups = {}
        for g in grads:
            groups.setdefault((g.device, g.dtype), []).append(g)
        flats = []
        for key, gs in groups.items():
            flat = self._flat[key][: sum(g.numel() for g in gs)]
            views = flat_views(flat, gs)
            copy_all(views, gs)
            flats.append((flat, views, gs))
        finite = all_finite([flat for flat, _, _ in flats])
        for flat, views, gs in flats:
            torch.where(finite, flat / self.scale.to(flat.dtype),
                        torch.zeros((), dtype=flat.dtype,
                                    device=flat.device), out=flat)
            copy_all(gs, views)
        return finite

    @torch.no_grad()
    def advance(self, finite: torch.Tensor) -> None:
        """The state after a step whose gradients were ``finite`` (or not):
        the streak and growth, or the halving and the skip count."""
        good = torch.where(finite, self.good_steps + 1,
                           torch.zeros_like(self.good_steps))
        grow = good >= self.growth_interval
        grown = torch.clamp(self.scale * FACTOR, max=MAX_SCALE)
        halved = torch.clamp(self.scale / FACTOR, min=self.min_scale)
        self.scale.copy_(torch.where(finite,
                                     torch.where(grow, grown, self.scale),
                                     halved))
        self.good_steps.copy_(torch.where(grow, torch.zeros_like(good),
                                          good))
        self.skipped.add_((~finite).to(torch.int32))

    @torch.no_grad()
    def save(self) -> None:
        for b, t in zip(self._backup, self.tensors()):
            b.copy_(t)

    @torch.no_grad()
    def select(self, keep_new: torch.Tensor) -> None:
        """Keep the new state where ``keep_new``, else the saved one."""
        for b, t in zip(self._backup, self.tensors()):
            t.copy_(torch.where(keep_new, t, b))

    def saved_scale(self) -> torch.Tensor:
        """The scale before the step (after ``save``)."""
        return self._backup[0]

    @torch.no_grad()
    def reset(self) -> None:
        """The initial state (a fresh optimizer), in place."""
        self.load({"scale": self.init_scale, "good_steps": 0,
                   "skipped": 0})

    @torch.no_grad()
    def load(self, state: dict) -> None:
        """Set the three from host values, in place."""
        self.scale.fill_(float(state["scale"]))
        self.good_steps.fill_(int(state["good_steps"]))
        self.skipped.fill_(int(state["skipped"]))

    def stats(self) -> dict:
        """Host copies {scale, good_steps, skipped_steps} (one read; the
        trainer reads it once an epoch)."""
        vals = torch.stack([self.scale.double(), self.good_steps.double(),
                            self.skipped.double()]).cpu().tolist()
        return {"scale": vals[0], "good_steps": int(vals[1]),
                "skipped_steps": int(vals[2])}
