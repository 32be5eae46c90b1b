"""Non-finite step sentinels on the device (counterpart of
mpgcn_tpu/resilience/sentinels.py).

A train step whose loss, new weights or new optimizer state is not finite
is skipped inside the step: the state it started from is put back, and
its loss is marked NaN in the epoch's loss stream, which the host counts
against ``cfg.skip_budget`` at the epoch's one read. Nothing is read back
inside the step, so a captured step (train/graphs.py) replays the verdict
and the skip with it.

Contract, as in the JAX package: on a finite step the new state is kept
bit for bit, so a clean run with sentinels on equals one with them off;
a skipped step leaves every guarded tensor as it was, the optimizer's
step counters included, so a skip does not advance the rate schedule.

The JAX package guards with ``lax.cond`` because a leaf-wise ``where``
changes XLA's fusion of the update. Eager PyTorch has no such effect, so
here the selection is a ``torch.where``; ``StepGuard`` judges and selects
on one flat copy per dtype, so a step pays about a dozen launches
whatever the number of tensors (82 at the reference widths: weights,
Adam's moments and steps, the rate and the step counter).
"""

from __future__ import annotations

import torch


def copy_all(dst, src) -> None:
    """``dst[i].copy_(src[i])`` for each i, in one multi-tensor launch
    where torch has it."""
    if hasattr(torch, "_foreach_copy_"):
        torch._foreach_copy_(dst, src)
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


def flat_views(flat, ts) -> list:
    """Views of the 1-D ``flat`` with the shapes of ``ts``, one after the
    other from its start."""
    out, o = [], 0
    for t in ts:
        out.append(flat[o: o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_finite(tensors) -> torch.Tensor:
    """Device bool scalar: every floating tensor is finite (integer ones
    cannot be otherwise). ``isfinite(...).all()`` per tensor, exact where a
    norm would overflow to Inf on finite values above ~1.8e19; two
    launches a tensor, so ``StepGuard`` passes it a few flat buffers, not
    the ~80 tensors of a step."""
    flags = [torch.isfinite(t).all() for t in tensors
             if t.is_floating_point()]
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def skip_if_bad(ok: torch.Tensor, new, old, out=None) -> list:
    """``new`` where ``ok`` else ``old``, tensor by tensor, bit-exact;
    written into ``out`` (which may be ``new``) when given."""
    if out is None:
        return [torch.where(ok, n, o) for n, o in zip(new, old)]
    return [torch.where(ok, n, o, out=r) for n, o, r in zip(new, old, out)]


def mark_loss(ok: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """The loss of a kept step, bit for bit; NaN for a skipped one."""
    return torch.where(ok, loss, float("nan"))


class StepGuard:
    """Keeps ``tensors`` (a fixed list, updated in place by the step) as
    they were before a step and puts them back after it when the step
    went non-finite. Per (device, dtype) group it allocates once a backup
    and a scratch buffer, flat, so their storage never moves (a captured
    step reads and writes them); the scratch of a floating group has one
    more slot, for the step's loss. ``save`` copies the tensors into the
    backup; ``keep_if_finite`` copies them and the loss into the scratch,
    judges the scratch (``isfinite(...).all()``, a handful of launches
    over one buffer), selects scratch or backup into the scratch and
    copies it back."""

    def __init__(self, tensors):
        groups = {}
        for t in tensors:
            groups.setdefault((t.device, t.dtype), []).append(t)
        self._bufs = []
        for (device, dtype), ts in groups.items():
            n = sum(t.numel() for t in ts)
            backup = torch.empty(n, dtype=dtype, device=device)
            scratch = torch.empty(n + dtype.is_floating_point, dtype=dtype,
                                  device=device)
            self._bufs.append((ts, backup, flat_views(backup, ts),
                               scratch, flat_views(scratch, ts)))

    def buffers(self) -> list:
        """The guard's own buffers (where a captured step finds them)."""
        return [b for _, backup, _, scratch, _ in self._bufs
                for b in (backup, scratch)]

    def save(self) -> None:
        for ts, _, backup_v, _, _ in self._bufs:
            copy_all(backup_v, ts)

    def select(self, ok: torch.Tensor) -> None:
        """Keep the tensors as the step left them where ``ok``, else put
        back their saved state (the loss scaler's skip)."""
        for ts, backup, _, scratch, scratch_v in self._bufs:
            copy_all(scratch_v[: len(ts)], ts)
            kept = scratch[: backup.numel()]
            skip_if_bad(ok, [kept], [backup], out=[kept])
            copy_all(ts, scratch_v[: len(ts)])

    def keep_if_finite(self, loss: torch.Tensor,
                       also: torch.Tensor | None = None) -> torch.Tensor:
        """Judge the step and keep or restore the tensors; returns the
        verdict (a device bool scalar). ``also`` (a device bool, the loss
        scaler's finite gradients) must hold too for the step to be kept,
        so one select serves both verdicts; the one returned is still the
        finiteness of the loss and the new state alone."""
        judged, with_loss = [], False
        for ts, _, _, scratch, scratch_v in self._bufs:
            src, dst = ts, scratch_v
            if scratch.is_floating_point():
                if not with_loss and (scratch.device, scratch.dtype) == (
                        loss.device, loss.dtype):
                    src, dst = [*ts, loss.reshape(1)], [*scratch_v,
                                                        scratch[-1:]]
                    with_loss = True
                judged.append(scratch)
            copy_all(dst, src)
        ok = all_finite(judged if with_loss else [*judged, loss])
        keep = ok if also is None else ok & also
        for ts, backup, _, scratch, scratch_v in self._bufs:
            kept = scratch[: backup.numel()]
            skip_if_bad(keep, [kept], [backup], out=[kept])
            copy_all(ts, scratch_v)
        return ok
