"""Bounded rollback: the signal and the file names (counterpart of
mpgcn_tpu/resilience/rollback.py).

When an epoch goes bad (a non-finite epoch loss, or more sentinel-skipped
steps than ``cfg.skip_budget``), the trainer quarantines the state to a
postmortem checkpoint, restores the last good checkpoint, and either
re-enters training at ``learn_rate * cfg.rollback_lr_factor`` by raising
``RollbackSignal`` (at most ``cfg.rollback_retries`` times) or stops
(``ModelTrainer._bad_epoch`` and ``train``). The names match the JAX
package's, so its tools find a port run's files.
"""

from __future__ import annotations

import os


class RollbackSignal(Exception):
    """Raised by the bad-epoch handler to unwind the epoch loop and
    re-enter training from the restored checkpoint; ``train`` catches it."""

    def __init__(self, epoch: int, reason: str, attempt: int):
        super().__init__(
            f"rollback after bad epoch {epoch} ({reason}), "
            f"retry attempt {attempt}")
        self.epoch = epoch
        self.reason = reason
        self.attempt = attempt


def postmortem_path(output_dir: str, model: str, epoch: int) -> str:
    """Where the state of a bad epoch is quarantined (one file per epoch:
    a retry that fails at the same epoch overwrites it)."""
    return os.path.join(output_dir, f"{model}_od_postmortem_e{epoch}.pkl")


def emergency_path(output_dir: str, model: str) -> str:
    """Where the hang watchdog writes the last host copy of the state."""
    return os.path.join(output_dir, f"{model}_od_emergency.pkl")
