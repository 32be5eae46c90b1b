"""Eval-before-promote checkpoint gating (counterpart of
mpgcn_tpu/service/promote.py).

A retrained candidate never becomes the served model by having finished
training: it must beat, or tie within ``tolerance``, the incumbent on
the held-out split (``PromotionGate``). Promotion is an atomic copy into
the ``promoted/`` slot (tmp + fsync + replace), so the serving plane's
hot reload and a restarted server only ever see a complete incumbent;
every decision is a row of the promotion ledger
(``promoted/promotions.jsonl``), whose ``gate`` rows the reload protocol
orders candidates by (service/reload.py).
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np

from mpgcn_tpu_torch.train import metrics as metrics_mod
from mpgcn_tpu_torch.train.checkpoint import params_integrity
from mpgcn_tpu_torch.utils.atomic import atomic_pickle_dump, atomic_write_bytes
from mpgcn_tpu_torch.utils.convert import read_checkpoint


def promoted_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "promoted")


def promoted_path(output_dir: str, model: str = "MPGCN") -> str:
    """The promoted slot: the one checkpoint serving loads and reloads."""
    return os.path.join(promoted_dir(output_dir), f"{model}_od.pkl")


def ledger_path(output_dir: str) -> str:
    return os.path.join(promoted_dir(output_dir), "promotions.jsonl")


def rejected_path(output_dir: str, attempt: int,
                  model: str = "MPGCN") -> str:
    return os.path.join(output_dir, "rejected",
                        f"{model}_candidate_a{attempt}.pkl")


def candidate_hash(path: str) -> str:
    """blake2b of the file's bytes: the ledger's identity of a
    checkpoint."""
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def evaluate_params(trainer, mode: str = "test") -> dict:
    """Score a ``ModelTrainer``'s current weights on a held-out mode: the
    mean single-step eval loss and the rollout RMSE over ``pred_len``
    steps (as ``ModelTrainer.test`` computes it, without reloading the
    best checkpoint: the caller decides whose weights are loaded)."""
    loss = trainer._validation_loss(mode)
    forecasts, truths = [], []
    for batch in trainer.pipeline.batches(mode, pad_to_full=True):
        pred = trainer.predict(batch.x, batch.keys, trainer.cfg.pred_len)
        forecasts.append(pred[: batch.size])
        truths.append(batch.y[: batch.size])
    _, rmse, _, _ = metrics_mod.evaluate(np.concatenate(forecasts),
                                         np.concatenate(truths))
    return {"loss": float(loss), "rmse": float(rmse)}


class PromotionGate:
    """``decide()`` is the whole promotion policy: a non-finite candidate
    never passes, the first candidate (no usable incumbent) passes on
    finiteness alone, and otherwise the candidate must beat or tie the
    incumbent's held-out loss within ``tolerance`` (relative)."""

    def __init__(self, tolerance: float, enabled: bool = True):
        if tolerance < 0:
            raise ValueError("promote tolerance must be >= 0")
        self.tolerance = float(tolerance)
        self.enabled = enabled

    def decide(self, cand: dict, inc) -> tuple[bool, str]:
        if not self.enabled:
            # a switch for tests that show the gate is load-bearing
            return True, "gate-disabled"
        if cand is None or not math.isfinite(cand.get("loss", math.nan)):
            return False, "candidate-eval-non-finite"
        if inc is None or not math.isfinite(inc.get("loss", math.nan)):
            return True, "no-usable-incumbent"
        if cand["loss"] <= inc["loss"] * (1.0 + self.tolerance):
            return True, "pass"
        return False, (f"eval-regression: candidate loss {cand['loss']:.6g}"
                       f" > incumbent {inc['loss']:.6g} "
                       f"x (1 + {self.tolerance})")


def promote_checkpoint(candidate: str, slot: str) -> str:
    """Install ``candidate`` into the promoted slot atomically: a kill at
    any instant leaves the old incumbent or the complete new one."""
    os.makedirs(os.path.dirname(slot), exist_ok=True)
    with open(candidate, "rb") as f:
        data = f.read()
    return atomic_write_bytes(slot, data)


def poison_checkpoint(path: str) -> None:
    """NaN-poison a checkpoint's params in place and refresh the params
    entries of its integrity record, so the file is well formed but
    numerically poisoned: the eval gate must catch it on merit, not as
    corrupt bytes. A JAX ``opt_state`` (optax classes, which the port
    does not import) is dropped with its record entries; either
    package's loader then reads the file as a params-only
    checkpoint."""
    payload = read_checkpoint(path)
    payload.pop("opt_state", None)
    payload["params"] = _nan_tree(payload["params"])
    record = payload.get("integrity")
    if isinstance(record, dict) and isinstance(record.get("leaves"), dict):
        leaves = {k: v for k, v in record["leaves"].items()
                  if not k.startswith("opt_state")}
        leaves.update(params_integrity(payload["params"]))
        record["leaves"] = leaves
    atomic_pickle_dump(path, payload)


def _nan_tree(tree):
    if isinstance(tree, dict):
        return {k: _nan_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nan_tree(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        return np.full_like(a, np.nan)
    return tree
