"""Adversarial payloads (counterpart of the payload half of
mpgcn_tpu/scenarios/dynamics.py): the poisoned request behind the
``poison_requests=K`` fault arm (resilience/faults.py), built as the JAX
package builds it."""

from __future__ import annotations

from typing import Optional

import numpy as np


def poison_day(arr: np.ndarray, rng: np.random.Generator,
               mode: str = "structure", scale: float = 50.0,
               cells: int = 3) -> np.ndarray:
    """Adversarial (N, N) day crafted from a real one: ``nan`` (one
    non-finite entry), ``negative`` (one negative flow), or
    ``structure`` (finite and non-negative, but ``scale`` x the day's
    mass on ``cells`` random OD pairs)."""
    a = np.asarray(arr, dtype=np.float64)
    out = np.array(a, copy=True)
    N = out.shape[0]
    if mode == "nan":
        out.flat[rng.integers(0, out.size)] = np.nan
        return out
    if mode == "negative":
        out.flat[rng.integers(0, out.size)] = -1.0
        return out
    if mode != "structure":
        raise ValueError(f"unknown poison mode {mode!r}")
    total = max(float(a.sum()), 1.0) * float(scale)
    out = np.zeros_like(out)
    picks = rng.choice(N * N, size=min(int(cells), N * N), replace=False)
    out.flat[picks] = total / len(picks)
    return out


def poison_request(x: np.ndarray, rng: Optional[np.random.Generator] = None,
                   mode: str = "nan", scale: float = 50.0) -> np.ndarray:
    """Adversarial request window (obs_len, N, N[, 1]). ``mode="nan"``
    (the fault's own arm) must be shed at the serve request gate;
    ``structure`` passes that gate by construction."""
    rng = rng or np.random.default_rng(0)
    a = np.array(np.asarray(x), copy=True)
    flows = a[..., 0] if a.ndim == 4 else a
    if mode == "nan":
        flows[..., 0, 0] = np.nan
        return a
    flows[-1] = poison_day(flows[-1], rng, mode=mode, scale=scale)
    return a
