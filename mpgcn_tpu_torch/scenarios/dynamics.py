"""Stream dynamics, adversarial payloads and spool plumbing (counterpart
of mpgcn_tpu/scenarios/dynamics.py, less the scenario profiles' drifts):
``event_shock`` (one day's demand scaled coherently, which the day gate
must train on), the poisoned day and request behind the
``poison_requests=K`` fault arm (resilience/faults.py), built as the JAX
package builds them, and ``write_od_spool``, which writes a (T, N, N)
stream as the continual-learning daemon's spool day files."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def event_shock(od: np.ndarray, day: int, scale: float = 8.0) -> np.ndarray:
    """Copy of the stream with one day's demand scaled coherently by
    ``scale``: a real-world event, a magnitude outlier with its structure
    intact. The day gate must train on it (kind "event-shock")."""
    out = np.array(od, copy=True)
    out[day] = out[day] * float(scale)
    return out


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


def write_od_spool(od: np.ndarray, spool_dir: str,
                   adjacency: Optional[np.ndarray] = None,
                   start_day: int = 0) -> list[str]:
    """Write a (T, N, N) stream as daemon spool day files
    (``day_<start_day + t>.npy``), and the adjacency beside them when
    given. For provisioning (tests, drills): a live drop into a watched
    spool should be atomic."""
    from mpgcn_tpu_torch.service.ingest import day_filename

    os.makedirs(spool_dir, exist_ok=True)
    paths = []
    for i in range(od.shape[0]):
        p = os.path.join(spool_dir, day_filename(start_day + i))
        np.save(p, od[i])
        paths.append(p)
    if adjacency is not None:
        np.save(os.path.join(spool_dir, "adjacency.npy"), adjacency)
    return paths
