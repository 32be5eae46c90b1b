"""Stream dynamics, adversarial payloads and spool plumbing (counterpart
of mpgcn_tpu/scenarios/dynamics.py): transforms that bend a scenario
profile's stationary stream (scenarios/profiles.py) mid-flight --
``regime_shift_od`` (the weekly signature morphs to another modality's at
a shift day, abrupt or ramped; totals stay in range, so the day gate keeps
accepting and the change must surface as eval drift), ``modality_mix_od``
(the mode share slides across the whole stream) and ``event_shock`` (one
day's demand scaled coherently, which the day gate must train on) -- the
poisoned day and request behind the ``poison_requests=K`` fault arm
(resilience/faults.py), built as the JAX package builds them, and
``write_od_spool``, which writes a (T, N, N) stream as the
continual-learning daemon's spool day files. numpy only."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mpgcn_tpu_torch.scenarios.profiles import (
    _MODAL_DOW_SHAPE,
    MODALITIES,
    ScenarioProfile,
    scenario_od,
)


def signature_multipliers(modality: str, T: int,
                          peak_sharpness: float = 1.5) -> np.ndarray:
    """(T,) deterministic weekly multipliers of a modality: its
    day-of-week shape at the amplitude (bisection, as in
    profiles._daily_multiplier) whose p95/p25 over the repeated series
    is ``peak_sharpness``. No noise, no trend: the pure signature that
    re-weights an already-drawn stream."""
    if modality not in MODALITIES:
        raise ValueError(f"modality={modality!r} is not one of "
                         f"{MODALITIES}")
    shape = np.asarray(_MODAL_DOW_SHAPE[modality])
    tiled = shape[np.arange(max(T, 70)) % 7]

    def sharpness(a: float) -> float:
        m = 1.0 + a * tiled
        return float(np.percentile(m, 95) / np.percentile(m, 25))

    lo, hi = 0.0, 64.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if sharpness(mid) < peak_sharpness:
            lo = mid
        else:
            hi = mid
    a = (lo + hi) / 2
    return 1.0 + a * shape[np.arange(T) % 7]


def shift_weights(T: int, shift_day: int, ramp_days: int = 0) -> np.ndarray:
    """(T,) weight of the target regime per day: 0 before ``shift_day``,
    1 after the ramp, linear across ``ramp_days`` (0: overnight)."""
    w = np.zeros(T)
    if ramp_days <= 0:
        w[shift_day:] = 1.0
        return w
    ramp = (np.arange(T) - shift_day + 1) / float(ramp_days)
    return np.clip(ramp, 0.0, 1.0)


def regime_shift_od(profile: ScenarioProfile, days: Optional[int] = None,
                    shift_day: Optional[int] = None,
                    to_modality: str = "metro",
                    ramp_days: int = 0) -> np.ndarray:
    """(T, N, N) stream whose weekly signature morphs from the profile's
    modality to ``to_modality`` at ``shift_day`` (default: mid-stream).
    Before the shift it is the profile's own draw (``scenario_od``, bit
    for bit); after it each day is re-weighted by the target / source
    signature ratio, so totals stay in the historical range while the
    day-of-week -> magnitude mapping the incumbent learned is gone."""
    T = days or profile.days
    shift = T // 2 if shift_day is None else int(shift_day)
    od = scenario_od(profile, days=T)
    m_src = signature_multipliers(profile.modality, T,
                                  profile.peak_sharpness)
    m_dst = signature_multipliers(to_modality, T, profile.peak_sharpness)
    w = shift_weights(T, shift, ramp_days)
    factor = (1.0 - w) + w * (m_dst / m_src)
    return od * factor[:, None, None]


def modality_mix_od(profile: ScenarioProfile, days: Optional[int] = None,
                    to_modality: str = "bike") -> np.ndarray:
    """Modality-mix drift: the mode share slides linearly from the
    profile's signature to ``to_modality``'s across the whole stream (a
    regime shift at day 0 ramped over its full length)."""
    T = days or profile.days
    return regime_shift_od(profile, days=T, shift_day=0,
                           to_modality=to_modality, ramp_days=T)


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
