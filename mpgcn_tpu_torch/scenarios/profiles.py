"""Scenario profiles (counterpart of mpgcn_tpu/scenarios/profiles.py):
named city-modality OD workloads, each a contract on its generated
statistics.

A ``ScenarioProfile`` names one workload: zone count, travel modality
(taxi | bike | metro, each with its own weekly signature), forecast
horizon, and target graph statistics -- adjacency density, degree skew
(max / mean degree) and temporal peak sharpness (p95 / p25 of the daily
totals). The generators are parameterized by those targets (the weekly
amplitude is solved by bisection, the adjacency's hub exponent searched)
and ``generate`` measures what it drew and raises ``ProfileStatsError``
when a statistic left its declared tolerance band.

Every draw folds the profile's name and modality into its base seed
(data/loader.py ``fold_seed``), so tenants provisioned from one base seed
never share a stream, and draws from numpy in the JAX package's order:
the same profile gives the same bytes in either package. ``write_spool``
writes a profile as the daemon's spool (day files and the adjacency);
successive calls extend one stream. numpy only: ``scenario list|gen`` and
fleet provisioning need no torch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from mpgcn_tpu_torch.data.loader import fold_seed

MODALITIES = ("taxi", "bike", "metro")

#: day-of-week demand shape per modality, values in [0, 1] (relative to
#: the modal peak day). Monday = index 0. These are the "per-modal
#: temporal signatures" of the paper's motivation: taxi demand leans
#: into weekend nightlife, bike trips are leisure-dominated (weekend
#: peaked, weather-noisy), metro is a sharp weekday-commute square wave
#: that collapses on weekends.
_MODAL_DOW_SHAPE = {
    "taxi": (0.60, 0.55, 0.55, 0.62, 0.82, 1.00, 0.90),
    "bike": (0.32, 0.30, 0.36, 0.42, 0.60, 1.00, 0.95),
    "metro": (1.00, 1.00, 1.00, 0.96, 0.90, 0.16, 0.10),
}

#: day-to-day multiplicative noise sigma per modality (bike demand is
#: weather-coupled and much noisier than a metro timetable)
_MODAL_NOISE = {"taxi": 0.08, "bike": 0.20, "metro": 0.03}


class ProfileStatsError(ValueError):
    """A generator's realized statistics drifted outside the profile's
    declared tolerance band: the scenario contract is broken (a changed
    generator, an infeasible target)."""


@dataclasses.dataclass(frozen=True)
class ScenarioProfile:
    """One named city-modality workload contract."""

    name: str
    city: str
    modality: str                    #: taxi | bike | metro
    num_nodes: int = 20              #: N (zones)
    days: int = 84                   #: T of a full generated series
    obs_len: int = 5                 #: observation window the model sees
    horizon: int = 1                 #: pred_len this scenario serves
    seed: int = 0                    #: base seed; draws use the FOLDED
    #:                                  seed (name + modality mixed in)
    # --- target graph statistics (validated by generate()) ------------------
    density: float = 0.2             #: adjacency edge density target
    degree_skew: float = 1.6         #: max-degree / mean-degree target
    peak_sharpness: float = 1.5      #: p95 / p25 of daily total flow
    #:                                  (peak-to-trough of the signature)
    flow_scale: float = 20.0         #: mean OD-pair daily rate at peak
    # --- validation tolerance bands (relative) -------------------------------
    density_tol: float = 0.35
    skew_tol: float = 0.5
    peak_tol: float = 0.5

    def __post_init__(self):
        if self.modality not in MODALITIES:
            raise ValueError(f"modality={self.modality!r} is not one of "
                             f"{MODALITIES}")
        for name in ("num_nodes", "days", "obs_len", "horizon"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 1")
        if self.num_nodes < 8:
            raise ValueError(f"num_nodes={self.num_nodes} is too small "
                             f"for a ring-backbone city (>= 8)")
        if not 0 < self.density <= 1:
            raise ValueError(f"density={self.density} must be in (0, 1]")
        min_density = 2.0 / (self.num_nodes - 1)
        if self.density < min_density:
            raise ValueError(
                f"density={self.density} is below the ring backbone's "
                f"floor 2/(N-1)={min_density:.3f} at N={self.num_nodes}")
        if self.degree_skew < 1.0:
            raise ValueError(f"degree_skew={self.degree_skew} must be "
                             f">= 1 (max/mean degree ratio)")
        if self.peak_sharpness < 1.0:
            raise ValueError(f"peak_sharpness={self.peak_sharpness} must "
                             f"be >= 1 (p95/p25 of daily totals)")
        if self.flow_scale <= 0:
            raise ValueError(f"flow_scale={self.flow_scale} must be > 0")
        if self.days <= self.obs_len + self.horizon:
            raise ValueError(
                f"days={self.days} leaves no window at obs_len="
                f"{self.obs_len}, horizon={self.horizon}")

    @property
    def folded_seed(self) -> int:
        """The effective generator seed: base seed with the profile's
        identity (name + modality) folded in, so same-base-seed tenants
        draw distinct streams."""
        return fold_seed(self.seed, self.name, self.modality)

    def model_kwargs(self) -> dict:
        """MPGCNConfig field overrides this scenario implies (the
        daemon/serve `--profile` flag surface)."""
        return {"obs_len": self.obs_len, "pred_len": self.horizon,
                "seed": self.folded_seed,
                "synthetic_N": self.num_nodes,
                "synthetic_T": self.days}

    def describe(self) -> dict:
        return {"name": self.name, "city": self.city,
                "modality": self.modality, "N": self.num_nodes,
                "days": self.days, "obs_len": self.obs_len,
                "horizon": self.horizon, "seed": self.seed,
                "folded_seed": self.folded_seed,
                "targets": {"density": self.density,
                            "degree_skew": self.degree_skew,
                            "peak_sharpness": self.peak_sharpness,
                            "flow_scale": self.flow_scale}}

    def replace(self, **kw) -> "ScenarioProfile":
        return dataclasses.replace(self, **kw)


# --- generators ---------------------------------------------------------------


def _daily_multiplier(profile: ScenarioProfile, T: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(T,) day multipliers realizing the modal weekly signature at the
    profile's declared peak sharpness. m(t) = 1 + a * s(dow(t)), with
    the amplitude `a` solved (bisection over one week) so that
    p95/p25 of m lands on `peak_sharpness`; multiplicative modal
    noise rides on top (its sigma is part of the modal signature, not
    the sharpness target -- the validator's tolerance absorbs it)."""
    shape = np.asarray(_MODAL_DOW_SHAPE[profile.modality])
    # solve over the REPEATED day-of-week series (not the 7 unique
    # values): with ~T/7 copies of each value the p25 lands inside a
    # value block, not between blocks, which materially changes the
    # realized ratio for plateau-shaped signatures like metro's
    tiled = shape[np.arange(max(T, 70)) % 7]

    def sharpness(a: float) -> float:
        m = 1.0 + a * tiled
        return float(np.percentile(m, 95) / np.percentile(m, 25))

    lo, hi = 0.0, 64.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if sharpness(mid) < profile.peak_sharpness:
            lo = mid
        else:
            hi = mid
    a = (lo + hi) / 2
    dow = np.arange(T) % 7
    m = 1.0 + a * shape[dow]
    noise = rng.lognormal(0.0, _MODAL_NOISE[profile.modality], size=T)
    trend = 1.0 + 0.05 * np.sin(2 * np.pi * np.arange(T) / 60.0)
    return m * noise * trend


def _node_weights(N: int, alpha: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Per-zone attachment propensities: a shuffled power law whose
    exponent controls hubbiness (metro systems concentrate flow on a
    few interchange hubs; bike networks are flat)."""
    w = (np.arange(1, N + 1, dtype=np.float64)) ** (-alpha)
    rng.shuffle(w)
    return w / w.sum()


def scenario_adjacency(profile: ScenarioProfile) -> np.ndarray:
    """Symmetric 0/1 adjacency hitting the profile's density AND degree
    skew: a ring backbone (every zone reachable) plus weighted edge
    sampling biased toward hub zones. The hub exponent is searched so
    the REALIZED max/mean degree ratio is closest to the declared
    target among candidate exponents -- the validator then only has to
    catch drift, not generator sloppiness."""
    N = profile.num_nodes
    target_edges = max(N, int(round(profile.density * N * (N - 1) / 2)))

    def build(alpha: float, rng: np.random.Generator) -> np.ndarray:
        A = np.zeros((N, N))
        idx = np.arange(N)
        A[idx, (idx + 1) % N] = A[(idx + 1) % N, idx] = 1.0
        w = _node_weights(N, alpha, rng)
        pair_w = np.outer(w, w)
        iu = np.triu_indices(N, k=1)
        probs = pair_w[iu]
        probs[A[iu] > 0] = 0.0  # ring edges already placed
        extra = target_edges - N
        if extra > 0 and probs.sum() > 0:
            take = rng.choice(probs.size, size=min(extra,
                                                   int((probs > 0).sum())),
                              replace=False, p=probs / probs.sum())
            A[iu[0][take], iu[1][take]] = 1.0
            A[iu[1][take], iu[0][take]] = 1.0
        return A

    best, best_err = None, np.inf
    # closed-loop exponent search: each candidate uses a FRESH rng from
    # the folded seed, so the chosen graph is deterministic in the seed
    for alpha in (0.0, 0.4, 0.8, 1.2, 1.8, 2.5):
        A = build(alpha, np.random.default_rng(profile.folded_seed + 1))
        deg = A.sum(1)
        skew = float(deg.max() / deg.mean())
        err = abs(skew - profile.degree_skew)
        if err < best_err:
            best, best_err = A, err
    return best


def scenario_od(profile: ScenarioProfile,
                days: Optional[int] = None) -> np.ndarray:
    """(T, N, N) daily OD counts for the profile: gravity-style pair
    rates over the hub weights (so busy zones are busy in FLOW, not
    just edges), modulated by the modal weekly signature at the
    declared peak sharpness, Poisson-sampled.

    Draw families use INDEPENDENT child streams of the folded seed so
    the series is a prefix-stable stream: scenario_od(T=40)[:20] is
    bitwise scenario_od(T=20) -- what lets write_spool extend a
    tenant's day stream across federation rounds as ONE continuous
    city, not a fresh draw per round."""
    T = days or profile.days
    N = profile.num_nodes
    seed = profile.folded_seed
    rng_pair = np.random.default_rng([seed, 0])
    rng_time = np.random.default_rng([seed, 1])
    rng_flow = np.random.default_rng([seed, 2])
    w = _node_weights(N, 0.8 if profile.degree_skew > 1.5 else 0.3,
                      rng_pair)
    pair = np.outer(w, w)
    pair = pair / pair.mean()  # mean pair weight 1.0
    pair *= rng_pair.lognormal(0.0, 0.6, size=(N, N))  # idiosyncratic
    np.fill_diagonal(pair, pair.diagonal() * 0.1)  # few intra-zone trips
    m = _daily_multiplier(profile, T, rng_time)
    rates = profile.flow_scale * pair[None] * m[:, None, None]
    return rng_flow.poisson(rates).astype(np.float64)


def scenario_poi_features(profile: ScenarioProfile,
                          n_categories: int = 12) -> np.ndarray:
    from mpgcn_tpu_torch.data.loader import synthetic_poi_features

    return synthetic_poi_features(
        profile.num_nodes, n_categories=n_categories, seed=profile.seed,
        salt=f"{profile.name}|{profile.modality}")


# --- measured statistics + validation ----------------------------------------


def measured_stats(od: np.ndarray, adj: np.ndarray) -> dict:
    """The realized statistics a profile declares targets for."""
    N = adj.shape[0]
    deg = adj.sum(1)
    totals = od.sum(axis=(1, 2))
    trough = float(np.percentile(totals, 25))
    return {
        "density": float(adj.sum() / (N * (N - 1))),
        "degree_skew": float(deg.max() / max(deg.mean(), 1e-12)),
        # peak-to-trough of the daily totals (p95/p25): robust for
        # weekend-peaked (bike) AND weekday-plateau (metro) signatures,
        # where a median-based ratio saturates near 1
        "peak_sharpness": (float(np.percentile(totals, 95) / trough)
                           if trough > 0 else float("inf")),
        "mean_daily_total": float(totals.mean()),
    }


def validate_stats(profile: ScenarioProfile, od: np.ndarray,
                   adj: np.ndarray) -> dict:
    """Measured stats, or ProfileStatsError when any realized statistic
    sits outside the profile's declared relative tolerance band."""
    stats = measured_stats(od, adj)
    checks = (("density", profile.density, profile.density_tol),
              ("degree_skew", profile.degree_skew, profile.skew_tol),
              ("peak_sharpness", profile.peak_sharpness, profile.peak_tol))
    bad = []
    for key, target, tol in checks:
        got = stats[key]
        if not np.isfinite(got) or abs(got - target) > tol * target:
            bad.append(f"{key}: realized {got:.3f} vs declared "
                       f"{target:.3f} (tol +-{tol * 100:.0f}%)")
    if bad:
        raise ProfileStatsError(
            f"profile {profile.name!r} generator drifted off its "
            f"contract: " + "; ".join(bad))
    return stats


def generate(profile: ScenarioProfile, days: Optional[int] = None,
             validate: bool = True) -> dict:
    """The profile's full dataset: {od (T,N,N), adj (N,N), poi (N,C),
    stats}. `validate=True` (default) enforces the declared-statistics
    contract."""
    od = scenario_od(profile, days=days)
    adj = scenario_adjacency(profile)
    stats = (validate_stats(profile, od, adj) if validate
             else measured_stats(od, adj))
    return {"od": od, "adj": adj,
            "poi": scenario_poi_features(profile), "stats": stats}


def write_spool(profile: ScenarioProfile, spool_dir: str,
                days: Optional[int] = None, start_day: int = 0,
                validate: bool = True) -> list[str]:
    """Materialize the profile as a daemon spool: one day_<idx>.npy
    (N, N) snapshot per day plus the adjacency.npy the daemon reads
    beside them (service/daemon.py::_adjacency). Day indices start at
    `start_day` so successive calls extend the same stream (the
    federation harness feeds daemons in rounds). Returns the written
    paths."""
    from mpgcn_tpu_torch.service.ingest import day_filename

    n_days = days or profile.days
    # generate the FULL stream up to start_day + n_days and slice, so
    # round k+1's days are the continuation of round k's series (same
    # folded seed, same draw order), not a fresh draw
    data = generate(profile, days=start_day + n_days, validate=validate)
    os.makedirs(spool_dir, exist_ok=True)
    paths = []
    for i in range(start_day, start_day + n_days):
        p = os.path.join(spool_dir, day_filename(i))
        np.save(p, data["od"][i])
        paths.append(p)
    adj_path = os.path.join(spool_dir, "adjacency.npy")
    if os.path.exists(adj_path):
        # a reused spool dir must hold THIS profile's graph: silently
        # keeping another profile's adjacency would have the daemon
        # training this city's flows against the wrong graph
        if not np.array_equal(np.load(adj_path), data["adj"]):
            raise ValueError(
                f"{adj_path} holds a different adjacency than profile "
                f"{profile.name!r} generates -- the spool dir was "
                f"provisioned for another profile; use a fresh dir")
    else:
        np.save(adj_path, data["adj"])
    return paths


# --- registry -----------------------------------------------------------------

#: the built-in scenario lineup: one shape-compatible trio (same N +
#: obs_len, so one fleet process serves all three; what differs is
#: modality, temporal signature, graph statistics, horizon, and the
#: folded seed) plus a transfer-target city per modality family.
_BUILTINS = (
    ScenarioProfile(
        name="taxi-midtown", city="midtown", modality="taxi",
        num_nodes=20, days=84, obs_len=5, horizon=1,
        density=0.25, degree_skew=1.5, peak_sharpness=1.35,
        flow_scale=25.0),
    ScenarioProfile(
        name="bike-harbor", city="harbor", modality="bike",
        num_nodes=20, days=84, obs_len=5, horizon=3,
        density=0.18, degree_skew=1.3, peak_sharpness=2.0,
        flow_scale=8.0),
    ScenarioProfile(
        name="metro-loop", city="loop", modality="metro",
        num_nodes=20, days=84, obs_len=5, horizon=6,
        density=0.15, degree_skew=2.1, peak_sharpness=1.8,
        flow_scale=60.0),
    # transfer target: same modality/shape as taxi-midtown, different
    # city (different folded seed + slightly different statistics) --
    # the donor-selection + warm-start A/B pair (scenarios/transfer.py)
    ScenarioProfile(
        name="taxi-riverside", city="riverside", modality="taxi",
        num_nodes=20, days=84, obs_len=5, horizon=1,
        density=0.22, degree_skew=1.6, peak_sharpness=1.4,
        flow_scale=22.0),
)

_REGISTRY: dict[str, ScenarioProfile] = {p.name: p for p in _BUILTINS}


def register_profile(profile: ScenarioProfile,
                     overwrite: bool = False) -> ScenarioProfile:
    if profile.name in _REGISTRY and not overwrite:
        raise ValueError(f"profile {profile.name!r} is already "
                         f"registered (pass overwrite=True)")
    _REGISTRY[profile.name] = profile
    return profile


def get_profile(name: str) -> ScenarioProfile:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario profile {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_profiles() -> list[str]:
    return sorted(_REGISTRY)
