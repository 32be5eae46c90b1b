"""Dataset generation and preprocessing, numpy only (counterpart of
mpgcn_tpu/data/loader.py).

The generators keep the JAX package's draw order, so one seed gives
byte-identical datasets in both packages: the port is checked against the
JAX package on the same data. The real NYC-taxi npz loader is not ported
yet; the synthetic weekly-periodic flows drive the port end to end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.dyn_graphs import construct_dyn_g


class NoNormalizer:
    kind = "none"

    def fit(self, x):
        return x

    def normalize(self, x):
        return x


class MinMaxNormalizer(NoNormalizer):
    """Scale to [0, 1] over the whole tensor (reference: :61-69)."""

    kind = "minmax"

    def __init__(self):
        self._min = self._max = None

    def fit(self, x):
        self._max, self._min = float(x.max()), float(x.min())
        return self.normalize(x)

    def normalize(self, x):
        return (x - self._min) / (self._max - self._min)


class StdNormalizer(NoNormalizer):
    """Standardize to N(0, 1) over the whole tensor (reference: :71-79)."""

    kind = "std"

    def __init__(self):
        self._mean = self._std = None

    def fit(self, x):
        self._mean, self._std = float(x.mean()), float(x.std())
        return self.normalize(x)

    def normalize(self, x):
        return (x - self._mean) / self._std


def make_normalizer(kind: str) -> NoNormalizer:
    if kind == "none":
        return NoNormalizer()
    if kind == "minmax":
        return MinMaxNormalizer()
    if kind == "std":
        return StdNormalizer()
    raise ValueError(f"invalid norm: {kind}")


def fold_seed(seed: int, *labels: str) -> int:
    """Fold string labels (city, modality) into a base seed, so tenants
    sharing a base seed draw distinct streams. No labels returns the seed
    unchanged."""
    if not labels:
        return int(seed)
    import zlib

    digest = zlib.crc32("|".join(labels).encode())
    return (int(seed) ^ digest) & 0x7FFFFFFF


def synthetic_od(T: int = 425, N: int = 47, seed: int = 0,
                 profile: str = "smooth", salt: str = "") -> np.ndarray:
    """Weekly-periodic synthetic OD flows (T, N, N), non-negative counts.

    profile="smooth": gamma-rate Poisson flows, every pair active.
    profile="realistic": zero-inflated, heavy-tailed pair rates and a few
    all-zero zones. The draw order of each profile is part of its contract:
    it reproduces every seeded dataset of the JAX package."""
    rng = np.random.default_rng(fold_seed(seed, salt) if salt else seed)
    t = np.arange(T)[:, None, None]
    trend = 1.0 + 0.1 * np.sin(2 * np.pi * t / 60.0)
    if profile == "smooth":
        base = rng.gamma(2.0, 20.0, size=(N, N))
        dow = 1.0 + 0.5 * np.sin(2 * np.pi * t / 7.0
                                 + rng.uniform(0, 2 * np.pi, size=(1, N, N)))
        return rng.poisson(base[None] * dow * trend).astype(np.float64)
    if profile != "realistic":
        raise ValueError(f"unknown synthetic profile {profile!r}: "
                         f"expected 'smooth' or 'realistic'")
    dow = 1.0 + 0.5 * np.sin(2 * np.pi * t / 7.0
                             + rng.uniform(0, 2 * np.pi, size=(1, N, N)))
    base = rng.lognormal(mean=1.0, sigma=1.5, size=(N, N))
    base *= rng.random((N, N)) < 0.45
    dead = rng.choice(N, size=max(1, N // 16), replace=False)
    base[dead, :] = 0.0
    base[:, dead] = 0.0
    return rng.poisson(base[None] * dow * trend).astype(np.float64)


def poi_cosine_similarity(feats: np.ndarray) -> np.ndarray:
    """(N, n_categories) POI counts -> (N, N) cosine-similarity graph with
    a zero diagonal; zero-POI zones get zero similarity."""
    feats = np.asarray(feats, dtype=np.float64)
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    unit = np.divide(feats, norms, out=np.zeros_like(feats),
                     where=norms > 0)
    sim = unit @ unit.T
    np.fill_diagonal(sim, 0.0)
    return np.clip(sim, 0.0, None)


def synthetic_poi_features(N: int, n_categories: int = 12,
                           seed: int = 0, salt: str = "") -> np.ndarray:
    """Synthetic per-zone POI category counts from a few latent zone
    archetypes mixed with noise."""
    rng = np.random.default_rng(
        (fold_seed(seed, salt) if salt else seed) + 2)
    n_types = 4
    archetypes = rng.gamma(2.0, 10.0, size=(n_types, n_categories))
    mix = rng.dirichlet(np.ones(n_types) * 0.5, size=N)
    lam = mix @ archetypes
    return rng.poisson(lam).astype(np.float64)


def synthetic_adjacency(N: int, seed: int = 0, salt: str = "") -> np.ndarray:
    """Symmetric 0/1 geographic-style adjacency with a ring backbone."""
    rng = np.random.default_rng(
        (fold_seed(seed, salt) if salt else seed) + 1)
    A = (rng.random((N, N)) < 0.15).astype(np.float64)
    A = np.maximum(A, A.T)
    idx = np.arange(N)
    A[idx, (idx + 1) % N] = 1.0
    A[(idx + 1) % N, idx] = 1.0
    A[idx, idx] = 0.0
    return A


def preprocess_od(raw: np.ndarray, adj: np.ndarray, cfg: MPGCNConfig,
                  normalizer: Optional[NoNormalizer] = None,
                  poi_sim: Optional[np.ndarray] = None) -> dict:
    """Raw (T, N, N) day counts + adjacency -> the model's data dict, with
    the reference's preprocessing (Data_Container_OD.py:18-35): channel
    dim, log1p, normalizer fit, unnormalized dynamic O/D correlation
    graphs over the train split."""
    sources = cfg.resolved_branch_sources
    raw = np.asarray(raw)[..., None]
    od = np.log(raw + 1.0)
    od = (normalizer or make_normalizer(cfg.norm)).fit(od)

    o_dyn = d_dyn = None
    if "dynamic" in sources:
        train_ratio = cfg.split_ratio[0] / sum(cfg.split_ratio)
        o_dyn, d_dyn = construct_dyn_g(
            raw, train_ratio, cfg.perceived_period,
            reproduce_d_bug=cfg.reproduce_d_graph_bug)
    if "poi" in sources and poi_sim is None:
        poi_sim = poi_cosine_similarity(
            synthetic_poi_features(od.shape[1], seed=cfg.seed))
    return {"OD": od, "adj": adj, "O_dyn_G": o_dyn, "D_dyn_G": d_dyn,
            "poi_sim": poi_sim}


def synthetic_dataset(cfg: MPGCNConfig) -> dict:
    """The synthetic data dict for ``cfg`` (synthetic_T days over
    synthetic_N zones, drawn from ``cfg.seed``)."""
    raw = synthetic_od(cfg.synthetic_T, cfg.synthetic_N, cfg.seed,
                       profile=cfg.synthetic_profile)
    adj = synthetic_adjacency(cfg.synthetic_N, cfg.seed)
    return preprocess_od(raw, adj, cfg)


def banded_mask(N: int, density: float) -> np.ndarray:
    """0/1 circulant band of about ``density`` nonzero share, no diagonal
    (the large-N configuration's graph shape, benchmarks/large_n.py)."""
    w = max(1, int(density * N / 2))
    i = np.arange(N)
    d = np.abs(i[:, None] - i[None, :])
    d = np.minimum(d, N - d)
    return ((d <= w) & (d > 0)).astype(np.float64)


def apply_density(data: dict, density: float) -> None:
    """Project the graphs AND the OD flows of ``data`` onto the band, in
    place: flows travel the edges that exist."""
    mask = banded_mask(data["OD"].shape[1], density)
    data["adj"] = data["adj"] * mask
    data["OD"] = data["OD"] * mask[None, :, :, None]
    for k in ("O_dyn_G", "D_dyn_G"):
        if data.get(k) is not None:
            data[k] = data[k] * mask[:, :, None]
