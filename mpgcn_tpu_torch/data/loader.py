"""Dataset loading and preprocessing, numpy only (counterpart of
mpgcn_tpu/data/loader.py; reference Data_Container_OD.py:10-79).

``load_dataset(cfg)`` reads the reference's data directory
(``cfg.input_dir``): the sparse OD npz (``NPZ_NAME``, one row per day of
47 x 47 counts), of which the trailing 425 days are kept, the static
adjacency (``ADJ_NAME``) and, for a 'poi' branch, a POI similarity or
POI feature file. ``cfg.data`` picks the source: ``npz`` reads the files,
``synthetic`` draws the seeded generators, ``auto`` reads the npz when it
exists. The preprocessing then adds the channel dim, takes log1p, fits
the normalizer (whose state a checkpoint carries, and which
``denormalize`` inverts) and builds the dynamic O/D graphs.

The generators keep the JAX package's draw order, so one seed gives
byte-identical datasets in both packages: the port is checked against the
JAX package on the same data.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.dyn_graphs import construct_dyn_g
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.utils.retry import read_with_retry

NPZ_NAME = "od_day20180101_20210228.npz"
ADJ_NAME = "adjacency_matrix.npy"
POI_SIM_NAME = "poi_similarity.npy"     # precomputed (N, N) similarity
POI_FEAT_NAME = "poi_features.npy"      # (N, n_categories) counts -> cosine
REFERENCE_N = 47
REFERENCE_DAYS = 425  # 2020-01-01 .. 2021-02-28 (reference: :17)


class NoNormalizer:
    kind = "none"

    def fit(self, x):
        return x

    def normalize(self, x):
        return x

    def denormalize(self, x):
        return x

    def state(self):
        return {}

    def load_state(self, s):
        pass


class MinMaxNormalizer(NoNormalizer):
    """Scale to [0, 1] over the whole tensor (reference: :61-69)."""

    kind = "minmax"

    def __init__(self):
        self._min = self._max = None

    def fit(self, x):
        self._max, self._min = float(x.max()), float(x.min())
        print("min:", self._min, "max:", self._max)
        return self.normalize(x)

    def normalize(self, x):
        return (x - self._min) / (self._max - self._min)

    def denormalize(self, x):
        return (self._max - self._min) * x + self._min

    def state(self):
        return {"min": self._min, "max": self._max}

    def load_state(self, s):
        self._min, self._max = s["min"], s["max"]


class StdNormalizer(NoNormalizer):
    """Standardize to N(0, 1) over the whole tensor (reference: :71-79)."""

    kind = "std"

    def __init__(self):
        self._mean = self._std = None

    def fit(self, x):
        self._mean, self._std = float(x.mean()), float(x.std())
        print("mean:", round(self._mean, 4), "std:", round(self._std, 4))
        return self.normalize(x)

    def normalize(self, x):
        return (x - self._mean) / self._std

    def denormalize(self, x):
        return x * self._std + self._mean

    def state(self):
        return {"mean": self._mean, "std": self._std}

    def load_state(self, s):
        self._mean, self._std = s["mean"], s["std"]


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


class DataInput:
    """Load and preprocess the dataset ``cfg`` names (reference:
    Data_Container_OD.py:10-37); ``normalizer`` keeps the fitted state."""

    def __init__(self, cfg: MPGCNConfig):
        self.cfg = cfg
        self.normalizer = make_normalizer(cfg.norm)
        self._used_npz = False
        # io_errors=K injection drives the retry path in tests
        self._faults = FaultPlan.from_config(cfg)

    def _read(self, loader, path: str):
        """One data-file read, retried up to ``cfg.io_retries`` times."""
        return read_with_retry(lambda: loader(path), path,
                               attempts=self.cfg.io_retries,
                               base_delay_s=self.cfg.io_retry_delay_s,
                               faults=self._faults)

    def _load_raw(self) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        npz_path = os.path.join(cfg.input_dir, NPZ_NAME)
        adj_path = os.path.join(cfg.input_dir, ADJ_NAME)
        self._used_npz = cfg.data == "npz" or (cfg.data == "auto"
                                               and os.path.exists(npz_path))
        if not self._used_npz:
            return (synthetic_od(cfg.synthetic_T, cfg.synthetic_N, cfg.seed,
                                 profile=cfg.synthetic_profile),
                    synthetic_adjacency(cfg.synthetic_N, cfg.seed))
        import scipy.sparse as ss

        sparse = self._read(ss.load_npz, npz_path)
        dense = np.asarray(sparse.todense()).reshape((-1, REFERENCE_N,
                                                      REFERENCE_N))
        raw = dense[-REFERENCE_DAYS:]  # the trailing 425 days (:17-18)
        return raw, self._read(np.load, adj_path)

    def _load_poi_similarity(self, N: int) -> np.ndarray:
        """The 'poi' branch's graph: a precomputed (N, N) similarity, else
        the cosine similarity of (N, n_categories) POI features, else the
        synthetic features'. The files are read only when the OD series
        came from disk: synthetic zones have nothing to do with them."""
        cfg = self.cfg
        sim_path = os.path.join(cfg.input_dir, POI_SIM_NAME)
        feat_path = os.path.join(cfg.input_dir, POI_FEAT_NAME)
        if self._used_npz and os.path.exists(sim_path):
            sim = self._read(np.load, sim_path)
        elif self._used_npz and os.path.exists(feat_path):
            sim = poi_cosine_similarity(self._read(np.load, feat_path))
        else:
            if self._used_npz:
                print(f"no {POI_SIM_NAME}/{POI_FEAT_NAME} in "
                      f"{cfg.input_dir}; using synthetic POI features for "
                      f"the 'poi' branch")
            sim = poi_cosine_similarity(
                synthetic_poi_features(N, seed=cfg.seed))
        if sim.shape != (N, N):
            raise ValueError(
                f"POI similarity is {sim.shape}, expected ({N}, {N})")
        return sim

    def load_data(self) -> dict:
        raw, adj = self._load_raw()
        print(raw[..., None].shape)  # the reference's banner (:18)
        poi_sim = (self._load_poi_similarity(raw.shape[1])
                   if "poi" in self.cfg.resolved_branch_sources else None)
        return preprocess_od(raw, adj, self.cfg, self.normalizer,
                             poi_sim=poi_sim)


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
            reproduce_d_bug=cfg.reproduce_d_graph_bug,
            use_native=cfg.native_host != "off")
    if "poi" in sources and poi_sim is None:
        poi_sim = poi_cosine_similarity(
            synthetic_poi_features(od.shape[1], seed=cfg.seed))
    return {"OD": od, "adj": adj, "O_dyn_G": o_dyn, "D_dyn_G": d_dyn,
            "poi_sim": poi_sim}


def load_dataset(cfg: MPGCNConfig) -> tuple[dict, DataInput]:
    """The data dict for ``cfg`` and the ``DataInput`` that holds its
    fitted normalizer."""
    di = DataInput(cfg)
    return di.load_data(), di


def synthetic_dataset(cfg: MPGCNConfig) -> dict:
    """The synthetic data dict for ``cfg`` (synthetic_T days over
    synthetic_N zones, drawn from ``cfg.seed``), whatever ``cfg.data``
    says."""
    return load_dataset(cfg.replace(data="synthetic"))[0]


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
