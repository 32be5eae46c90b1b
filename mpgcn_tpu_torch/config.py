"""Configuration for the PyTorch/CUDA port of MPGCN.

The fields the serving and training paths read, with the same names,
defaults and validation as the JAX package's ``MPGCNConfig`` and
``ServeConfig``, so one set of values configures either package. Knobs of
paths this port does not have yet (padded-CSR supports, sparse OD storage,
meshes, precision modes, resume, rollback) are not here; they arrive with
the slices that run them. The BDGCN arm is not a config field: it is the
``bdgcn_impl`` argument of ``ModelTrainer`` and ``ServeEngine``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# default per-M perspective lineups; other M need an explicit branch_sources
DEFAULT_LINEUPS = {
    1: ("static",),
    2: ("static", "dynamic"),
    3: ("static", "poi", "dynamic"),
}

BRANCH_SOURCES = ("static", "dynamic", "poi")

#: value payloads of a blocked-ELL support container (``support_payload``)
SUPPORT_PAYLOADS = ("f32", "bf16", "int8")

#: the BDGCN arms a model runs (nn/bdgcn.py); 'auto' resolves to one of
#: them by the support banks' density (data/pipeline.py)
BDGCN_IMPLS = ("kernel", "einsum", "ell")


@dataclasses.dataclass(frozen=True)
class MPGCNConfig:
    # --- reference flag surface (Main.py:11-37) ---
    output_dir: str = "./output"
    model: str = "MPGCN"
    obs_len: int = 7
    pred_len: int = 7
    norm: str = "none"                      # none | minmax | std
    split_ratio: Sequence[float] = (6.4, 1.6, 2)
    batch_size: int = 4
    hidden_dim: int = 32
    kernel_type: str = "random_walk_diffusion"
    cheby_order: int = 2
    loss: str = "MSE"                       # MSE | MAE | Huber
    optimizer: str = "Adam"
    learn_rate: float = 1e-4
    decay_rate: float = 0.0                 # L2 weight decay
    num_epochs: int = 200
    mode: str = "train"                     # train | test

    # --- architecture constants the reference hard-codes ---
    num_branches: int = 2                   # M: static adjacency + dynamic
    branch_sources: Sequence[str] | None = None
    input_dim: int = 1
    lstm_num_layers: int = 1
    gcn_num_layers: int = 3
    use_bias: bool = True

    # --- data semantics (Data_Container_OD.py) ---
    num_nodes: int = 0                      # N; filled from data at load time
    perceived_period: int = 7               # weekly dynamic-graph slots
    reproduce_d_graph_bug: bool = True      # reference eq. (7) row/col mix-up
    drop_last_window: bool = True           # reference off-by-one window drop
    shuffle: bool = False                   # reference never shuffles
    early_stop_patience: int = 10           # Model_Trainer.py:87

    # --- knobs without a reference equivalent ---
    seed: int = 0
    lambda_max: float | None = 2.0          # chebyshev rescale; None => power
    lambda_max_iters: int = 16              # iteration steps when None
    synthetic_T: int = 425
    synthetic_N: int = 47
    synthetic_profile: str = "smooth"       # smooth | realistic
    symnorm_degree_clamp: bool = True       # zero-degree rows -> zero rows
    isolated_nodes: str = "error"           # error | selfloop | ignore

    # --- the sparse support plane (sparse/) ---
    support_payload: str = "f32"            # f32 | bf16 | int8: how the
    #                                         blocked-ELL tiles are stored
    #                                         (int8: codes + one f32 scale
    #                                         per row block, dequantised at
    #                                         the kernels' operand read)
    sparse_density_threshold: float = 0.25  # support-bank density at or
    #                                         below which bdgcn_impl='auto'
    #                                         goes sparse ...
    sparse_min_nodes: int = 256             # ... when N is at least this

    def __post_init__(self):
        choices = {
            "norm": ("none", "minmax", "std"),
            "loss": ("MSE", "MAE", "Huber"),
            "mode": ("train", "test"),
            "kernel_type": ("localpool", "chebyshev", "random_walk_diffusion",
                            "dual_random_walk_diffusion"),
            "synthetic_profile": ("smooth", "realistic"),
            "isolated_nodes": ("error", "selfloop", "ignore"),
            "support_payload": SUPPORT_PAYLOADS,
        }
        for field_name, allowed in choices.items():
            val = getattr(self, field_name)
            if val not in allowed:
                raise ValueError(
                    f"{field_name}={val!r} is not one of {allowed}")
        if self.branch_sources is not None:
            bad = [s for s in self.branch_sources if s not in BRANCH_SOURCES]
            if bad:
                raise ValueError(
                    f"branch_sources entries {bad} not in {BRANCH_SOURCES}")
            if len(self.branch_sources) != self.num_branches:
                raise ValueError(
                    f"branch_sources has {len(self.branch_sources)} entries "
                    f"but num_branches={self.num_branches}")
        elif self.num_branches not in DEFAULT_LINEUPS:
            raise ValueError(
                f"num_branches={self.num_branches} has no default perspective "
                f"spec; pass branch_sources with one of {BRANCH_SOURCES} per "
                f"branch")
        if self.num_branches < 1:
            raise ValueError("num_branches must be >= 1")
        if not 0 <= self.sparse_density_threshold <= 1:
            raise ValueError(
                f"sparse_density_threshold={self.sparse_density_threshold} "
                f"must be in [0, 1] (a density fraction)")
        if self.sparse_min_nodes < 1:
            raise ValueError("sparse_min_nodes must be >= 1")

    @property
    def resolved_branch_sources(self) -> tuple[str, ...]:
        """Per-branch graph sources, defaulting to the reference lineup."""
        if self.branch_sources is not None:
            return tuple(self.branch_sources)
        return DEFAULT_LINEUPS[self.num_branches]

    @property
    def support_K(self) -> int:
        from mpgcn_tpu_torch.graph.kernels import support_k

        return support_k(self.kernel_type, self.cheby_order)

    def replace(self, **kw) -> "MPGCNConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (service/serve.py): the request path's batching and
    shedding shape and the per-request deadline budget."""

    buckets: tuple = (1, 2, 4, 8)  #: padded batch shapes; requests coalesce
    #:                                into the smallest bucket that fits
    horizons: tuple = ()        #: forecast horizons served; () = the model
    #:                             config's pred_len only
    max_queue: int = 64         #: bounded queue depth; submits beyond it
    #:                             are SHED with a typed rejection
    max_wait_ms: float = 2.0    #: micro-batch coalescing window
    deadline_ms: float = 1000.0  #: default per-request deadline budget
    #:                             (0 = none; requests may override)

    def __post_init__(self):
        b = tuple(int(x) for x in self.buckets)
        if not b or list(b) != sorted(set(b)) or b[0] < 1:
            raise ValueError(f"buckets={self.buckets!r} must be sorted "
                             f"unique ints >= 1")
        object.__setattr__(self, "buckets", b)
        h = tuple(int(x) for x in self.horizons)
        if h and (list(h) != sorted(set(h)) or h[0] < 1):
            raise ValueError(f"horizons={self.horizons!r} must be "
                             f"sorted unique ints >= 1 (or empty for "
                             f"single-horizon serving)")
        object.__setattr__(self, "horizons", h)
        if self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")
        for name in ("max_wait_ms", "deadline_ms"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 0")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)
