"""Configuration for the PyTorch/CUDA port of MPGCN.

The fields the serving and training paths and the command line read, with
the same names, defaults and validation as the JAX package's
``MPGCNConfig`` and ``ServeConfig``, so one set of values configures either
package: the reference flag surface (dataset directory, ``time_slice``,
normalization, split, model shape), the data source (``data``: the
reference npz or the synthetic generators), the optimizer's ``clip_norm``
and ``lr_schedule``, the epoch executor (``epoch_scan``,
``epoch_scan_max_mb``: no CLI flag, as in the JAX package), the
data-file read retries, and the self-healing trainer: gradient
accumulation (``grad_accum``), the jsonl run log, the epoch NaN guard,
the dead-init probe (``on_dead_init``, ``dead_init_retries``), the step
sentinels and their skip budget, the bad-epoch rollback and the hang
watchdog. Knobs of paths this port does not have yet (padded-CSR
supports, sparse OD storage, meshes, precision modes, remat, the orbax
checkpoint backend, fault injection) are not here; they arrive with the
slices that run them. The BDGCN arm is not a config
field: it is the ``bdgcn_impl`` argument of ``ModelTrainer`` and
``ServeEngine``.
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
    input_dir: str = "../data"
    output_dir: str = "./output"
    model: str = "MPGCN"
    time_slice: int = 24                    # parsed for parity; only 24
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
    data: str = "auto"                      # auto | npz | synthetic
    synthetic_T: int = 425
    synthetic_N: int = 47
    synthetic_profile: str = "smooth"       # smooth | realistic
    symnorm_degree_clamp: bool = True       # zero-degree rows -> zero rows
    isolated_nodes: str = "error"           # error | selfloop | ignore
    clip_norm: float = 0.0                  # global-norm gradient clipping
    #                                         (0 = off, reference behavior)
    lr_schedule: str = "none"               # none | cosine | exponential
    #                                         decay over the training run
    epoch_scan: bool = True                 # run each epoch that fits
    #                                         epoch_scan_max_mb on device-
    #                                         resident data, one host sync
    #                                         per epoch (on the card its
    #                                         steps replay CUDA graphs);
    #                                         False: per step
    epoch_scan_max_mb: float = 512.0        # a mode's epoch tensors above
    #                                         this run per step
    grad_accum: int = 1                     # microbatches per optimizer step:
    #                                         the train step runs k
    #                                         interleaved chunks of
    #                                         batch_size/k, accumulating
    #                                         grads, then updates once
    jsonl_log: bool = True                  # structured per-epoch JSONL log
    #                                         in <output_dir>/
    #                                         <model>_train_log.jsonl
    io_retries: int = 3                     # attempts per data-file read
    io_retry_delay_s: float = 0.05          # base backoff between retries
    #                                         (doubles per attempt)

    # --- failure detection and the self-healing trainer (resilience/) ---
    nan_guard: bool = True                  # a non-finite epoch loss (or a
    #                                         skip budget exceeded) is a bad
    #                                         epoch: quarantine, restore the
    #                                         last good checkpoint, then
    #                                         roll back or stop
    on_dead_init: str = "retry"             # warn | error | retry when the
    #                                         first trained epoch leaves
    #                                         every parameter unchanged and
    #                                         the forward is identically 0
    #                                         (a dead ReLU head): retry
    #                                         reseeds up to
    #                                         dead_init_retries times
    dead_init_retries: int = 3              # reseed attempts under 'retry'
    step_sentinels: bool = True             # a train step whose loss, new
    #                                         weights or new Adam state is
    #                                         non-finite is skipped inside
    #                                         the step (the state before it
    #                                         is kept) and marks its loss
    #                                         NaN; clean runs are bitwise
    #                                         identical either way
    skip_budget: int = 0                    # skipped train steps tolerated
    #                                         per epoch before it is bad
    loss_spike_factor: float = 10.0         # count step losses above factor
    #                                         x the previous good one in
    #                                         the epoch log; 0 disables
    rollback_retries: int = 0               # bad-epoch retries from the
    #                                         restored checkpoint (0: stop)
    rollback_lr_factor: float = 0.5         # learn_rate x this per retry
    watchdog_secs: float = 0.0              # hang watchdog deadline: no
    #                                         heartbeat within it -> dump
    #                                         every thread's stack, write an
    #                                         emergency checkpoint from the
    #                                         last host copy, exit 113
    #                                         (0 = off)

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
            "data": ("auto", "npz", "synthetic"),
            "lr_schedule": ("none", "cosine", "exponential"),
            "kernel_type": ("localpool", "chebyshev", "random_walk_diffusion",
                            "dual_random_walk_diffusion"),
            "synthetic_profile": ("smooth", "realistic"),
            "isolated_nodes": ("error", "selfloop", "ignore"),
            "support_payload": SUPPORT_PAYLOADS,
            "on_dead_init": ("warn", "error", "retry"),
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
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.dead_init_retries < 1:
            raise ValueError("dead_init_retries must be >= 1")
        if self.skip_budget < 0:
            raise ValueError("skip_budget must be >= 0")
        if self.rollback_retries < 0:
            raise ValueError("rollback_retries must be >= 0")
        if not 0 < self.rollback_lr_factor <= 1:
            raise ValueError(
                f"rollback_lr_factor={self.rollback_lr_factor} must be in "
                f"(0, 1] (it multiplies learn_rate on each rollback retry)")
        if self.loss_spike_factor < 0:
            raise ValueError("loss_spike_factor must be >= 0 (0 disables)")
        if self.watchdog_secs < 0:
            raise ValueError("watchdog_secs must be >= 0 (0 disables)")
        if self.io_retries < 1:
            raise ValueError("io_retries must be >= 1")
        if self.io_retry_delay_s < 0:
            raise ValueError("io_retry_delay_s must be >= 0")
        if self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by "
                f"grad_accum {self.grad_accum} (equal microbatches)")
        if self.time_slice != 24:
            # the reference parses -t and never reads it (Main.py:15)
            raise ValueError(
                "time_slice has no effect: the daily-OD pipeline has no "
                "sub-daily slicing (the reference parses -t and ignores it). "
                "Remove -t / leave it at the default 24.")

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

    @classmethod
    def from_dict(cls, d: dict) -> "MPGCNConfig":
        """The config from the entries of ``d`` that name a field; the
        rest are ignored."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


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
