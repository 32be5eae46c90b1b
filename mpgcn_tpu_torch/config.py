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
watchdog, and the precision plane: the compute ``dtype`` (bf16 training
on f32 master weights), ``remat``, the dynamic loss scaler
(``loss_scaling`` and its ``loss_scale_*`` knobs) and the inference
precision (``infer_precision``: f32, bf16 or int8 weight-only), and the
city-scale feed: the fused epilogues (``fused_epilogue``), the host
storage of the OD series (``od_storage``), the chunked-stream epoch
executor (``epoch_stream``, ``stream_chunk_mb``) and the C++/OpenMP host
kernels (``native_host``), and the fault-injection spec (``faults``,
resilience/faults.py; the serving plane runs its arms), and the operator
surface: the kernel-library directory (``compile_cache_dir``) and the
trainer's telemetry (``obs_metrics``), and the tunable knobs set on
purpose (``explicit_knobs``: a tuned profile never overrides them,
tune/registry.py), and data-parallel training: the checkpoint format
(``checkpoint_backend``) and the replica digest check
(``consistency_check_every``). Knobs of paths this port does not have
yet (the model axis, ``branch_exec``, liveness) are not here; they
arrive with the slices that run them. ``DEFAULT_SLOS``
are the serving plane's objectives (obs/perf/slo.py). The BDGCN arm is not a config
field: it is the ``bdgcn_impl`` argument of ``ModelTrainer`` and
``ServeEngine``. ``DaemonConfig`` configures the continual-learning
daemon's loop (service/daemon.py). ``RouterConfig`` configures the front
tier over replica processes (service/router.py); like this module, it
needs no torch.
"""

from __future__ import annotations

import dataclasses
import math
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
BDGCN_IMPLS = ("kernel", "einsum", "folded", "csr", "ell")

# Service-level objectives (obs/perf/slo.py), the JAX package's
# DEFAULT_SLOS: ``windows_s`` are the (short, long) burn windows,
# ``burn_threshold`` the multiple that, sustained in both, flips the
# objective to ``burning`` (exported through /metrics and /v1/stats; a
# sustained burn dumps a flight-recorder postmortem). ``objective=0`` on
# a rate means any event past the first snapshot burns; on a floor it
# means informational only. ``retrace_rate`` reads the port's
# counterpart of XLA compiles: CUDA graph captures and kernel library
# builds (obs/metrics.py ``cuda_program_builds``), which all land during
# startup, before the first snapshot.
DEFAULT_SLOS = (
    dict(name="serve_latency_p99", kind="latency_p99", plane="serve",
         metric="serve_request_latency_ms", objective=250.0,
         per_label="tenant", windows_s=(60.0, 600.0), burn_threshold=2.0,
         description="p99 of accepted request latency (ms); per-tenant "
                     "children evaluated separately in fleet mode"),
    dict(name="serve_shed_ratio", kind="bad_ratio", plane="serve",
         metric="serve_requests", objective=0.05,
         bad_prefixes=("shed-", "error-"),
         per_label="tenant", windows_s=(60.0, 600.0), burn_threshold=2.0,
         description="shed/error share of resolved requests (error "
                     "budget 5%); client rejections (4xx) spend no "
                     "budget"),
    dict(name="train_steps_per_sec", kind="gauge_min", plane="train",
         metric="train_steps_per_sec", objective=0.0,
         windows_s=(60.0, 600.0), burn_threshold=1.5,
         description="post-warmup training throughput floor (0 = "
                     "informational)"),
    dict(name="retrace_rate", kind="rate", plane=None,
         metric="cuda_program_builds", objective=0.0,
         windows_s=(60.0, 600.0), burn_threshold=1.0,
         description="CUDA graph captures and kernel library builds per "
                     "window AFTER the first snapshot (startup's land "
                     "before it): a stable hot path must show zero"),
    dict(name="scaler_skip_rate", kind="rate", plane="train",
         metric="train_loss_scale_skipped_steps", objective=0.0,
         windows_s=(60.0, 600.0), burn_threshold=1.0,
         description="loss-scaler skipped steps per window (self-"
                     "correcting, but sustained skips mean the scale "
                     "is pinned at the floor)"),
)


def default_slos(plane: str | None = None) -> tuple:
    """The DEFAULT_SLOS subset one runtime plane evaluates (specs with
    plane=None ride every plane), as fresh dict copies."""
    return tuple(dict(s) for s in DEFAULT_SLOS
                 if plane is None or s.get("plane") in (None, plane))


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
    dtype: str = "float32"                  # compute dtype of the forward
    #                                         and backward (float32 |
    #                                         bfloat16); weights stay f32
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
    checkpoint_backend: str = "pickle"      # pickle: the JAX package's
    #                                         one-file format; orbax: a
    #                                         directory at the checkpoint
    #                                         path, one torch.save file a
    #                                         section (train/checkpoint.py),
    #                                         not the JAX orbax layout
    epoch_scan: bool = True                 # run each epoch that fits
    #                                         epoch_scan_max_mb on device-
    #                                         resident data, one host sync
    #                                         per epoch (on the card its
    #                                         steps replay CUDA graphs);
    #                                         False: per step
    epoch_scan_max_mb: float = 512.0        # a mode's epoch tensors above
    #                                         this run on the stream
    #                                         executor
    epoch_stream: bool = True               # the chunked-stream executor
    #                                         for modes over
    #                                         epoch_scan_max_mb: the epoch
    #                                         index in chunks that fit
    #                                         stream_chunk_mb, chunk k+1
    #                                         gathered and uploaded while
    #                                         chunk k computes (two chunk
    #                                         buffers on the device at
    #                                         most); False: per step
    stream_chunk_mb: float = 0.0            # device budget per stream chunk
    #                                         (gathered x + y + keys); 0
    #                                         takes epoch_scan_max_mb
    native_host: str = "auto"               # auto | off: the C++/OpenMP
    #                                         host kernels (window gather,
    #                                         day-of-week mean) when they
    #                                         build, else numpy
    remat: bool = False                     # checkpoint each branch of the
    #                                         training forward: its kernels
    #                                         run again in the backward
    #                                         instead of keeping residuals
    grad_accum: int = 1                     # microbatches per optimizer step:
    #                                         the train step runs k
    #                                         interleaved chunks of
    #                                         batch_size/k, accumulating
    #                                         grads, then updates once
    jsonl_log: bool = True                  # structured per-epoch JSONL log
    #                                         in <output_dir>/
    #                                         <model>_train_log.jsonl
    compile_cache_dir: str = ""             # the directory of the built
    #                                         kernel libraries (obs/perf/
    #                                         compile_cache.py): a second
    #                                         process loads them instead of
    #                                         building them; "" = the
    #                                         $MPGCN_COMPILE_CACHE env hook,
    #                                         else native/_build/
    obs_metrics: bool = True                # the trainer's telemetry: its
    #                                         series in the default metrics
    #                                         registry, the SLO engine and
    #                                         the registry snapshot in each
    #                                         epoch event (-no-obs: off)
    loss_scaling: str = "auto"             # none | dynamic | auto: the
    #                                         dynamic loss scaler of bf16
    #                                         training (quant/scaling.py);
    #                                         auto = dynamic for bfloat16,
    #                                         none for float32. Clean runs
    #                                         equal 'none' bit for bit;
    #                                         non-finite grads skip the
    #                                         step and halve the scale
    #                                         without touching skip_budget
    loss_scale_init: float = 65536.0        # initial scale (2^16)
    loss_scale_growth_interval: int = 200   # clean steps before it doubles
    loss_scale_min: float = 1.0             # floor the scale halves to
    infer_precision: str = "auto"           # auto | f32 | bf16 | int8: the
    #                                         rollouts' precision (test,
    #                                         predict, serve); auto follows
    #                                         dtype; int8 = per-channel
    #                                         weight-quantized weights,
    #                                         dequantized inside the forward
    faults: str = ""                        # deterministic fault-injection
    #                                         spec (resilience/faults.py),
    #                                         e.g. "flood_qps=200";
    #                                         $MPGCN_FAULTS is the env hook
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
    consistency_check_every: int = 0        # every k epochs, digest-compare
    #                                         every rank's weights, Adam
    #                                         state and banks; a divergence
    #                                         rolls back (0 = off)
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
    od_storage: str = "auto"                # auto | dense | sparse: host
    #                                         storage of the (T, N, N) OD
    #                                         series; sparse keeps one flat
    #                                         of non-zeros a day and
    #                                         densifies only the windows a
    #                                         batch or chunk gathers; auto
    #                                         follows the sparse arms' rule
    fused_epilogue: bool = False            # the fused epilogues: one
    #                                         stacked gate matmul a step
    #                                         for all M branches (-lstm
    #                                         plain), the BDGCN projection
    #                                         reassociated into stacked
    #                                         contractions (one destination
    #                                         SpMM a layer on the sparse
    #                                         arms), int8 weights
    #                                         dequantised at each use. Same
    #                                         math, another summation order
    explicit_knobs: tuple = ()              # tunable knobs (CONFIG_KNOBS)
    #                                         set on purpose (the CLI records
    #                                         every tunable flag passed): a
    #                                         tuned/*.json profile never
    #                                         overrides them
    #                                         (tune/registry.py resolve_knob)

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
            "dtype": ("float32", "bfloat16"),
            "loss_scaling": ("none", "dynamic", "auto"),
            "infer_precision": ("auto", "f32", "bf16", "int8"),
            "od_storage": ("auto", "dense", "sparse"),
            "native_host": ("auto", "off"),
            "checkpoint_backend": ("pickle", "orbax"),
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
        if self.explicit_knobs:
            object.__setattr__(self, "explicit_knobs",
                               tuple(self.explicit_knobs))
            from mpgcn_tpu_torch.tune.registry import CONFIG_KNOBS

            unknown = [k for k in self.explicit_knobs
                       if k not in CONFIG_KNOBS]
            if unknown:
                raise ValueError(
                    f"explicit_knobs={unknown} are not tunable config "
                    f"knobs (tune/registry.py CONFIG_KNOBS: "
                    f"{list(CONFIG_KNOBS)})")
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
        if self.consistency_check_every < 0:
            raise ValueError("consistency_check_every must be >= 0 "
                             "(0 disables the check)")
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
        for name in ("loss_scale_init", "loss_scale_min"):
            v = getattr(self, name)
            # powers of two only: scaling by 2^k is exact, which is what
            # keeps a clean scaled run bitwise equal to an unscaled one
            if v <= 0 or not math.log2(v).is_integer():
                raise ValueError(
                    f"{name}={v} must be a positive power of two "
                    f"(scaling by 2^k is bitwise-exact; anything else "
                    f"rounds every gradient)")
        if self.loss_scale_growth_interval < 1:
            raise ValueError("loss_scale_growth_interval must be >= 1")
        if self.loss_scale_min > self.loss_scale_init:
            raise ValueError(
                f"loss_scale_min={self.loss_scale_min} must not exceed "
                f"loss_scale_init={self.loss_scale_init}")
        if self.stream_chunk_mb < 0:
            raise ValueError(
                "stream_chunk_mb must be >= 0 (0 defaults the chunk budget "
                "to epoch_scan_max_mb)")
        if self.io_retries < 1:
            raise ValueError("io_retries must be >= 1")
        if self.io_retry_delay_s < 0:
            raise ValueError("io_retry_delay_s must be >= 0")
        if self.faults:
            # fail at config time, not at the injected step
            from mpgcn_tpu_torch.resilience.faults import FaultPlan

            FaultPlan.parse(self.faults)
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
    def resolved_infer_precision(self) -> str:
        """The rollouts' precision: ``infer_precision``, 'auto' following
        the training ``dtype`` (the JAX trainer's ``_infer_precision``)."""
        if self.infer_precision != "auto":
            return self.infer_precision
        return "bf16" if self.dtype == "bfloat16" else "f32"

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
class DaemonConfig:
    """The continual-learning daemon's knobs (service/daemon.py; the JAX
    package's DaemonConfig, mpgcn_tpu/service/config.py): the rolling
    window and its split, drift detection, retrain and promotion, loop
    control, the day gate's profile and traffic capture. One
    ``MPGCNConfig`` describes each retrain; these describe the loop."""

    #: where day snapshots arrive (``day_<idx>.npy``, one (N, N) OD
    #: matrix a day; an ``adjacency.npy`` beside them overrides the
    #: synthetic adjacency)
    spool_dir: str
    #: the daemon's root: accepted/, quarantine/, retrain/, promoted/,
    #: rejected/, daemon_log.jsonl
    output_dir: str = "./service"

    # rolling window and split
    window_days: int = 56       #: training window: newest accepted days
    holdout_days: int = 8       #: held-out recent days: the gate's
    #:                             ('test') split and promote metric
    val_days: int = 6           #: early-stop validation windows
    min_train_days: int = 0     #: days before the first retrain (0:
    #:                             obs + pred + val + holdout + batch)

    # drift detection
    drift_window: int = 3       #: eval-loss trend window (cycles): drift
    #:                             = mean(last w) > (1 + threshold) x
    #:                             mean(previous w)
    drift_threshold: float = 0.2
    drift_skip_budget: int = 0  #: sentinel-skipped steps in a retrain
    #:                             that count as drift (0: any skip)
    drift_spike_budget: int = 3  #: loss spikes tolerated per retrain

    # retrain and promotion
    retrain_cadence: int = 7    #: accepted days between cadence retrains
    promote_tolerance: float = 0.05  #: a candidate may tie the incumbent
    #:                             within loss x (1 + tol) and promote
    gate: bool = True           #: eval-before-promote; False promotes
    #:                             every candidate (for the test that
    #:                             shows the gate is load-bearing)
    retrain_init: str = "warm"  #: warm (the incumbent's weights) |
    #:                             scratch (a fresh draw every retrain)

    # loop control
    ingest_batch: int = 0       #: max days ingested a cycle (0: all)
    poll_secs: float = 1.0      #: sleep between idle cycles
    idle_exits: int = 0         #: exit 0 after N idle cycles in a row
    #:                             (0: run forever)
    max_cycles: int = 0         #: hard cycle cap (0: none)

    # the day gate's profile
    profile_zmax: float = 6.0   #: |z| of a day's log total flow beyond
    #:                             which it is an outlier
    profile_min_history: int = 5  #: accepted days before the z-test arms
    num_nodes: int = 0          #: expected zone count (0: the first
    #:                             accepted day's)
    robust_window: int = 64     #: accepted-day log totals the robust
    #:                             (median/MAD) profile remembers
    shock_coherence: float = 0.90  #: min cosine against the accepted
    #:                             pattern for an outlier to be an event
    #:                             shock (trains) rather than poison
    shock_support_max: float = 0.05  #: max share of an outlier day's
    #:                             mass off the accepted support

    # traffic capture
    capture_ledger: str = ""    #: serving-plane requests.jsonl to stitch
    #:                             day files from ("": capture off)
    capture_tenant: str = ""    #: tenant filter for a fleet ledger ("":
    #:                             any tenant's rows)

    def __post_init__(self):
        if not self.spool_dir:
            raise ValueError("spool_dir is required (where day snapshots "
                             "arrive)")
        positives = ("window_days", "holdout_days", "val_days",
                     "drift_window", "retrain_cadence")
        for name in positives:
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 1")
        non_negatives = ("min_train_days", "drift_skip_budget",
                         "drift_spike_budget", "ingest_batch", "idle_exits",
                         "max_cycles", "profile_min_history", "num_nodes")
        for name in non_negatives:
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 0")
        if self.drift_threshold <= 0:
            raise ValueError("drift_threshold must be > 0 (relative "
                             "eval-loss rise that names drift)")
        if self.promote_tolerance < 0:
            raise ValueError("promote_tolerance must be >= 0")
        if self.poll_secs < 0:
            raise ValueError("poll_secs must be >= 0")
        if self.profile_zmax <= 0:
            raise ValueError("profile_zmax must be > 0")
        if self.robust_window < 2:
            raise ValueError(f"robust_window={self.robust_window} must "
                             f"be >= 2 (a median needs a window)")
        if not 0.0 < self.shock_coherence <= 1.0:
            raise ValueError(f"shock_coherence={self.shock_coherence} "
                             f"must be in (0, 1]")
        if not 0.0 <= self.shock_support_max <= 1.0:
            raise ValueError(f"shock_support_max={self.shock_support_max}"
                             f" must be in [0, 1]")
        if self.retrain_init not in ("warm", "scratch"):
            raise ValueError(f"retrain_init={self.retrain_init!r} is not "
                             f"one of ('warm', 'scratch')")
        if self.holdout_days + self.val_days >= self.window_days:
            raise ValueError(
                f"holdout_days={self.holdout_days} + val_days="
                f"{self.val_days} must leave training windows inside "
                f"window_days={self.window_days}")

    def replace(self, **kw) -> "DaemonConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (service/serve.py; the JAX package's ServeConfig,
    mpgcn_tpu/service/config.py): the request path's batching and
    shedding shape, the per-request deadline budget, the double-buffered
    feed, the canaried hot-reload protocol and the ledgers."""

    #: service root (the daemon layout): promoted/<model>_od.pkl is the
    #: hot-reload slot, promoted/promotions.jsonl the sequence ledger,
    #: accepted/ the day files the support banks are rebuilt from, and
    #: serve/ the request and reload ledgers
    output_dir: str = "./service"

    # --- request path ---
    buckets: tuple = (1, 2, 4, 8)  #: padded batch shapes; requests coalesce
    #:                                into the smallest bucket that fits
    horizons: tuple = ()        #: forecast horizons served; () = the model
    #:                             config's pred_len only
    max_queue: int = 64         #: bounded queue depth; submits beyond it
    #:                             are SHED with a typed rejection
    max_wait_ms: float = 2.0    #: micro-batch coalescing window
    deadline_ms: float = 1000.0  #: default per-request deadline budget
    #:                             (0 = none; requests may override)
    double_buffer: bool = True  #: a stager thread coalesces, pads and (on
    #:                             the card) uploads batch k+1 while batch
    #:                             k runs (service/batcher.py); False is
    #:                             the one-thread feed

    # --- canaried hot reload ---
    reload_poll_secs: float = 2.0  #: promoted-slot poll period (0 = hot
    #:                                reload off)
    canary_fraction: float = 0.25  #: share of batches a reloaded candidate
    #:                                serves during its canary
    canary_requests: int = 16   #: canary-served requests that must come
    #:                             back finite before promotion (0 =
    #:                             promote right after the smoke eval)
    reload_tolerance: float = 0.25  #: candidate probe-loss regression vs
    #:                             the incumbent tolerated at reload time

    # --- observability ---
    ledger_max_bytes: int = 8_000_000  #: request/reload/span jsonl
    #:                             rotation cap (one rotated generation)
    capture_flows: bool = False  #: log each accepted request's day_slot
    #:                             and newest (N, N) observation slot into
    #:                             the request ledger

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
        for name in ("max_wait_ms", "deadline_ms", "reload_poll_secs"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 0")
        if not 0.0 < self.canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction={self.canary_fraction} "
                             f"must be in (0, 1]")
        if self.canary_requests < 0:
            raise ValueError(f"canary_requests={self.canary_requests} "
                             f"must be >= 0")
        if self.reload_tolerance < 0:
            raise ValueError(f"reload_tolerance={self.reload_tolerance} "
                             f"must be >= 0")
        if self.ledger_max_bytes < 0:
            raise ValueError(f"ledger_max_bytes={self.ledger_max_bytes} "
                             f"must be >= 0 (0 = unrotated)")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FleetConfig(ServeConfig):
    """Multi-tenant fleet knobs (service/fleet.py; the JAX package's
    FleetConfig, mpgcn_tpu/service/config.py:359-399) on top of the
    serving ones: every ServeConfig field keeps its meaning per tenant
    (each tenant has its own micro-batcher queues, deadline budget and
    canary), plus the walls between tenants."""

    tenant_max_inflight: int = 32  #: admitted-but-unresolved requests a
    #:                                tenant may hold (its quota bulkhead;
    #:                                0 = unlimited; a registry entry's
    #:                                `quota` overrides it)
    breaker_threshold: int = 5  #: consecutive model failures
    #:                             (error-internal / error-nonfinite) that
    #:                             trip a tenant's circuit breaker OPEN
    #:                             (0 = breaker off)
    breaker_cooldown_s: float = 30.0  #: open-state dwell before the
    #:                             half-open probe request is admitted
    mesh_rungs: tuple = ()  #: the JAX fleet's mesh-degradation ladder;
    #:                         the port serves on one device: () only

    def __post_init__(self):
        super().__post_init__()
        if self.tenant_max_inflight < 0:
            raise ValueError(
                f"tenant_max_inflight={self.tenant_max_inflight} must "
                f"be >= 0 (0 = unlimited)")
        if self.breaker_threshold < 0:
            raise ValueError(
                f"breaker_threshold={self.breaker_threshold} must be "
                f">= 0 (0 = breaker off)")
        if self.breaker_cooldown_s < 0:
            raise ValueError(
                f"breaker_cooldown_s={self.breaker_cooldown_s} must be "
                f">= 0")
        rungs = tuple(int(r) for r in self.mesh_rungs)
        object.__setattr__(self, "mesh_rungs", rungs)
        if rungs:
            if list(rungs) != sorted(set(rungs), reverse=True) \
                    or rungs[-1] < 1:
                raise ValueError(
                    f"mesh_rungs={self.mesh_rungs!r} must be strictly "
                    f"descending positive device counts (e.g. (8, 4, 2, "
                    f"1))")
            raise ValueError(
                f"mesh_rungs={rungs!r}: the port's fleet serves on one "
                f"device; the mesh-degradation ladder is multi-device "
                f"work (ROADMAP Queue 1 item 6)")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """`router` knobs (service/router.py; the JAX package's RouterConfig,
    mpgcn_tpu/service/config.py:238-357): the device-free front tier over
    N ``serve --fleet`` replica processes -- health probing, per-replica
    circuit breaking, request-level failover, rolling deploys, and the
    SLO-burn autoscaler. Every knob has a CLI flag of the same name."""

    #: router root: router/http.json (address discovery),
    #: router/replicas/r<k>/ (per-replica service roots),
    #: router/router.jsonl (the routing ledger)
    output_dir: str = "./service"

    # --- replica set ---
    replicas: int = 2           #: replica processes at startup
    min_replicas: int = 1       #: autoscaler floor (also the manual floor)
    max_replicas: int = 4       #: autoscaler ceiling
    replica_set_size: int = 0   #: replicas in a tenant's rendezvous set
    #:                             (0 = all admitted replicas); requests
    #:                             rotate through the set, failover walks
    #:                             it in rendezvous order

    # --- health probing / per-replica breaker ---
    probe_interval_s: float = 0.5   #: /healthz probe period per replica
    probe_timeout_s: float = 2.0    #: per-probe HTTP timeout
    breaker_threshold: int = 3  #: consecutive transport failures
    #:                             (connect/timeout/reset, failed probes)
    #:                             that trip a replica's breaker OPEN
    #:                             (0 = breaker off)
    breaker_cooldown_s: float = 2.0  #: open-state dwell before the
    #:                             half-open health probe re-admits

    # --- request path ---
    deadline_ms: float = 1000.0  #: default per-request deadline budget
    #:                             governing the WHOLE failover walk
    #:                             (0 = none; requests may override)
    failover_attempts: int = 3  #: distinct replicas tried per request
    #:                             before the typed 503
    connect_timeout_s: float = 2.0  #: per-attempt TCP connect budget
    #:                             (a dead/partitioned replica must fail
    #:                             fast enough to leave deadline budget
    #:                             for the sibling)

    # --- replica lifecycle ---
    ready_timeout_s: float = 600.0  #: replica launch -> healthy budget
    #:                             (a replica's startup builds any missing
    #:                             kernel library and captures its rollout
    #:                             graphs)
    drain_timeout_s: float = 30.0   #: SIGTERM -> exit budget during a
    #:                             rolling deploy before escalation
    restart_dead: bool = True   #: the control thread restarts replicas
    #:                             that died without being asked (kill -9
    #:                             chaos); re-admission still waits for
    #:                             health + smoke probes
    smoke_obs: int = 0          #: smoke-probe window length (obs_len);
    #:                             0 disables the predict smoke probe
    #:                             (re-admission gates on /healthz alone)
    smoke_nodes: int = 0        #: smoke-probe zone count (N)

    # --- SLO-burn autoscaling ---
    autoscale: bool = False     #: drive spawn/retire from the burn-rate
    #:                             engine (obs/perf/slo.py) over the
    #:                             router's own p99
    slo_p99_ms: float = 250.0   #: router-side p99 objective feeding the
    #:                             burn-rate engine
    scale_up_after: int = 2     #: consecutive BURNING ticks before a
    #:                             spawn (hysteresis)
    scale_down_after: int = 6   #: consecutive OK ticks before a retire
    scale_cooldown_ticks: int = 3  #: ticks any scaling action freezes
    #:                             the controller (no flapping)

    # --- observability ---
    ledger_max_bytes: int = 8_000_000  #: routing-ledger jsonl rotation

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas={self.min_replicas} must "
                             f"be >= 1")
        if not (self.min_replicas <= self.replicas <= self.max_replicas):
            raise ValueError(
                f"need min_replicas <= replicas <= max_replicas, got "
                f"{self.min_replicas} <= {self.replicas} <= "
                f"{self.max_replicas}")
        if self.replica_set_size < 0:
            raise ValueError(f"replica_set_size={self.replica_set_size} "
                             f"must be >= 0 (0 = all replicas)")
        if self.failover_attempts < 1:
            raise ValueError(f"failover_attempts="
                             f"{self.failover_attempts} must be >= 1")
        if self.breaker_threshold < 0:
            raise ValueError(f"breaker_threshold="
                             f"{self.breaker_threshold} must be >= 0 "
                             f"(0 = breaker off)")
        positives = ("probe_interval_s", "probe_timeout_s",
                     "connect_timeout_s", "ready_timeout_s",
                     "drain_timeout_s", "slo_p99_ms")
        for name in positives:
            if getattr(self, name) <= 0:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f"> 0")
        non_negatives = ("breaker_cooldown_s", "deadline_ms",
                         "smoke_obs", "smoke_nodes", "ledger_max_bytes",
                         "scale_cooldown_ticks")
        for name in non_negatives:
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 0")
        if (self.smoke_obs > 0) != (self.smoke_nodes > 0):
            raise ValueError("smoke_obs and smoke_nodes must be set "
                             "together (both > 0 enables the predict "
                             "smoke probe)")
        for name in ("scale_up_after", "scale_down_after"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 1")

    def replace(self, **kw) -> "RouterConfig":
        return dataclasses.replace(self, **kw)
