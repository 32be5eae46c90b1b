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
resilience/faults.py; the serving plane runs its arms). Knobs of paths
this port does not have yet (meshes, the orbax checkpoint backend) are
not here; they arrive with the slices that run them. ``DEFAULT_SLOS``
are the serving plane's objectives (obs/perf/slo.py). The BDGCN arm is not a config
field: it is the ``bdgcn_impl`` argument of ``ModelTrainer`` and
``ServeEngine``.
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
    loss_scaling: str = "auto"              # none | dynamic | auto: the
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
