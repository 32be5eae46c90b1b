"""Training and evaluation of MPGCN (counterpart of the single-device
paths of mpgcn_tpu/train/trainer.py: the epoch-scan executor and the
per-step loop).

``ModelTrainer.train`` runs the reference epoch loop (Model_Trainer.py:
87-142): a per-step update on the masked batch loss (Adam, after the
global-norm clip ``cfg.clip_norm``, at the rate of ``cfg.lr_schedule``
over the run's steps), a validation pass per epoch on the inference
kernels under ``torch.no_grad()``, a checkpoint at epoch 0 and on every
non-worsening validation loss, and early stopping after
``early_stop_patience`` epochs without one; given the ``DataInput`` that
loaded the data (``data_container``), the checkpoint records its
normalizer's kind and state. Checkpoints are written by one background
thread (``utils/atomic.py`` ``AsyncWriter``) from one host copy of the
state an epoch, off the epoch loop; ``train`` returns, and anything that
reads a checkpoint back reads it, only after they reach the disk.

Each epoch of a mode runs on one of three executors (``_epoch_exec``, as
the JAX trainer dispatches them, printed on the ``[dispatch]
epoch_exec:`` line). ``scan`` (the default, ``cfg.epoch_scan``, for a
mode whose windows fit ``cfg.epoch_scan_max_mb``) keeps the mode's
windows on the device, gathers each step's rows there from the epoch
index, writes each step's loss into a device buffer and reads the
buffer once at the end of the epoch: one host sync per epoch. On the
card its train step (forward, backward, clip, Adam) and eval step are
each captured once as a CUDA graph (train/graphs.py) after two eager
warm-up steps, which are the epoch's first real steps, and replayed for
every step after; on the CPU and on the ELL arm they run eagerly
(graphs.py ``refusal``). ``stream`` (a mode over the budget, with
``cfg.epoch_stream``) splits the epoch index into chunks of steps that
fit ``cfg.stream_chunk_mb``: the pipeline gathers chunk k+1 on a
background thread (into pinned memory on the card) and the trainer
copies it to the device on a side stream while chunk k computes; each
chunk is copied into the mode's static chunk buffer, whose steps run
the same step (the same captured graph per mode, or eagerly) as the
scan executor's, so the two give the same bits; at most two chunk
buffers are on the device, the host waits once a chunk (the pacing:
chunk k-1 done before chunk k starts) and reads the losses once at the
end. ``per_step`` (``epoch_scan=False``, or ``epoch_stream=False`` for
a mode over the budget) copies each batch from the host and reads each
loss back. All three run the same arithmetic, so they give the same
bits. ``test`` reloads the checkpoint, rolls out
``pred_len`` steps and appends its scores to
``<output_dir>/MPGCN_prediction_scores.txt``, in the model's space or,
with ``denormalize``, in the normalizer's input space. On the card every
step goes through the hand-written kernels (``lstm_impl`` "kernel",
``bdgcn_impl`` "kernel" or "ell"); the plain arms ("plain"/"einsum")
compute the same function with stock PyTorch operations.
``bdgcn_impl="auto"`` (the default) is resolved once by the data pipeline
from the measured support density: "ell" for large sparse graphs, else
"kernel".

The self-healing loop (the JAX trainer's ``train``/``_train_loop``):
- step sentinels (``cfg.step_sentinels``): ``ChainAdam`` undoes a step
  whose loss, weights or Adam state went non-finite inside the step (the
  captured one too) and marks its loss NaN; the epoch's one read counts
  the skips, averages over the kept steps and, past
  ``cfg.skip_budget``, declares the epoch bad;
- ``cfg.grad_accum`` = k: each step runs k interleaved chunks (rows j,
  j + k, ...), masked by their global batch position, sums their losses
  and gradients, divides by the batch size once and updates once;
- multi-step training: a target of ``pred_len`` > 1 frames trains through
  the differentiable rollout (``predict.rollout_train``);
- the dead-init probe after the first trained epoch (or on one batch's
  gradient under weight decay) with ``cfg.on_dead_init`` warn / error /
  retry, the retry reseeding from ``seed + 100003``;
- ``train(resume=True)``: the rolling ``<model>_od_last.pkl`` (weights,
  Adam's state, best validation loss, patience, step) written every
  epoch, then the best-on-val file, then scratch; the shuffle stream
  replayed; SIGTERM / SIGINT finish the epoch, save and return;
- a bad epoch is quarantined to a postmortem checkpoint, the last good
  one restored, and (``cfg.rollback_retries``) retried at a backed-off
  rate;
- the hang watchdog (``cfg.watchdog_secs``), fed one host copy of the
  state per epoch only when armed;
- the jsonl run log, with the JAX event names.

Precision (the JAX trainer's ``_loss_scaling`` and ``_inference_params``;
its ``_infer_precision`` is ``cfg.resolved_infer_precision`` here, its
``_infer_compute_dtype`` ``nn.mpgcn.infer_dtype_of``): ``cfg.dtype =
"bfloat16"`` trains and evaluates with bf16 compute on the f32 master
weights, through the kernels' bf16 forms (nn/mpgcn.py casts inside the
forward), and with ``cfg.loss_scaling`` (auto: on for bf16) the dynamic
loss scaler: the loss
is scaled before ``backward`` and the optimizer unscales, skips and
rescales inside the (captured) step (quant/scaling.py); its scale and
skips go into the epoch event of the jsonl log. ``cfg.remat`` checkpoints
each branch of the training forwards (per rollout step under multi-step
training). The rollouts of test and predict run at ``cfg.infer_precision``
(auto: the training dtype): f32, bf16, or int8 weight-only on the
per-channel quantized tree, made once per weights version and refilled in
place, so the captured rollouts that read it stay valid; each precision
has its own captured rollouts.

Fault injection (``cfg.faults``, resilience/faults.py; the JAX trainer's
arms): ``nan_step`` NaNs the inputs of one train step on every executor
(the per-step batch, the scan executor's device rows of that step for
the epoch, the stream chunk's rows at gather time), so a captured step
replays the poisoned window; ``sigterm_epoch`` delivers SIGTERM inside
the epoch (after the first per-step step, before the scan epoch, after
the first stream chunk); ``hang_epoch`` sleeps at the epoch's start,
which the armed watchdog turns into exit 113; ``ckpt_trunc`` tears the
K-th checkpoint written, after the background writer wrote it; and
``io_errors`` ride the data reads (data/loader.py, the pipeline's
gathers). Of the multi-host arms, ``kill_host_epoch`` SIGKILLs the rank
``fault_host`` of a data-parallel run at the start of its epoch;
``straggle_host`` and ``wedge_collective`` wait for the liveness slice.

``warm_start(path)`` is the continual-learning daemon's start
(service/daemon.py): the checkpoint's weights, a fresh optimizer, in
place. ``close()`` releases the trainer's CUDA graphs and their pool, so
a long-lived process that makes a trainer per retrain does not grow.

The telemetry (the JAX trainer's ``_init_obs``, ``cfg.obs_metrics``): the
trainer's series in the default metrics registry (obs/metrics.py) --
step latency on the per-step executor, steps/sec, sentinel skips,
rollbacks, epoch seconds, the stream overlap, the support-bank gauges
(nnz, density, sparse arm, pad width, resident bytes), the loss scale and
its skips, the int8 round-trip error -- with ``cuda_program_builds`` in
place of the JAX compile hook's ``jax_compiles``, the train-plane SLOs
ticked once an epoch, and the registry's snapshot under ``metrics`` in
each epoch event; ``-no-obs`` turns all of it off. Every step (each
executor's) runs inside ``utils.profiling.step_annotation``, a
``record_function`` only while a ``-trace`` window records. The trainer
enables the kernel-library directory ``cfg.compile_cache_dir``
(obs/perf/compile_cache.py) before it builds anything.

Data-parallel training (parallel/trainer.py ``ParallelModelTrainer``)
runs this loop on every rank of a process group, through the hooks this
class keeps as no-ops or one-process answers: the rows' global offset
``_row0`` in the masked loss, ``_reduce_step`` (the all-reduce of each
step's gradients and loss, and of each eval loss), ``_agree`` (the
dead-init probes' verdicts), ``_vote_preempted``, ``_ckpt_exists``
(rank 0's answer), ``_files_settled`` (the checkpoint writer flushed and,
on a group, every rank past it), ``_local_cols`` (the stream executor's
batch columns), ``_rollout_batch`` (test mode's forecasts) and
``_manifest``; rank 0 (``rank``) alone writes checkpoints, the run log,
the score file and the watchdog's emergency state.
``cfg.consistency_check_every`` = k digests the weights, Adam's state and
the banks every k epochs after the train mode, before the validate mode
saves (resilience/consistency.py); a divergence goes through the bad-epoch
rollback. ``cfg.checkpoint_backend`` "orbax" writes the directory form
(train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import signal
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import MPGCNConfig, default_slos
from mpgcn_tpu_torch.data.pipeline import Batch, DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.mpgcn import MPGCN, infer_dtype_of
from mpgcn_tpu_torch.obs.metrics import default_registry, program_builds
from mpgcn_tpu_torch.obs.perf import compile_cache
from mpgcn_tpu_torch.obs.perf.slo import SLOEngine
from mpgcn_tpu_torch.quant.int8 import (
    quantization_error,
    quantize_params,
    requantize_,
)
from mpgcn_tpu_torch.resilience.consistency import (
    ReplicaDivergenceError,
    check_replica_consistency,
)
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.resilience.rollback import (
    RollbackSignal,
    emergency_path,
    postmortem_path,
)
from mpgcn_tpu_torch.resilience.watchdog import HangWatchdog
from mpgcn_tpu_torch.train import metrics
from mpgcn_tpu_torch.train.checkpoint import (
    OPT_STATE_KEY,
    CheckpointCorruptError,
    adam_state_from_jax,
    checkpoint_exists,
    checkpoint_payload,
    load_checkpoint,
    load_opt_state,
    opt_state_to_host,
    topology_manifest,
    write_checkpoint,
)
from mpgcn_tpu_torch.train.graphs import (
    GraphSet,
    Precision,
    RolloutGraphs,
    refusal,
)
from mpgcn_tpu_torch.train.objectives import (
    elementwise_loss,
    lr_at,
    make_optimizer,
)
from mpgcn_tpu_torch.train.predict import graphs_for, rollout, rollout_train
from mpgcn_tpu_torch.tune.registry import device_platform, resolve_knob
from mpgcn_tpu_torch.utils.atomic import AsyncWriter
from mpgcn_tpu_torch.utils.convert import params_from_jax, params_to_jax
from mpgcn_tpu_torch.utils.logging import RunLogger, run_log_path
from mpgcn_tpu_torch.utils.profiling import step_annotation

#: train steps left out of steps/sec (the first ones build the kernels);
#: on the card the scan executor runs as many eager steps of each mode
#: before it captures that mode's step
WARMUP_STEPS = 2

#: offset between reseed attempts (JAX: ``_RESEED_STRIDE``): large and
#: prime, so the retry seeds of neighbouring base seeds never collide
_RESEED_STRIDE = 100003


class DeadInitError(RuntimeError):
    """A run's initialization cannot train (zero gradient everywhere).
    Raised under on_dead_init='error', and under 'retry' (caught by
    ``train``'s reseed loop)."""


class _Epoch:
    """One mode's state on the scan or stream executor: its device-resident
    windows (xs, ys, keys; on the stream executor the static buffer that
    each chunk is copied into), the static (S, B) index and (S,) sizes an
    epoch reads,
    the (S,) step losses it writes, the device step counter ``t`` (the
    buffers a captured step reads and writes), and how many eager
    warm-up steps of the mode have run."""

    def __init__(self, data: tuple, S: int, B: int, device):
        self.xs, self.ys, self.keys = data
        self.idx = torch.zeros((S, B), dtype=torch.long, device=device)
        self.sizes = torch.zeros((S,), dtype=torch.float32, device=device)
        self.losses = torch.zeros((S,), dtype=torch.float32, device=device)
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.warm = 0
        self._host = ()

    def load(self, idx: np.ndarray, sizes: np.ndarray) -> None:
        """Upload an epoch's index and sizes and set t to 0, without a
        host sync: from pinned memory on the card (kept alive here until
        the next epoch, whose start follows this one's read)."""
        host = (torch.from_numpy(idx.astype(np.int64)),
                torch.from_numpy(sizes.astype(np.float32)))
        if self.idx.is_cuda:
            host = tuple(h.pin_memory() for h in host)
        self._host = host
        self.idx.copy_(host[0], non_blocking=True)
        self.sizes.copy_(host[1], non_blocking=True)
        self.t.zero_()

    def gather(self):
        """Step t's batch and size, gathered on the device."""
        rows = self.idx.index_select(0, self.t).view(-1)
        return (self.xs.index_select(0, rows), self.ys.index_select(0, rows),
                self.keys.index_select(0, rows),
                self.sizes.index_select(0, self.t).view(()))

    def record(self, loss: torch.Tensor) -> None:
        """Write step t's loss into its slot and advance t."""
        self.losses.index_copy_(0, self.t, loss.detach().view(1))
        self.t += 1


def epoch_mean(losses: np.ndarray, sizes: np.ndarray,
               sentinel: bool = False) -> float:
    """The size-weighted mean of an epoch's step losses (the JAX trainer's
    ``losses @ sizes`` over ``sizes.sum()``); with ``sentinel``, over the
    kept (finite) steps only, NaN when every step was skipped."""
    if sentinel:
        ok = np.isfinite(losses)
        count = int(sizes[ok].sum())
        return float(losses[ok] @ sizes[ok]) / count if count \
            else float("nan")
    return float(losses @ sizes) / max(int(sizes.sum()), 1)


def _count_spikes(losses: np.ndarray, factor: float) -> int:
    """Steps whose (finite) loss exceeds ``factor`` x the previous one's
    (JAX: ``_count_spikes``); 0 when factor is 0."""
    if factor <= 0 or losses.size < 2:
        return 0
    return int(np.sum(losses[1:] > factor * losses[:-1]))


def _banner(msg: str):
    print("\n", datetime.now().strftime("%Y/%m/%d %H:%M:%S"))
    print(msg)


def _has_opt_state(ckpt: dict) -> bool:
    return OPT_STATE_KEY in ckpt or "opt_state" in ckpt


class ModelTrainer:
    """The model, its optimizer and the support banks on ``device``
    (default the card; the CPU only when asked)."""

    #: this process's rank of a data-parallel world, its process group
    #: (None: one process) and the global batch position of its first row
    rank = 0
    process_group = None
    _row0 = 0
    #: the process subgroup of this rank's model group (parallel/:
    #: None where the model axis has one rank)
    model_group = None

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 lstm_impl: str = "kernel", bdgcn_impl: str = "auto",
                 data_container=None, pipeline: Optional[DataPipeline] = None):
        if cfg.model != "MPGCN":
            raise NotImplementedError("Invalid model name.")
        self.device = resolve_device(device)
        # the kernel-library directory, before anything is built
        compile_cache.enable(cfg.compile_cache_dir or None)
        #: the checkpoint manifest's platform
        self._platform = "gpu" if self.device.type == "cuda" else "cpu"
        if pipeline is None:
            pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        elif pipeline.device != self.device:
            raise ValueError(f"the pipeline's device {pipeline.device} is "
                             f"not the trainer's {self.device}")
        self.pipeline = pipeline
        if cfg.num_nodes == 0:
            cfg = cfg.replace(num_nodes=self.pipeline.num_nodes)
        self.cfg = cfg
        self.data_container = data_container
        self.banks = self.pipeline.banks
        self.bdgcn_impl = self.pipeline.bdgcn_impl
        self.model = MPGCN.from_config(cfg, device=self.device,
                                       lstm_impl=lstm_impl,
                                       bdgcn_impl=self.bdgcn_impl)
        print(self.pipeline.dispatch_line(lstm_impl))
        self._total_steps = (self.pipeline.num_batches("train")
                             * cfg.num_epochs)
        self.optimizer = make_optimizer(
            cfg.optimizer, self.model.parameters(), cfg.learn_rate,
            cfg.decay_rate, clip_norm=cfg.clip_norm,
            lr_schedule=cfg.lr_schedule, total_steps=self._total_steps,
            sentinels=cfg.step_sentinels, loss_scaling=self._loss_scaling,
            loss_scale_init=cfg.loss_scale_init,
            loss_scale_growth_interval=cfg.loss_scale_growth_interval,
            loss_scale_min=cfg.loss_scale_min)
        #: the int8 tree of -infer-precision int8, its weights version and
        #: its round-trip error (``_inference_params``)
        self._quant = self._quant_version = None
        self.quant_max_abs_error = 0.0
        #: bumped wherever the weights are replaced (load, reseed), beside
        #: the optimizer's update count: a weights version
        self._weights_gen = 0
        self.global_step = 0
        #: steps run, by kind: train and eval steps (every executor), and
        #: the model forwards of the rollouts (``predict``): what a
        #: caller multiplies a step's launches by
        self.step_counts = {"train": 0, "eval": 0, "rollout": 0}
        self._clock = None  # (time, step) once the warm-up steps are done
        # the self-healing loop's state
        self._dead_init_detected = False  # set by the probe or a resume
        self._rollback_attempts = 0       # bad-epoch retries taken
        self._watchdog: Optional[HangWatchdog] = None  # armed in train()
        self._preempted = self._sigint_seen = False
        self._exec_logged = False         # the dispatch line, once a run
        self._writer = AsyncWriter()      # checkpoints, off the loop
        self._faults = FaultPlan.from_config(cfg)
        self._epoch = 0  # the epoch running (the sigterm fault's key)
        #: ms of each update of the armed watchdog's host state (one an
        #: epoch; the epoch's checkpoint snapshot where it has one)
        self.watchdog_sync_ms: list[float] = []
        # the scan executor's per-mode state, and the graphs of this
        # trainer (None where graphs.refusal names a reason)
        self._epochs: dict[str, _Epoch] = {}
        #: the stream executor's side stream for uploads (made on first
        #: use, on the card) and its counters of the last epoch, by mode
        self._copy_stream = None
        self._stream_stats: dict = {}
        self.graph_refusal = refusal(self.device, self.bdgcn_impl,
                                     self.process_group, self.model_group)
        self._graphs = (None if self.graph_refusal else
                        GraphSet(self.device, self.bdgcn_impl))
        self._rollouts = (None if self._graphs is None else
                          RolloutGraphs(self._graphs, self.model, self.banks))
        self._graph_ptrs = self._state_ptrs()
        self._init_obs()

    # --- telemetry -------------------------------------------------------

    def _init_obs(self) -> None:
        """The trainer's series in the process default registry (the JAX
        trainer's ``_init_obs``): what the ``-metrics-port`` sidecar, the
        epoch events' snapshot and the flight recorder read. Under
        ``-no-obs`` every handle stays None and the loop pays nothing."""
        self._m_step_ms = self._m_sps = self._m_skipped = None
        self._m_rollbacks = self._m_epoch_s = self._m_overlap = None
        self._m_quant_err = self._m_loss_scale = None
        self._m_scaler_skipped = None
        self._slo = None
        self._scaler_skipped_seen = 0  # the counter takes deltas
        if not self.cfg.obs_metrics:
            return
        program_builds()  # the JAX compile hook's counterpart, registered
        reg = default_registry()
        self._m_step_ms = reg.histogram(
            "train_step_latency_ms", "per-step wall latency, dispatch to "
            "host sync (per-step executor only: the scan and stream "
            "executors read their losses once an epoch)")
        self._m_sps = reg.gauge(
            "train_steps_per_sec", "post-warmup steps/sec (the first "
            "WARMUP_STEPS train steps left out)")
        self._m_skipped = reg.counter(
            "train_sentinel_skipped_steps", "train steps the step "
            "sentinels undid")
        self._m_rollbacks = reg.counter(
            "train_rollbacks", "bad-epoch rollback retries taken")
        self._m_epoch_s = reg.histogram(
            "train_epoch_seconds", "wall seconds per epoch (all modes)",
            buckets=(0.1, 0.5, 1, 5, 15, 60, 300, 1800))
        self._m_overlap = reg.gauge(
            "train_stream_overlap_pct", "chunked-stream feed overlap "
            "(100 = host gather fully hidden under device compute)")
        # the support banks, set once here: no cost on the loop
        stats = self.pipeline.support_stats()
        pad = 0
        if self.bdgcn_impl == "csr":
            pad = max(b.pad_width for b in self.banks.values())
        for name, help_, v in (
                ("graph_support_nnz", "nonzeros across all support banks",
                 self.pipeline.support_nnz),
                ("graph_support_density", "support-bank density (nnz/"
                 "size); -bdgcn auto takes the sparse arm at or below "
                 "cfg.sparse_density_threshold",
                 round(self.pipeline.support_density, 6)),
                ("bdgcn_sparse_active", "1 when the resolved BDGCN arm is "
                 "a sparse one (csr/ell), else 0",
                 1.0 if self.bdgcn_impl in ("csr", "ell") else 0.0),
                ("graph_support_pad_width", "padded-CSR pad width R (0 for "
                 "dense banks and blocked-ELL)", pad),
                ("graph_support_resident_bytes", "device-resident "
                 "support-bank bytes as stored (containers count their "
                 "index, values or codes and scales)",
                 stats["resident_bytes"])):
            reg.gauge(name, help_).set(float(v))
        self._m_loss_scale = reg.gauge(
            "train_loss_scale", "current dynamic loss scale (1 when "
            "scaling is off)")
        self._m_loss_scale.set(self.cfg.loss_scale_init
                               if self._loss_scaling else 1.0)
        self._m_scaler_skipped = reg.counter(
            "train_loss_scale_skipped_steps", "train steps the loss "
            "scaler skipped on non-finite scaled grads (not counted "
            "against the sentinels' skip_budget)")
        self._m_quant_err = reg.gauge(
            "quant_max_abs_error", "max-abs int8 weight round-trip error "
            "of the most recent quantization (0 until int8 inference is "
            "used)")
        # the train plane's objectives, ticked at epoch ends only
        self._slo = SLOEngine(default_slos("train"), [reg],
                              output_dir=self.cfg.output_dir,
                              min_tick_interval_s=0.0)

    def _epoch_obs(self, scaler: dict, skipped: int, epoch_s: float) -> dict:
        """The epoch's series, then the SLO tick; returns the epoch
        event's ``metrics`` entry (empty under -no-obs)."""
        if self._m_sps is None:
            return {}
        if scaler:
            self._m_loss_scale.set(scaler["scale"])
            delta = scaler["skipped_steps"] - self._scaler_skipped_seen
            if delta > 0:
                self._m_scaler_skipped.inc(delta)
            self._scaler_skipped_seen = scaler["skipped_steps"]
        self._m_sps.set(round(self.steps_per_sec(), 3))
        self._m_epoch_s.observe(epoch_s)
        if skipped:
            self._m_skipped.inc(skipped)
        st = self._stream_stats.get("train")
        if st:
            self._m_overlap.set(st["overlap_pct"])
        self._slo.tick()
        return {"metrics": default_registry().snapshot()}

    # --- precision -------------------------------------------------------

    @property
    def _loss_scaling(self) -> bool:
        """Dynamic loss scaling on? 'auto' follows the compute dtype: on
        for bf16, off for f32 (whose optimizer and numerics stay exactly
        as without a scaler)."""
        if self.cfg.loss_scaling == "dynamic":
            return True
        return (self.cfg.loss_scaling == "auto"
                and self.cfg.dtype == "bfloat16")

    def _weights_version(self) -> tuple:
        return (self.optimizer.count, self._weights_gen)

    def _inference_params(self):
        """The weights the rollouts run on: None (the model's own), or
        under int8 the per-channel quantized tree, quantized again (in
        place) only when the weights version moved since."""
        if self.cfg.resolved_infer_precision != "int8":
            return None
        params = dict(self.model.named_parameters())
        if self._quant is None:
            self._quant = quantize_params(params)
        elif self._quant_version != self._weights_version():
            requantize_(self._quant, params)
        else:
            return self._quant
        self._quant_version = self._weights_version()
        self.quant_max_abs_error = quantization_error(
            params, self._quant)["max_abs_error"]
        if self._m_quant_err is not None:
            self._m_quant_err.set(self.quant_max_abs_error)
        return self._quant

    def _precision(self) -> Precision:
        """The rollouts' precision, with its int8 tree where it has one."""
        return Precision(self.cfg.resolved_infer_precision,
                         infer_dtype_of(self.cfg), self._inference_params())

    # --- one step --------------------------------------------------------

    def _tensors(self, batch: Batch):
        return (torch.from_numpy(np.ascontiguousarray(batch.x)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(batch.y)).to(
                    self.device),
                torch.from_numpy(batch.keys.astype(np.int64)).to(
                    self.device))

    def _masked_sum_loss(self, x, y, keys, size, pos=None,
                         inference: bool = False) -> torch.Tensor:
        """The SUM of the per-sample f32 mean losses over this batch (or
        chunk of it), masked to the rows whose global batch position
        ``pos`` (default arange) is below ``size`` (an int, or an f32
        device scalar where a replayed step reads it; the rest
        repeat-pad the batch). A target of more than one frame is the
        multi-step objective: the rollout over ``y``'s frames (JAX:
        ``_masked_sum_loss``)."""
        if y.shape[1] > 1 and inference:
            pred = rollout(self.model, self.banks, x, keys, y.shape[1])
        else:
            graphs = graphs_for(self.banks, keys, self.model.sources)
            pred = (rollout_train(self.model, graphs, x, y.shape[1])
                    if y.shape[1] > 1 else
                    self.model(x, graphs, inference=inference))
        if pred.shape != y.shape:
            raise ValueError(f"prediction shape {tuple(pred.shape)} != "
                             f"target shape {tuple(y.shape)}")
        per_sample = self._per_sample(elementwise_loss(self.cfg.loss,
                                                       pred, y))
        if pos is None:
            pos = self._row0 + torch.arange(pred.shape[0], device=pred.device)
        return (per_sample * (pos < size).float()).sum()

    def _per_sample(self, elems: torch.Tensor) -> torch.Tensor:
        """(B,) per-sample means of a (B, ...) elementwise loss."""
        return elems.reshape(elems.shape[0], -1).mean(dim=1)

    def _real_origins(self, pred: torch.Tensor) -> torch.Tensor:
        """A (B, T, N, N, F) forecast on its real origin rows: all of
        them on one device."""
        return pred

    def _batch_loss(self, x, y, keys, size,
                    inference: bool = False) -> torch.Tensor:
        """The masked mean loss over the batch's ``size`` real rows: the
        reference's batch mean when there is no padding."""
        return self._masked_sum_loss(x, y, keys, size,
                                     inference=inference) / size

    def _loss_and_grads(self, x, y, keys, size) -> torch.Tensor:
        """Forward and backward of one train step, the gradients left in
        ``.grad``; returns the loss. With ``cfg.grad_accum`` = k > 1 (JAX:
        ``_train_step_fn``) the batch runs as k chunks, chunk j the rows
        j, j + k, j + 2k, ..., each masked by its rows' global positions:
        their loss sums and gradients add up, and both are divided by
        ``size`` once, so the step is the full batch's."""
        self.optimizer.zero_grad(set_to_none=True)
        # with the loss scaler the backward starts from the scale (JAX:
        # ``_loss_grads``); the loss returned is the unscaled one
        scaler = self.optimizer.scaler
        scaled = scaler.scale_loss if scaler is not None else (lambda v: v)
        k = self.cfg.grad_accum
        if k == 1:
            loss = self._batch_loss(x, y, keys, size)
            scaled(loss).backward()
            return loss.detach()
        pos = self._row0 + torch.arange(x.shape[0], device=x.device)
        total = None
        for j in range(k):
            part = self._masked_sum_loss(x[j::k], y[j::k], keys[j::k], size,
                                         pos[j::k])
            scaled(part).backward()
            total = part.detach() if total is None else total + part.detach()
        torch._foreach_div_([p.grad for p in self.optimizer.all_params()
                             if p.grad is not None], size)
        return total / size

    def _reduce_step(self, loss: torch.Tensor,
                     grads: bool = True) -> torch.Tensor:
        """The step's loss (and, with ``grads``, the gradients in ``.grad``)
        summed over the ranks of a data-parallel run; one process: as it
        is. Called between the backward and the update, so the clip, the
        sentinels and the loss scaler judge the same numbers on every
        rank, and on every eval loss."""
        return loss

    def _agree(self, flag: bool) -> bool:
        """``flag`` true on every rank (one process: ``flag``)."""
        return flag

    def _size(self, batch: Batch) -> torch.Tensor:
        """The batch's size as the f32 device scalar the scan executor
        gathers, so both executors divide alike."""
        return torch.tensor(float(batch.size), device=self.device)

    def _start_clock(self) -> None:
        """Start steps/sec when a train step begins after WARMUP_STEPS
        of them, at a synchronised point (the host may run ahead of the
        device)."""
        if self._clock is None and self.global_step >= WARMUP_STEPS:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._clock = (time.perf_counter(), self.global_step)

    def train_step(self, batch: Batch) -> float:
        """One optimizer update on ``batch`` (the clip, if any, and the
        sentinel inside ``optimizer.step``); returns its loss, NaN where
        the sentinel undid the step. The per-step executor."""
        self._start_clock()
        t0 = time.perf_counter() if self._m_step_ms is not None else 0.0
        with step_annotation(self.global_step):
            x, y, keys = self._tensors(batch)
            loss = self._reduce_step(self._loss_and_grads(
                x, y, keys, self._size(batch)))
            loss = self.optimizer.step(loss)
        self.global_step += 1
        self.step_counts["train"] += 1
        out = float(loss)
        if self._m_step_ms is not None:
            # after the host read, so the window covers the device's work
            self._m_step_ms.observe((time.perf_counter() - t0) * 1e3)
        return out

    def eval_step(self, batch: Batch) -> float:
        self.step_counts["eval"] += 1
        with step_annotation(self.step_counts["eval"], "eval_step"):
            x, y, keys = self._tensors(batch)
            return float(self._reduce_step(self._batch_loss(
                x, y, keys, self._size(batch), inference=True), grads=False))

    # --- the scan executor -----------------------------------------------

    def _mode_bytes(self, mode: str) -> float:
        """MB of the mode's epoch tensors, x + y + keys, at the padded
        (S*B-row) epoch width (JAX: ``_mode_bytes``)."""
        md = self.pipeline.modes[mode]
        n = max(len(md), 1)
        bs = self.cfg.batch_size
        rows = -(-n // bs) * bs  # repeat-padded final batch included
        per_row = (md.x.nbytes + md.y.nbytes + md.keys.nbytes) / n
        return rows * per_row / 1e6

    def _knob(self, name: str):
        """A tunable config knob, explicit > tuned profile of this
        device's platform > guessed default (tune/registry.py)."""
        return resolve_knob(self.cfg, name, device_platform(self.device))

    def _epoch_exec(self, mode: str) -> str:
        """The three-way dispatch (JAX: ``_epoch_exec``): 'scan' when
        ``cfg.epoch_scan`` is on and the mode fits the resolved
        ``epoch_scan_max_mb``; over it 'stream', or 'per_step' when
        ``cfg.epoch_stream`` is off; 'per_step' without the epoch scan."""
        if not self.cfg.epoch_scan:
            return "per_step"
        if self._mode_bytes(mode) <= self._knob("epoch_scan_max_mb"):
            return "scan"
        return "stream" if self.cfg.epoch_stream else "per_step"

    def _chunk_budget_mb(self) -> float:
        """The stream executor's device budget per chunk: the resolved
        ``stream_chunk_mb``, else ``epoch_scan_max_mb``; when both are 0
        (the force-every-mode-onto-the-stream idiom) the stock scan
        budget, not 1-step chunks (JAX: ``_chunk_budget_mb``)."""
        budget = (self._knob("stream_chunk_mb")
                  or self._knob("epoch_scan_max_mb"))
        if budget <= 0:
            budget = MPGCNConfig.__dataclass_fields__[
                "epoch_scan_max_mb"].default
        return budget

    def _stream_steps_per_chunk(self, mode: str) -> int:
        md = self.pipeline.modes[mode]
        n = max(len(md), 1)
        per_row = (md.x.nbytes + md.y.nbytes + md.keys.nbytes) / n
        step_mb = self.cfg.batch_size * per_row / 1e6
        return max(1, int(self._chunk_budget_mb() / step_mb))

    def _stream_plan(self, mode: str) -> tuple:
        """(n_chunks, steps_per_chunk) of the mode's stream epochs."""
        spc = self._stream_steps_per_chunk(mode)
        return -(-self.pipeline.num_batches(mode) // spc), spc

    def _exec_line(self, plan: dict) -> str:
        """The ``[dispatch] epoch_exec:`` line, in the JAX format, with
        how the scan and stream executors run their steps here."""
        desc = ", ".join(
            f"{m}={e}" + ("({} chunks x {} steps)".format(
                *self._stream_plan(m)) if e == "stream" else "")
            for m, e in plan.items())
        line = (f"[dispatch] epoch_exec: {desc} (epoch_scan_max_mb="
                f"{self._knob('epoch_scan_max_mb')}, chunk budget "
                f"{self._chunk_budget_mb()} MB)")
        kinds = " and ".join(e for e in ("scan", "stream")
                             if e in plan.values())
        if kinds:
            line += (f"; {kinds} steps: CUDA graphs" if self._graphs else
                     f"; {kinds} steps: eager ({self.graph_refusal})")
        return line

    def _epoch_index(self, mode: str, shuffle: bool, rng):
        """(S, B) int32 gather indices + (S,) int32 sizes; the final
        batch repeats the epoch's last sample (masked out by size in the
        loss). The permutation ``pipeline.batches`` draws from ``rng``."""
        n = len(self.pipeline.modes[mode])
        bs = self.cfg.batch_size
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        S = -(-n // bs)
        pad = S * bs - n
        idx = np.concatenate(
            [order, np.full(pad, order[-1])]).reshape(S, bs).astype(np.int32)
        sizes = np.full((S,), bs, dtype=np.int32)
        sizes[-1] = n - (S - 1) * bs
        return idx, sizes

    def _local_windows(self, a: np.ndarray, axis: int = 2) -> np.ndarray:
        """``a``'s windows (origin nodes on ``axis``) as this process
        holds them: all of them here (parallel/trainer.py: a model axis's
        origin block)."""
        return a

    def _mode_device_data(self, mode: str) -> tuple:
        """Device-resident (xs, ys, keys int64) of a mode."""
        md = self.pipeline.modes[mode]
        return tuple(torch.from_numpy(np.array(a)).to(self.device) for a in (
            self._local_windows(md.x), self._local_windows(md.y),
            md.keys.astype(np.int64)))

    def _epoch_state(self, mode: str, B: Optional[int] = None) -> _Epoch:
        """The mode's executor state (B this process's rows a step, by
        default the batch), made on first use and cached."""
        if mode not in self._epochs:
            self._epochs[mode] = _Epoch(
                self._mode_device_data(mode), self.pipeline.num_batches(mode),
                B or self.cfg.batch_size, self.device)
        return self._epochs[mode]

    def _train_body(self, ep: _Epoch) -> None:
        """One train step of the scan executor, all on the device: what
        the train graph captures."""
        x, y, keys, size = ep.gather()
        ep.record(self.optimizer.update(self._reduce_step(
            self._loss_and_grads(x, y, keys, size))))

    def _eval_body(self, ep: _Epoch) -> None:
        x, y, keys, size = ep.gather()
        ep.record(self._reduce_step(
            self._batch_loss(x, y, keys, size, inference=True), grads=False))

    def _state_ptrs(self) -> tuple:
        """Where the weights, Adam's state, the rate table and the
        sentinel's buffers lie: what the captured graphs read and
        write."""
        opt = self.optimizer
        state = [v for st in opt.state.values() for v in st.values()
                 if torch.is_tensor(v)]
        guard = opt.guard.buffers() if opt.guard is not None else []
        scaler = opt.scaler.buffers() if opt.scaler is not None else []
        quant = [t for v in (self._quant or {}).values()
                 for t in ((v.q, v.scale) if hasattr(v, "q") else (v,))]
        return tuple(t.data_ptr() for t in (
            *self.model.parameters(), opt.lr_table, opt.lr_t, opt.step_t,
            *state, *guard, *scaler, *quant))

    def _check_storage(self) -> None:
        """Drop every captured graph when the weights, Adam's state, the
        rate table, the loss scaler's state or the int8 tree moved since
        the last capture or check: a graph reads them where they lay when
        it was captured. ``load_trained`` copies
        in place and keeps the graphs; a grown rate table or a module
        made anew moves them. Each graph is captured again at its next
        use."""
        ptrs = self._state_ptrs()
        if (self._graphs is not None and self._graphs.graphs
                and ptrs != self._graph_ptrs):
            print("[graphs] the weights, Adam's state or the rate table "
                  "moved: dropping the captured graphs")
            self._graphs.drop()
        self._graph_ptrs = ptrs

    def _exec_step(self, key: str, ep: _Epoch, is_train: bool) -> None:
        """Run one step of the scan or stream executor on ``ep``: eagerly
        without graphs; on the card the first WARMUP_STEPS steps on ``ep``
        eagerly on the graph set's side stream, then the capture of its
        graph ``key`` (the mode; '<mode>-stream' on the stream executor's
        buffers) and a replay per step."""
        body = self._train_body if is_train else self._eval_body
        graphs, g = self._graphs, None
        kind = "train" if is_train else "eval"
        with step_annotation(self.step_counts[kind], f"{kind}_step"):
            if graphs is not None and graphs.get(key) is None \
                    and ep.warm < WARMUP_STEPS:
                graphs.warmup(lambda: body(ep))
                ep.warm += 1
            else:
                if graphs is not None:
                    g = graphs.get(key)
                    if g is None:
                        g = graphs.capture(key, lambda: body(ep))
                        self._graph_ptrs = self._state_ptrs()
                if is_train:
                    self._start_clock()
                if g is None:
                    body(ep)
                else:
                    g.replay()
        self.step_counts[kind] += 1
        if is_train:
            self.global_step += 1

    def _dispatch_epoch(self, mode: str, shuffle: bool, rng,
                        is_train: bool):
        """Run one epoch of ``mode`` on the scan executor and return its
        (S,) device losses, not read yet, and its host sizes. No host
        sync once the mode's graph is captured."""
        idx, sizes = self._epoch_index(mode, shuffle, rng)
        idx = self._local_cols(idx)
        if is_train:
            self.optimizer.reserve(self.optimizer.count + len(sizes))
        self._check_storage()
        ep = self._epoch_state(mode, idx.shape[1])
        ep.load(idx, sizes)
        bad_steps = self._take_nan_steps(len(sizes), is_train)
        clean = None
        if bad_steps:
            # the fault: NaN the targeted steps' rows of the resident
            # windows in place for this epoch (a captured step reads them
            # where they lie) and put the clean rows back after it; a
            # step's rows belong to no other step of the epoch
            rows = torch.from_numpy(np.unique(
                idx[np.asarray(bad_steps)]).astype(np.int64)).to(self.device)
            clean = (rows, ep.xs.index_select(0, rows))
            ep.xs.index_fill_(0, rows, float("nan"))
        for _ in range(len(sizes)):
            self._exec_step(mode, ep, is_train)
        if clean is not None:
            ep.xs.index_copy_(0, *clean)
        if is_train:
            self.optimizer.advance(len(sizes))
        return ep.losses, sizes

    # --- the stream executor ---------------------------------------------

    def _local_cols(self, idx: np.ndarray) -> np.ndarray:
        """The columns of an epoch's (S, B) gather index whose rows this
        process reads on the scan executor and stages on the stream one
        (JAX: ``_chunk_batch_cols``): all of them here."""
        return idx

    def _stream_state(self, mode: str, spc: int, B: int) -> _Epoch:
        """The mode's stream state: a static device buffer of one chunk
        (spc * B windows, B this process's rows a step) that each chunk is
        copied into, and the epoch index, sizes and losses of a whole
        epoch."""
        key = f"{mode}-stream"
        if key not in self._epochs:
            md = self.pipeline.modes[mode]
            rows = spc * B
            x, y = (self._local_windows(a[:0]) for a in (md.x, md.y))
            buffers = (torch.zeros((rows,) + x.shape[1:],
                                   device=self.device),
                       torch.zeros((rows,) + y.shape[1:],
                                   device=self.device),
                       torch.zeros((rows,), dtype=torch.long,
                                   device=self.device))
            self._epochs[key] = _Epoch(buffers, self.pipeline.num_batches(
                mode), B, self.device)
        return self._epochs[key]

    def _place_chunk(self, chunk) -> tuple:
        """Start one host chunk's upload (JAX: ``_place_chunk``): on the
        card from its pinned buffers into new device buffers on the copy
        stream, without waiting, with the event that marks the copy done;
        on the CPU the chunk's arrays as tensors. Returns (x, y, keys,
        steps, event or None), x and y flat (steps * B, ...)."""
        steps, B = chunk.keys.shape
        flat = lambda a: a.reshape((steps * B,) + a.shape[2:])
        keys = torch.from_numpy(chunk.keys.reshape(-1).astype(np.int64))
        if self.device.type != "cuda":
            return (torch.from_numpy(flat(chunk.x)),
                    torch.from_numpy(flat(chunk.y)), keys, steps, None)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = [flat(t) for t in chunk.pinned] + [keys.pin_memory()]
        with torch.cuda.stream(self._copy_stream):
            dev = [torch.empty_like(t, device=self.device) for t in host]
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return (*dev, steps, done)

    def _host_wait(self, event) -> None:
        """The stream executor's pacing wait (JAX: ``block_until_ready``
        on chunk k-1 before chunk k is dispatched): its one host wait a
        chunk. The smoke counts these calls."""
        event.synchronize()

    def _dispatch_chunk(self, key: str, ep: _Epoch, placed: tuple,
                        is_train: bool):
        """Run one placed chunk's steps on ``ep`` without a host sync:
        the compute stream waits for the chunk's upload, copies it into
        the static buffer (the uploaded buffers are kept for the compute
        stream by ``record_stream`` and freed when it has read them),
        then runs the steps. Returns the event after its last step on the
        card (None on the CPU)."""
        x, y, keys, steps, done = placed
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in (x, y, keys):
                t.record_stream(cur)
        rows = x.shape[0]
        for buf, t in zip((ep.xs, ep.ys, ep.keys), (x, y, keys)):
            buf[:rows].copy_(t)
        for _ in range(steps):
            self._exec_step(key, ep, is_train)
        if done is None:
            return None
        end = torch.cuda.Event()
        end.record(torch.cuda.current_stream(self.device))
        return end

    def _run_epoch_stream(self, mode: str, shuffle: bool, rng,
                          is_train: bool):
        """One epoch of ``mode`` on the chunked-stream executor (JAX:
        ``_run_epoch_stream``): the background thread gathers chunk k+1
        while chunk k computes, its upload starts as soon as it is
        gathered, and the host waits for chunk k-1 to finish before it
        dispatches chunk k, so at most two chunk buffers are on the
        device (the static buffer computing, one staged) and one chunk
        is in flight. Watchdog beats and the sigterm fault ride chunk
        boundaries; the chunk
        counters go into ``_stream_stats[mode]``. Returns the (S,) device
        losses, not read yet, and the host sizes."""
        idx, sizes = self._epoch_index(mode, shuffle, rng)
        idx = self._local_cols(idx)
        S, B = idx.shape
        n_chunks, spc = self._stream_plan(mode)
        if is_train:
            self.optimizer.reserve(self.optimizer.count + S)
        self._check_storage()
        ep = self._stream_state(mode, spc, B)
        # step s reads rows (s mod spc) * B + j of the chunk buffer
        ep.load((np.arange(S)[:, None] % spc) * B + np.arange(B), sizes)
        key = f"{mode}-stream"
        stall = 0.0
        resident = max_resident = 0
        t_epoch = time.perf_counter()
        it = self.pipeline.stream_chunks(
            mode, idx, sizes, spc,
            poison_steps=self._take_nan_steps(S, is_train))
        cur = prev = None
        k = 0  # chunks dispatched
        try:
            t0 = time.perf_counter()
            host = next(it, None)
            stall += time.perf_counter() - t0  # the pipeline's fill too
            if host is not None:
                cur = self._place_chunk(host)
                host = None  # the host copy goes once its upload is queued
                resident = max_resident = 1
            while cur is not None:
                if k:
                    # chunk k-1 done (on the CPU it ran inside its
                    # dispatch): its buffer is free
                    if prev is not None:
                        self._host_wait(prev)
                    resident -= 1
                prev = self._dispatch_chunk(key, ep, cur, is_train)
                k += 1
                cur = None
                if is_train and k == 1 and self._faults.active:
                    # "mid-epoch": the first chunk's steps are dispatched
                    self._faults.maybe_sigterm(self._epoch)
                t0 = time.perf_counter()
                host = next(it, None)
                stall += time.perf_counter() - t0  # feed-starved time only
                if host is not None:
                    cur = self._place_chunk(host)  # k+1 uploads under k
                    host = None
                    resident += 1
                    max_resident = max(max_resident, resident)
                self._beat()
        finally:
            it.close()  # retire the staging thread on any exit
        if is_train:
            self.optimizer.advance(S)
        secs = time.perf_counter() - t_epoch
        self._stream_stats[mode] = {
            "chunks": n_chunks, "steps_per_chunk": spc,
            "max_resident_chunks": max_resident,
            "stall_secs": round(stall, 4),
            # the share of the epoch not starved on the host gather
            "overlap_pct": (round(100.0 * (1.0 - stall / secs), 2)
                            if secs > 0 else 100.0)}
        return ep.losses, sizes

    # --- the epoch loop --------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.cfg.output_dir, f"{self.cfg.model}_od.pkl")

    def _last_ckpt_path(self) -> str:
        """The rolling checkpoint, written every epoch (weights, Adam's
        state, the early-stop state): what ``train(resume=True)`` reads
        first. The best-on-val file stays the reference's artifact."""
        return os.path.join(self.cfg.output_dir,
                            f"{self.cfg.model}_od_last.pkl")

    @property
    def _is_writer(self) -> bool:
        """Does this process write the run's files (rank 0)?"""
        return self.rank == 0

    def _ckpt_exists(self, path: str) -> bool:
        """A checkpoint to load at ``path`` (on a group: rank 0's answer)."""
        return checkpoint_exists(path)

    def _files_settled(self) -> None:
        """Wait until every checkpoint written so far is on the disk (on a
        group: rank 0's, before any rank reads one)."""
        self._writer.flush()

    def _manifest(self) -> dict:
        """The topology manifest of this run's checkpoints."""
        return topology_manifest(self._platform)

    def _ckpt_extra(self, **kw) -> dict:
        extra = {"seed": self.cfg.seed,
                 "num_branches": self.cfg.num_branches,
                 "branch_sources": list(self.cfg.resolved_branch_sources),
                 "global_step": self.global_step, **kw}
        if self._dead_init_detected:
            # sticky in every later save and across resumes
            extra["dead_init"] = True
        if self.data_container is not None:
            norm = self.data_container.normalizer
            extra["normalizer"] = {"kind": norm.kind, "state": norm.state()}
        return extra

    def _snapshot(self, with_opt: bool = True) -> tuple:
        """Host copies of the weights (a JAX params tree) and of the
        optimizer state (or None): what a checkpoint and the watchdog
        keep."""
        return (params_to_jax(self.model.state_dict()),
                opt_state_to_host(self.model, self.optimizer)
                if with_opt else None)

    def _save(self, path: str, epoch: int, snap=None, **extra) -> None:
        """Write a checkpoint of ``snap`` (default: a snapshot now) on the
        background writer: the loop goes on while it reaches the disk;
        ``self._writer.flush()`` waits for it. Rank 0 alone writes."""
        if not self._is_writer:
            return
        params, opt = snap or self._snapshot()
        self._writer.write(path, checkpoint_payload(
            params, epoch, self._ckpt_extra(**extra), opt, self._platform,
            self._manifest()), dump=self._write_checkpoint)

    def _write_checkpoint(self, path: str, payload) -> None:
        """The writer thread's dump, then the ``ckpt_trunc`` fault: tear
        the K-th checkpoint written, as a crash mid-write would."""
        write_checkpoint(path, payload, self.cfg.checkpoint_backend)
        if self._faults.active:
            self._faults.maybe_truncate(path)

    def _save_last(self, epoch, best_val, best_epoch, patience_count,
                   snap=None):
        self._save(self._last_ckpt_path(), epoch, snap, best_val=best_val,
                   best_epoch=best_epoch, patience_count=patience_count)

    def _run_mode(self, mode: str, rng):
        """One pass over ``mode`` on the per-step executor: its step
        losses and sizes, as the scan executor returns them."""
        is_train = mode == "train"
        step = self.train_step if is_train else self.eval_step
        nan_local = self._take_nan_steps(self.pipeline.num_batches(mode),
                                         is_train)
        losses, sizes = [], []
        for step_i, batch in enumerate(self.pipeline.batches(
                mode, shuffle=self.cfg.shuffle and is_train, rng=rng,
                pad_to_full=True)):
            if step_i in nan_local:  # the injected data blowup
                batch = dataclasses.replace(
                    batch, x=np.full_like(batch.x, np.nan))
            losses.append(step(batch))
            sizes.append(batch.size)
            if is_train and step_i == 0 and self._faults.active:
                # "mid-epoch": after the first step landed
                self._faults.maybe_sigterm(self._epoch)
            self._beat()
        return np.array(losses, np.float32), np.array(sizes, np.int32)

    def _run_epoch(self, mode: str, exec_path: str, rng):
        """One epoch of ``mode`` on ``exec_path``: its (S,) step losses and
        sizes on the host. On the scan and stream executors the step
        losses are read once, here (JAX: ``_run_epoch_scan``)."""
        if exec_path == "per_step":
            return self._run_mode(mode, rng)
        is_train = mode == "train"
        if exec_path == "stream":
            losses, sizes = self._run_epoch_stream(
                mode, self.cfg.shuffle and is_train, rng, is_train)
        else:
            if is_train and self._faults.active:
                # one dispatch for the whole epoch (the stream executor
                # fires at its first chunk boundary instead)
                self._faults.maybe_sigterm(self._epoch)
            losses, sizes = self._dispatch_epoch(
                mode, self.cfg.shuffle and is_train, rng, is_train)
        return losses.cpu().numpy(), sizes

    def _take_nan_steps(self, n_steps: int, is_train: bool) -> tuple:
        """The fault hook (JAX: ``_take_nan_steps``): local indices of the
        next ``n_steps`` train steps whose inputs are NaN-poisoned
        (one-shot; () without an active plan)."""
        if not is_train or not self._faults.active:
            return ()
        return self._faults.take_nan_steps(self.global_step, n_steps)

    def steps_per_sec(self) -> float:
        """Training steps per second since the warm-up steps (0.0 before
        them)."""
        if self._clock is None:
            return 0.0
        dt = time.perf_counter() - self._clock[0]
        return (self.global_step - self._clock[1]) / dt if dt > 0 else 0.0

    # --- the self-healing loop -------------------------------------------

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    def _watchdog_sync(self, epoch: int, snap=None) -> None:
        """Give the armed watchdog the state after a finished epoch as host
        copies (``snap``, the epoch's checkpoint snapshot, when there is
        one; nothing when the watchdog is not armed), so its fire path
        never touches the card."""
        if self._watchdog is None:
            return
        if not self._is_writer:  # rank 0 alone keeps the emergency state
            self._watchdog.beat()
            return
        t0 = time.perf_counter()
        params, opt = snap or self._snapshot()
        self._watchdog.update_state(checkpoint_payload(
            params, epoch, self._ckpt_extra(emergency=True), opt,
            self._platform, self._manifest()))
        self.watchdog_sync_ms.append((time.perf_counter() - t0) * 1e3)

    def _first_batch(self):
        batch = next(self.pipeline.batches("train", pad_to_full=True))
        return (*self._tensors(batch), self._size(batch))

    def _dead_after_epoch(self, init_params) -> bool:
        """No parameter moved over the first trained epoch: a dead ReLU
        head's gradient is exactly zero, so Adam leaves every weight bit
        for bit (valid at decay_rate 0)."""
        return all(torch.equal(a, p.detach())
                   for a, p in zip(init_params, self.model.parameters()))

    def _first_batch_grad_zero(self) -> bool:
        """The decay runs' probe (weight decay moves the weights at a zero
        loss gradient): the first batch's loss-gradient global norm is
        exactly 0."""
        x, y, keys, size = self._first_batch()
        params = [p for p in self.model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(self._batch_loss(x, y, keys, size),
                                    params, allow_unused=True)
        sq = sum((g.float() ** 2).sum() for g in grads if g is not None)
        return self._agree(bool(torch.sqrt(torch.as_tensor(sq)) == 0))

    def _forward_all_zero(self) -> bool:
        """A dead head predicts exactly zero everywhere (the confirmation
        that rules out weights left unchanged by an update below their
        ulp)."""
        x, _, keys, _ = self._first_batch()
        pred = self.model(x, graphs_for(self.banks, keys,
                                        self.model.sources), inference=True,
                          dtype=infer_dtype_of(self.cfg))
        return self._agree(bool((self._real_origins(pred) == 0).all()))

    def _dead_init_msg(self, detail: str) -> str:
        return (f"dead initialization (seed {self.cfg.seed}): {detail} -- "
                f"the gradient is exactly zero (typically the final ReLU "
                f"head saturated at zero for every input) and training "
                f"cannot progress. Re-run with a different -seed.")

    def _handle_dead_init(self, msg: str, epoch, logger) -> None:
        logger.log("dead_init", epoch=epoch, seed=self.cfg.seed)
        if self.cfg.on_dead_init in ("error", "retry"):
            raise DeadInitError(msg)  # retry: caught by train()
        print(f"WARNING: {msg}")

    def _check_resumed_ckpt_dead(self, ckpt, logger) -> None:
        """A resumed checkpoint flagged dead: warn or raise, and keep the
        flag for every later save."""
        if ckpt.get("extra", {}).get("dead_init"):
            self._dead_init_detected = True
            self._handle_dead_init(
                self._dead_init_msg(
                    "the resumed checkpoint is flagged dead_init"),
                ckpt["epoch"], logger)

    def _reseed(self, seed: int) -> None:
        """A fresh draw of the port's own init from ``seed`` (on_dead_init=
        'retry'), copied into the live weights, and a fresh optimizer
        state, both in place, so the captured steps stay valid."""
        self.cfg = self.cfg.replace(seed=seed)
        fresh = MPGCN.from_config(self.cfg, device="cpu",
                                  lstm_impl=self.model.lstm_impl,
                                  bdgcn_impl=self.bdgcn_impl)
        self.model.load_state_dict(fresh.state_dict())
        self.optimizer.reset()
        self._weights_gen += 1
        self._dead_init_detected = False

    def _try_load_ckpt(self, path: str, logger=None):
        """``load_trained`` that takes a corrupt file as unusable (returns
        None, warns, logs ``ckpt_corrupt``), so resume and rollback fall
        back along last -> best -> scratch; a mismatched config still
        raises."""
        try:
            return self.load_trained(path)
        except CheckpointCorruptError as e:
            print(f"WARNING: {e}; falling back to the next checkpoint.")
            if logger is not None:
                logger.log("ckpt_corrupt", path=path)
            return None

    def _shrink_lr(self, factor: float) -> None:
        """Rollback backoff: the schedule at ``learn_rate * factor``,
        tabulated into the rate table in place."""
        self.cfg = self.cfg.replace(learn_rate=self.cfg.learn_rate * factor)
        self.optimizer.set_schedule(lr_at(
            self.cfg.learn_rate, self.cfg.lr_schedule, self._total_steps))

    def _bad_epoch(self, epoch, mode, reason, skipped, logger) -> None:
        """Quarantine the state of a bad epoch to a postmortem checkpoint,
        restore the last good checkpoint, then raise ``RollbackSignal``
        (at most ``cfg.rollback_retries`` times, the rate backed off) or
        return, and the caller stops (JAX: ``_bad_epoch``)."""
        cfg = self.cfg
        post = postmortem_path(cfg.output_dir, cfg.model, epoch)
        self._save(post, epoch, quarantine_reason=reason)
        will_retry = self._rollback_attempts < cfg.rollback_retries
        print(f"ERROR: {reason} at epoch {epoch}; quarantined the offending "
              f"state to {post}; restoring last good checkpoint and "
              f"{'retrying' if will_retry else 'stopping'}.")
        logger.log("nan_abort", epoch=epoch, mode=mode, reason=reason,
                   skipped_steps=skipped, postmortem=post)
        restored = None
        self._files_settled()
        for path in (self._last_ckpt_path(), self._ckpt_path()):
            if path != post and self._ckpt_exists(path):
                restored = self._try_load_ckpt(path, logger)
                if restored is not None:
                    break
        if restored is not None and not _has_opt_state(restored):
            # the epoch-0 and best-only files carry no moments: never
            # retry on the bad epoch's
            self.optimizer.reset()
        if restored is None and will_retry:
            print("WARNING: no restorable checkpoint found; cannot roll "
                  "back -- stopping instead of retrying from the bad "
                  "state.")
            will_retry = False
        if not will_retry:
            return
        self._rollback_attempts += 1
        if self._m_rollbacks is not None:
            self._m_rollbacks.inc()
        if cfg.rollback_lr_factor < 1.0:
            self._shrink_lr(cfg.rollback_lr_factor)
        logger.log("rollback", epoch=epoch, reason=reason,
                   attempt=self._rollback_attempts,
                   retries=cfg.rollback_retries,
                   learn_rate=self.cfg.learn_rate)
        print(f"Rolling back (attempt {self._rollback_attempts}/"
              f"{cfg.rollback_retries}): resuming from the last good "
              f"checkpoint at learn_rate={self.cfg.learn_rate:.3}.")
        raise RollbackSignal(epoch, reason, self._rollback_attempts)

    def _validation_loss(self, mode: str = "validate") -> float:
        """The current weights' mean eval loss on ``mode`` (the promotion
        gate scores a candidate on 'test', service/promote.py)."""
        losses, sizes = self._run_epoch(
            mode, self._epoch_exec(mode), np.random.default_rng(0))
        return epoch_mean(losses, sizes)

    def _on_signal(self, signum, frame) -> None:
        """SIGTERM or SIGINT: finish the epoch, save, return. A second
        SIGINT aborts at once."""
        if signum == signal.SIGINT:
            if self._sigint_seen:
                os.write(2, b"second SIGINT: aborting immediately.\n")
                raise KeyboardInterrupt
            self._sigint_seen = True
        self._preempted = True
        # not print(): the signal can land inside a print of the loop
        name = signal.Signals(signum).name.encode()
        os.write(2, name + b" received: finishing the current epoch, "
                        b"checkpointing, and exiting cleanly "
                        b"(resume with -resume).\n")

    def train(self, resume: bool = False) -> dict:
        """Epoch loop with validation early stopping after
        ``cfg.early_stop_patience`` epochs without a better validation loss
        (reference: Model_Trainer.py:87-142), and the JAX trainer's
        self-healing around it: ``resume`` restarts from the rolling
        checkpoint (then the best one, then scratch); a dead init is
        retried per ``cfg.on_dead_init``; a bad epoch rolls back; SIGTERM
        and SIGINT end the run at the epoch's end with its state saved;
        the watchdog runs when ``cfg.watchdog_secs`` > 0. Returns the
        train and validate epoch losses."""
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        self._preempted = self._sigint_seen = False
        prev_handlers: dict = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread: no preemption hook
            pass
        if cfg.watchdog_secs > 0:
            writer = self._is_writer
            self._watchdog = HangWatchdog(
                cfg.watchdog_secs,
                emergency_path=(emergency_path(cfg.output_dir, cfg.model)
                                if writer else None),
                logger=RunLogger(run_log_path(cfg.output_dir, cfg.model,
                                              cfg.jsonl_log and writer)))
            self._watchdog.start()
            # armed with the initial state: a hang before the first epoch
            # ends still leaves a loadable emergency checkpoint
            self._watchdog_sync(0)
        try:
            attempt = 0
            while True:
                try:
                    return self._train_loop(resume)
                except DeadInitError:
                    if (self.cfg.on_dead_init != "retry"
                            or attempt >= self.cfg.dead_init_retries):
                        raise
                    attempt += 1
                    seed = self.cfg.seed + _RESEED_STRIDE
                    print(f"Dead initialization: retrying with seed {seed} "
                          f"(attempt {attempt}/"
                          f"{self.cfg.dead_init_retries}).")
                    self._reseed(seed)
                    resume = False  # a fresh draw never resumes the dead run
                except RollbackSignal:
                    # _bad_epoch restored, backed off and counted: re-enter
                    # from the rolling checkpoint, the shuffle replayed
                    resume = True
        finally:
            self._writer.flush()
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            for sig, prev in prev_handlers.items():
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)

    def _resume(self, resume: bool, logger, rng, state: dict) -> int:
        """Load what ``resume`` resumes from (last -> best -> scratch) into
        the trainer and ``state`` (best_val, best_epoch, patience_count);
        returns the first epoch to run. Replays the shuffle stream of the
        epochs already run."""
        cfg = self.cfg
        ckpt = kind = None
        self._files_settled()
        if resume:
            for path, k in ((self._last_ckpt_path(), "last"),
                            (self._ckpt_path(), "best")):
                if self._ckpt_exists(path):
                    ckpt = self._try_load_ckpt(path, logger)
                    if ckpt is not None:
                        kind = k
                        break
        if kind is None:
            if resume:
                print(f"WARNING: resume requested but no checkpoint at "
                      f"{self._ckpt_path()} is usable; training from "
                      f"scratch.")
            self._save(self._ckpt_path(), 0,
                       self._snapshot(with_opt=False))
            if self._ckpt_exists(self._last_ckpt_path()):
                # a stale rolling checkpoint must not be resumed after a
                # crash in this run's first epoch
                self._save_last(0, state["best_val"], state["best_epoch"],
                                state["patience_count"])
            return 1
        self._check_resumed_ckpt_dead(ckpt, logger)
        extra = ckpt.get("extra", {})
        done = ckpt["epoch"]
        if kind == "last":
            state.update(best_val=extra.get("best_val", np.inf),
                         best_epoch=extra.get("best_epoch", done),
                         patience_count=extra.get("patience_count",
                                                  state["patience_count"]))
            self.global_step = int(extra.get("global_step",
                                             self.global_step))
        else:  # a best-only checkpoint: restart after its epoch
            if not _has_opt_state(ckpt):
                self.optimizer.reset()
            best_val = extra.get("best_val")
            state.update(best_epoch=done, best_val=(
                self._validation_loss() if best_val is None else best_val))
        if cfg.shuffle:
            n = len(self.pipeline.modes["train"])
            for _ in range(done):
                rng.shuffle(np.arange(n))
        if kind == "last":
            print(f"Resuming after epoch {done} (best val loss "
                  f"{state['best_val']:.5} at epoch {state['best_epoch']}, "
                  f"patience {state['patience_count']}/"
                  f"{cfg.early_stop_patience})")
        else:
            print(f"Resuming from epoch {done} (best val loss "
                  f"{state['best_val']:.5})")
        return done + 1

    def _train_loop(self, resume: bool) -> dict:
        cfg = self.cfg
        modes = ("train", "validate")
        patience = cfg.early_stop_patience
        state = dict(best_val=np.inf, best_epoch=0, patience_count=patience)
        history = {m: [] for m in modes}
        rng = np.random.default_rng(cfg.seed)
        logger = RunLogger(run_log_path(cfg.output_dir, cfg.model,
                                        cfg.jsonl_log and self._is_writer))
        plan = {m: self._epoch_exec(m) for m in modes}
        stream_plan = {m: dict(zip(("chunks", "steps_per_chunk"),
                                   self._stream_plan(m)))
                       for m in modes if plan[m] == "stream"}
        logger.log("train_start", num_epochs=cfg.num_epochs,
                   steps_per_epoch=self.pipeline.num_batches("train"),
                   batch_size=cfg.batch_size, hidden_dim=cfg.hidden_dim,
                   num_branches=cfg.num_branches, kernel=cfg.kernel_type,
                   K=cfg.support_K, num_nodes=cfg.num_nodes,
                   lstm_impl=self.model.lstm_impl,
                   bdgcn_impl=self.bdgcn_impl,
                   support_density=round(self.pipeline.support_density, 6),
                   resume=resume, epoch_exec=plan,
                   **({"stream_plan": stream_plan} if stream_plan else {}))
        if not self._exec_logged:
            self._exec_logged = True  # once a run, not per retry
            print(self._exec_line(plan))
        start = self._resume(resume, logger, rng, state)
        self.best_epoch = state["best_epoch"]
        _banner(f"     {cfg.model} model training begins:")
        # the first trained epoch of every run doubles as the dead-init
        # probe (a dead run's checkpoints equal its init, so a resume
        # needs it too); weight decay moves the weights at a zero
        # gradient, so decay runs probe one batch's gradient up front
        probe = not self._dead_init_detected
        init_params = ([p.detach().clone() for p in self.model.parameters()]
                       if probe and cfg.decay_rate == 0 else None)
        if probe and cfg.decay_rate != 0:
            if self._forward_all_zero() and self._first_batch_grad_zero():
                self._dead_init_detected = True
                self._save_last(start - 1, **state)
                self._handle_dead_init(self._dead_init_msg(
                    "the first batch's loss-gradient global norm is "
                    "exactly 0"), start - 1, logger)
        for epoch in range(start, 1 + cfg.num_epochs):
            self._epoch = epoch  # the epoch the fault arms read
            if self._faults.active:
                # a dead rank (SIGKILL, no goodbye), then a wedged host:
                # the armed watchdog fires (exit 113) before this returns
                self._faults.maybe_kill_host(epoch, self.rank)
                self._faults.maybe_hang(epoch)
            skipped = spikes = 0
            snap = None
            self._stream_stats = {}
            epoch_t0 = time.monotonic()
            for mode in modes:
                is_train = mode == "train"
                sentinel = is_train and cfg.step_sentinels
                losses, sizes = self._run_epoch(mode, plan[mode], rng)
                if sentinel:
                    ok = np.isfinite(losses)
                    skipped = int((~ok).sum())
                    spikes = _count_spikes(losses[ok], cfg.loss_spike_factor)
                history[mode].append(epoch_mean(losses, sizes, sentinel))
                self._beat()
                bad = None
                if cfg.nan_guard and not np.isfinite(history[mode][-1]):
                    bad = f"non-finite {mode} epoch loss"
                elif sentinel and cfg.nan_guard and skipped > cfg.skip_budget:
                    bad = (f"{skipped} sentinel-skipped train step(s) "
                           f"exceeded skip_budget={cfg.skip_budget}")
                if bad is not None:
                    self._bad_epoch(epoch, mode, bad, skipped, logger)
                    return history
                if (is_train and cfg.consistency_check_every
                        and epoch % cfg.consistency_check_every == 0):
                    # before the validate mode saves, so the rolling
                    # checkpoint still holds the last good epoch when a
                    # divergence rolls back (JAX: the same place)
                    try:
                        self._check_consistency(epoch, logger)
                    except ReplicaDivergenceError as e:
                        self._bad_epoch(epoch, mode,
                                        f"replica divergence: {e}",
                                        skipped, logger)
                        return history
                if is_train and init_params is not None:
                    if (self._dead_after_epoch(init_params)
                            and self._forward_all_zero()):
                        self._dead_init_detected = True
                        self._save_last(epoch, **state)
                        self._handle_dead_init(self._dead_init_msg(
                            f"no parameter changed over epoch {epoch}"),
                            epoch, logger)
                    init_params = None
                if mode != "validate":
                    continue
                epoch_val = history[mode][-1]
                # one host copy of the state serves the epoch's checkpoints
                # and the watchdog (rank 0's: the others write neither)
                snap = self._snapshot() if self._is_writer else None
                if epoch_val <= state["best_val"]:
                    print(f"Epoch {epoch}, validation loss drops from "
                          f"{state['best_val']:.5} to {epoch_val:.5}. "
                          f"Update model checkpoint..")
                    state.update(best_val=epoch_val, best_epoch=epoch,
                                 patience_count=patience)
                    self.best_epoch = epoch
                    self._save(self._ckpt_path(), epoch, snap,
                               best_val=epoch_val)
                else:
                    print(f"Epoch {epoch}, validation loss does not "
                          f"improve from {state['best_val']:.5}.")
                    state["patience_count"] -= 1
                self._save_last(epoch, snap=snap, **state)
                # the loss scaler's state: one read an epoch, never a step
                scaler = (self.optimizer.scaler.stats()
                          if self.optimizer.scaler is not None else {})
                obs = self._epoch_obs(scaler, skipped,
                                      time.monotonic() - epoch_t0)
                logger.log("epoch", epoch=epoch,
                           **{f"{m}_loss": history[m][-1] for m in modes},
                           best_val=state["best_val"],
                           best_epoch=state["best_epoch"],
                           patience=state["patience_count"],
                           skipped_steps=skipped, loss_spikes=spikes,
                           steps_per_sec=round(self.steps_per_sec(), 3),
                           **({"loss_scale": scaler["scale"],
                               "scaler_skipped_steps":
                                   scaler["skipped_steps"]}
                              if scaler else {}),
                           **({"stream": self._stream_stats}
                              if self._stream_stats else {}),
                           # the registry's snapshot: the trainer's scrape
                           **obs)
                if state["patience_count"] <= 0:
                    _banner(f"    Early stopping at epoch {epoch}. "
                            f"{cfg.model} model training ends.")
                    print(f"steps/sec: {self.steps_per_sec():.2f}")
                    logger.log("early_stop", epoch=epoch,
                               best_epoch=state["best_epoch"],
                               best_val=state["best_val"])
                    return history
            self._watchdog_sync(epoch, snap)
            if self._vote_preempted() and epoch < cfg.num_epochs:
                self._save_last(epoch, snap=snap, **state)
                logger.log("preempted", epoch=epoch)
                _banner(f"    Preempted at epoch {epoch}: state saved. "
                        f"Resume with -resume.")
                return history
        _banner(f"     {cfg.model} model training ends.")
        print(f"steps/sec: {self.steps_per_sec():.2f}")
        logger.log("train_end", best_epoch=state["best_epoch"],
                   best_val=state["best_val"],
                   steps_per_sec=round(self.steps_per_sec(), 3))
        return history

    def _vote_preempted(self) -> bool:
        """Was a signal received (on a group: by any rank; every rank
        votes every epoch, so the vote always pairs up)?"""
        return self._preempted

    def _check_consistency(self, epoch: int, logger) -> None:
        """Digest-compare the weights, Adam's state and the banks across
        the ranks (one process: digest them); raises
        ``ReplicaDivergenceError`` on every rank alike."""
        named = dict(self.model.named_parameters())
        n = check_replica_consistency(
            {"params": named,
             "opt_state": {k: self.optimizer.state[p]
                           for k, p in named.items()},
             "banks": self.banks}, name="train_state")
        logger.log("consistency_ok", epoch=epoch, leaves=n)

    # --- inference -------------------------------------------------------

    def load_trained(self, path: Optional[str] = None,
                     restore_opt: bool = True) -> dict:
        """Load a JAX-format checkpoint (this trainer's by default) into
        the model, in place; returns its payload. Its optimizer state, the
        port's or a JAX one whose optax chain matches this run's, goes into
        the optimizer in place; a chain that does not match leaves a fresh
        optimizer, with the JAX trainer's warning; none (or
        ``restore_opt=False``) leaves the optimizer as it is."""
        path = path or self._ckpt_path()
        self._files_settled()
        ckpt = load_checkpoint(path, self.cfg.num_branches,
                               self.cfg.resolved_branch_sources)
        self.model.load_state_dict(params_from_jax(ckpt["params"]))
        self._weights_gen += 1
        if not restore_opt or not _has_opt_state(ckpt):
            return ckpt
        chain = self.optimizer.chain
        state = ckpt.get(OPT_STATE_KEY)
        if state is None:
            state = adam_state_from_jax(ckpt["opt_state"], chain)
        if (state is None or tuple(state["chain"]) != chain
                or ("loss_scale" in state)
                != (self.optimizer.scaler is not None)):
            print(f"WARNING: optimizer state in {path} has a different "
                  f"structure than this run's optimizer (it was saved "
                  f"under different clip_norm/lr_schedule/decay settings); "
                  f"restoring params only and reinitializing the "
                  f"optimizer.")
            self.optimizer.reset()
        else:
            load_opt_state(self.model, self.optimizer, state)
        return ckpt

    def warm_start(self, path: str) -> dict:
        """The continual-learning warm start (JAX: ``warm_start``): this
        run's weights from a trained checkpoint (the daemon's promoted
        incumbent) through ``load_trained``, then a fresh optimizer and
        the loss scaler's initial state, reset in place (the captured
        steps hold the state tensors' addresses; the checkpoint's
        optimizer state is never loaded, so no table grows). Unlike
        ``resume``, no epoch or early-stop counter is taken over."""
        ckpt = self.load_trained(path, restore_opt=False)
        self.optimizer.reset()
        return ckpt

    def close(self) -> None:
        """Wait for the checkpoint writer and release the trainer's CUDA
        graphs, their memory pool and the executors' device buffers
        (the graphs hold the pool; a cycle could keep them past the last
        reference). The trainer is not used after this; a second call
        does nothing more."""
        self._writer.flush()
        if self._graphs is not None:
            self._graphs.drop()
        self._graphs = self._rollouts = None
        self._epochs.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def predict(self, x, keys, pred_len: Optional[int] = None) -> np.ndarray:
        """Forecast ``pred_len`` OD frames: x (B, obs_len, N, N, 1) in the
        model's space, keys (B,) day-of-week slots -> (B, pred_len, N, N,
        1). On the card one captured rollout per (B, pred_len) replays
        (the JAX trainer's jitted ``_rollout``); elsewhere ``rollout``
        runs eagerly."""
        pred_len = pred_len or self.cfg.pred_len
        self.step_counts["rollout"] += pred_len
        xt = torch.from_numpy(np.array(x, np.float32))
        kt = torch.from_numpy(np.asarray(keys, np.int64))
        prec = self._precision()
        if self._rollouts is not None:
            self._check_storage()
            out = self._rollouts.run(xt, kt, pred_len, prec).numpy()
            self._graph_ptrs = self._state_ptrs()
            return out
        return rollout(self.model, self.banks, xt.to(self.device),
                       kt.to(self.device), pred_len, prec.dtype,
                       prec.params).float().cpu().numpy()

    def _rollout_batch(self, batch: Batch) -> np.ndarray:
        """Test mode's forecast of one padded batch, on the host."""
        return self.predict(batch.x, batch.keys, self.cfg.pred_len)

    def test(self, denormalize: bool = False) -> dict:
        """Multi-step autoregressive evaluation of the train and test
        splits + score-file append (reference: Model_Trainer.py:145-185).
        ``denormalize`` scores forecast and truth after the data
        container's ``normalizer.denormalize`` (none without a
        container)."""
        cfg = self.cfg
        self.load_trained()
        results = {}
        for mode in ("train", "test"):
            _banner(f"     {cfg.model} model testing on {mode} data "
                    f"begins:")
            forecasts, truths = [], []
            for batch in self.pipeline.batches(mode, pad_to_full=True):
                pred = self._rollout_batch(batch)
                forecasts.append(pred[: batch.size])
                truths.append(batch.y[: batch.size])
            forecast = np.concatenate(forecasts, axis=0)
            truth = np.concatenate(truths, axis=0)
            if denormalize and self.data_container is not None:
                norm = self.data_container.normalizer
                forecast = norm.denormalize(forecast)
                truth = norm.denormalize(truth)
            mse, rmse, mae, mape = metrics.evaluate(forecast, truth)
            results[mode] = {"MSE": mse, "RMSE": rmse, "MAE": mae,
                             "MAPE": mape}
            if cfg.pred_len > 1:
                results[mode]["RMSE_by_horizon"] = metrics.per_horizon_rmse(
                    forecast, truth)
            if not self._is_writer:
                continue
            score_path = os.path.join(cfg.output_dir,
                                      f"{cfg.model}_prediction_scores.txt")
            with open(score_path, "a") as f:
                f.write("%s, MSE, RMSE, MAE, MAPE, "
                        "%.10f, %.10f, %.10f, %.10f\n"
                        % (mode, mse, rmse, mae, mape))
        _banner(f"     {cfg.model} model testing ends.")
        return results
