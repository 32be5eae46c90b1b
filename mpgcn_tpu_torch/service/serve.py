"""The serving plane (counterpart of mpgcn_tpu/service/serve.py): the
serving engine, its HTTP front and the ``serve`` command.

``ServeEngine.submit`` is the seam a front end calls: every request
passes the admission gate (service/ingest.py), joins a micro-batcher
queue per forecast horizon (service/batcher.py), and is answered by a
``horizon``-step autoregressive rollout of MPGCN over its padded bucket,
through the hand-written kernels when the engine runs on the card. The
support banks are put on the device once at startup, dense or, for
large sparse graphs (``bdgcn_impl`` 'auto' or 'ell'), as blocked-ELL
containers; ``stats()["support"]`` reports their resident bytes.

Two parameter slots. The JAX engine passes each parameter tree to one
compiled executable per (bucket, horizon); the port's CUDA graphs read
the weights where they lie (train/graphs.py), so a second parameter set
cannot share them. The engine keeps two ``MPGCN`` modules of one config
(and, under int8, two quantized trees): slot 0 and slot 1. At startup
it captures each slot's rollout per (bucket, horizon) on one
``GraphSet`` -- one memory pool, one lock, the slot in the key -- after
an eager warm-up run that builds the kernels. A hot-reload candidate is
copied into the idle slot in place (``_place``: ``load_state_dict``, or
the int8 codes and scales refilled), under the graph set's lock, so it
never overlaps a replay of that slot; the smoke eval replays the idle
slot's graph on the pinned probe batch; promotion swaps the slot
indices under the engine lock and copies and captures nothing. So
``stats()["traces"]``, the programs prepared at startup (the captured
graphs on the card; where nothing is captured -- the CPU, the ELL arm,
graphs.py ``refusal`` -- the eager warm-up runs), stays where startup
left it through traffic, reloads, promotions and rollbacks. A capture
or a replay that fails raises; nothing falls back to eager execution.

Every bucket runs at the engine's inference precision
(``cfg.infer_precision``; 'auto' follows ``cfg.dtype``): f32, bf16
compute (the kernels' bf16 forms), or int8 weight-only, where each
slot's weights are quantized per channel (quant/int8.py) and each
rollout dequantizes the codes inside its forward.

The double-buffered feed (``ServeConfig.double_buffer``): on the card a
stager thread per horizon copies each padded batch into a preallocated
pinned host buffer, uploads it on a side stream into a device staging
buffer (two of each per bucket) and records an event; the batch then
waits on that event and copies the staging buffer into the graph's
static inputs, device to device, inside the lock. The graph's static
inputs are never the upload target: the batch before may still replay
from them. On the CPU nothing is staged.

Canaried hot reload (service/reload.py), one ledger row per request and
per reload decision (``serve/requests.jsonl``, ``serve/reloads.jsonl``,
size-capped and rotated), a per-engine metrics registry with the JAX
metric names (``/v1/stats`` is a view over it, ``/metrics`` renders it
with the process default registry), the SLO engine (obs/perf/slo.py),
and a ``serve.request -> serve.batcher -> serve.model`` span chain per
resolved request (``<out>/obs/spans.jsonl``; the trace id is minted at
admission or taken from the ``X-MPGCN-Trace`` header).

``serve --fleet`` serves every tenant of ``<out>/fleet/registry.json``
through service/fleet.py's ``FleetEngine`` behind the same HTTP front,
which then routes on the body's ``tenant``.

The command's operator flags: ``--profile NAME`` takes ``-obs``, ``-pred``,
``-seed`` and ``-sN`` from a scenario profile (scenarios/profiles.py);
``--compile-cache DIR`` is the directory of the kernel libraries
(obs/perf/compile_cache.py), enabled before anything is built; ``-trace
DIR`` records the serving loop in a ``torch.profiler`` window
(utils/profiling.py), each batch annotated ``serve_batch#<seq>``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import (
    FleetConfig,
    MPGCNConfig,
    ServeConfig,
    default_slos,
)
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.cuda_bdgcn import BDGCN_PAIR_FWD, BDGCN_PAIR_FWD_BF16
from mpgcn_tpu_torch.nn.cuda_lstm import (
    LSTM_INFER_COLLECT,
    LSTM_INFER_COLLECT_BF16,
    LSTM_INFER_LAST,
    LSTM_INFER_LAST_BF16,
)
from mpgcn_tpu_torch.nn.mpgcn import MPGCN, infer_dtype_of
from mpgcn_tpu_torch.obs import flight
from mpgcn_tpu_torch.obs.metrics import (
    MetricsRegistry,
    default_registry,
    program_builds,
    render_prometheus,
)
from mpgcn_tpu_torch.obs.perf.slo import SLOEngine
from mpgcn_tpu_torch.obs.trace import (
    TRACE_HEADER,
    SpanLog,
    new_span_id,
    new_trace_id,
    spans_path,
)
from mpgcn_tpu_torch.quant.int8 import (
    quantization_error,
    quantize_params,
    requantize_,
)
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service.batcher import (
    ERROR_NONFINITE,
    OK,
    REJECT_DRAINING,
    REJECT_INVALID,
    MicroBatcher,
    Ticket,
    pick_bucket,
)
from mpgcn_tpu_torch.service.capture import capture_row_fields
from mpgcn_tpu_torch.service.ingest import validate_request
from mpgcn_tpu_torch.service.promote import (
    candidate_hash,
    ledger_path,
    promoted_path,
)
from mpgcn_tpu_torch.service.reload import promoted_seq
from mpgcn_tpu_torch.service.tenants import (
    REJECT_BREAKER_OPEN,
    REJECT_TENANT_UNAVAILABLE,
    REJECT_UNKNOWN_TENANT,
    SHED_TENANT_QUOTA,
)
from mpgcn_tpu_torch.sparse.cuda_ell import ELL_FWD, ELL_FWD_Q
from mpgcn_tpu_torch.train.checkpoint import load_serving_params
from mpgcn_tpu_torch.train.graphs import (
    GraphSet,
    Precision,
    RolloutGraphs,
    refusal,
)
from mpgcn_tpu_torch.train.predict import rollout
from mpgcn_tpu_torch.utils.convert import params_from_jax
from mpgcn_tpu_torch.utils.logging import JsonlLogger
from mpgcn_tpu_torch.utils.profiling import step_annotation

#: the kernels on the serve path, by the name the stats report
KERNELS = {"lstm_infer_last": LSTM_INFER_LAST,
           "lstm_infer_collect": LSTM_INFER_COLLECT,
           "bdgcn_pair_fwd": BDGCN_PAIR_FWD,
           "lstm_infer_last_bf16": LSTM_INFER_LAST_BF16,
           "lstm_infer_collect_bf16": LSTM_INFER_COLLECT_BF16,
           "bdgcn_pair_fwd_bf16": BDGCN_PAIR_FWD_BF16,
           "ell_fwd": ELL_FWD,
           "ell_fwd_q": ELL_FWD_Q}

#: the number of parameter slots (incumbent and canary)
SLOTS = 2


def serve_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "serve")


def requests_ledger_path(output_dir: str) -> str:
    return os.path.join(serve_dir(output_dir), "requests.jsonl")


def reloads_ledger_path(output_dir: str) -> str:
    return os.path.join(serve_dir(output_dir), "reloads.jsonl")


def http_info_path(output_dir: str) -> str:
    """Where the command writes the bound HTTP address (port 0 picks an
    ephemeral port; clients read it here)."""
    return os.path.join(serve_dir(output_dir), "http.json")


class _ParamSet:
    """One served parameter slot and its provenance (slot-file hash,
    promotions-ledger sequence, probe loss)."""

    __slots__ = ("slot", "hash", "seq", "probe_loss")

    def __init__(self, slot: int, hash_: str, seq: int,
                 probe_loss: Optional[float] = None):
        self.slot = slot
        self.hash = hash_
        self.seq = seq
        self.probe_loss = probe_loss


class _Staged:
    """A batch uploaded by ``_Stager``: its device staging buffers and the
    event the upload recorded."""

    __slots__ = ("x", "keys", "event")

    def __init__(self, x, keys, event):
        self.x, self.keys, self.event = x, keys, event


class _Stager:
    """The double-buffered feed's upload on the card (the batcher's
    ``stage_fn``): per bucket two pinned host buffers and two device
    staging buffers, used in turn, allocated once; the copy to the device
    runs on a side stream and records an event. The batcher calls it
    only once the batch two before has finished (service/batcher.py), so
    a buffer is never refilled while a batch reads it."""

    def __init__(self, device, buckets, obs_len: int, num_nodes: int):
        self.stream = torch.cuda.Stream(device)
        self._next = {b: 0 for b in buckets}
        self._host, self._dev = {}, {}
        for b in buckets:
            shape = (b, obs_len, num_nodes, num_nodes, 1)
            self._host[b] = [(torch.empty(shape).pin_memory(),
                              torch.empty((b,), dtype=torch.long)
                              .pin_memory()) for _ in range(2)]
            self._dev[b] = [(torch.empty(shape, device=device),
                             torch.empty((b,), dtype=torch.long,
                                         device=device))
                            for _ in range(2)]

    def __call__(self, x: np.ndarray, keys: np.ndarray):
        b = x.shape[0]
        i = self._next[b]
        self._next[b] = 1 - i
        hx, hk = self._host[b][i]
        dx, dk = self._dev[b][i]
        hx.copy_(torch.from_numpy(x))
        hk.copy_(torch.from_numpy(keys.astype(np.int64)))
        with torch.cuda.stream(self.stream):
            dx.copy_(hx, non_blocking=True)
            dk.copy_(hk, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Staged(dx, dk, event), keys


class ServeEngine:
    """Micro-batchers, two parameter slots of the model on ``device``, its
    support banks, the ledgers and the registry. The HTTP front and the
    command are thin shells over ``submit``.

    The first parameters come from ``init_ckpt`` when it is given (a
    missing one raises), else from the promoted slot
    ``<output_dir>/promoted/<model>_od.pkl``, else -- only with
    ``allow_fresh`` -- from a fresh init seeded by ``cfg.seed``; a file
    is hashed, loaded and hashed again until the two hashes agree (5
    attempts), and its sequence is read from the promotions ledger.
    ``bdgcn_impl`` picks the BDGCN arm as for ``ModelTrainer``."""

    def __init__(self, cfg: MPGCNConfig, data: dict, scfg: ServeConfig,
                 device="cuda", faults: Optional[FaultPlan] = None,
                 init_ckpt: Optional[str] = None, allow_fresh: bool = False,
                 bdgcn_impl: str = "auto"):
        self.device = resolve_device(device)
        self.scfg = scfg
        self._faults = faults if faults is not None else FaultPlan.parse("")
        # the model config's pred_len must cover the longest horizon (the
        # probe batch's y is pred_len deep): refused before anything is
        # built
        self.horizons = tuple(scfg.horizons) or (cfg.pred_len,)
        if max(self.horizons) > cfg.pred_len:
            raise ValueError(
                f"horizons={self.horizons} exceed the model config's "
                f"pred_len={cfg.pred_len}; pass -pred >= "
                f"max(horizons) so the probe split covers every served "
                f"horizon")
        self._default_horizon = (cfg.pred_len if cfg.pred_len in
                                 self.horizons else self.horizons[-1])
        self._probe_h = self.horizons[-1]
        os.makedirs(serve_dir(scfg.output_dir), exist_ok=True)
        self.request_log = JsonlLogger(
            requests_ledger_path(scfg.output_dir),
            rotate_max_bytes=scfg.ledger_max_bytes)
        self.reload_log = JsonlLogger(
            reloads_ledger_path(scfg.output_dir),
            rotate_max_bytes=scfg.ledger_max_bytes)
        self.slot_path = promoted_path(scfg.output_dir, cfg.model)
        self.promotions_ledger_path = ledger_path(scfg.output_dir)
        host_params, h, seq = self._initial_params(cfg, init_ckpt,
                                                   allow_fresh)

        pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        self.cfg = cfg = cfg.replace(num_nodes=pipeline.num_nodes)
        self.pipeline = pipeline
        self.banks = pipeline.banks
        self._models = [MPGCN.from_config(
            cfg, device=self.device,
            bdgcn_impl=pipeline.bdgcn_impl).eval() for _ in range(SLOTS)]
        print(pipeline.dispatch_line(self._models[0].lstm_impl))

        # the inference precision every bucket runs at; under int8 each
        # slot has its quantized tree, refilled in place by _place
        self.infer_precision = cfg.resolved_infer_precision
        self._quant_err_last = 0.0
        self._precisions = []
        for m in self._models:
            q = None
            if self.infer_precision == "int8":
                q = quantize_params(dict(m.named_parameters()))
            self._precisions.append(Precision(
                self.infer_precision, infer_dtype_of(cfg), q))

        # the probe batch (pinned; smoke evals and flood requests): the
        # first test windows, repeat-padded to a bucket
        md = pipeline.modes["test"]
        n = min(len(md), scfg.buckets[-1])
        self._probe_bucket = pick_bucket(n, scfg.buckets)
        sel = np.arange(n)
        sel = np.concatenate([sel, np.full(self._probe_bucket - n,
                                           sel[-1])]).astype(int)
        px, py = pipeline.gather_xy("test", sel)
        self._probe_x = np.asarray(px, np.float32)
        self._probe_y = np.asarray(py, np.float32)
        self._probe_keys = np.asarray(md.keys[sel], np.int32)
        self._probe_n = n

        self._lock = threading.Lock()
        self._incumbent: Optional[_ParamSet] = None
        self._canary: Optional[_ParamSet] = None
        self._canary_left = 0
        self._canary_stride = max(1, round(1.0 / scfg.canary_fraction))
        self.bad_hashes: set[str] = set()
        self._warmup()
        if host_params is None:
            slot = 0
            if self.infer_precision == "int8":
                self._quant_err_last = quantization_error(
                    dict(self._models[0].named_parameters()),
                    self._precisions[0].params)["max_abs_error"]
        else:
            slot = self._place(host_params)
        self._incumbent = _ParamSet(slot, h, seq)

        self._batch_seq = 0
        self._batch_seq_lock = threading.Lock()
        # {bucket: [live, padded, dispatches]}; guarded by _batch_seq_lock
        self._pad_stats: dict[int, list] = {}
        self._submit_seq = itertools.count(1)
        self._captured_rows = 0

        # --- registry, SLOs, spans ---------------------------------------
        self.registry = MetricsRegistry()
        self._m_requests = self.registry.counter(
            "serve_requests", "resolved requests by typed outcome")
        self._m_req_children: dict[str, object] = {}
        self._m_latency = self.registry.histogram(
            "serve_request_latency_ms", "accepted-request latency (ms, "
            "submit to resolution)")
        self._m_reloads = self.registry.counter(
            "serve_reloads", "hot-reload verdicts (promoted/rolled_back)")
        self.registry.gauge(
            "serve_batches", "bucketed batches dispatched to the model "
            "(all horizons)").set_fn(
            lambda: sum(b.batches_dispatched
                        for b in self.batchers.values()))
        self.registry.gauge(
            "serve_pad_waste_ratio", "padded-minus-real over padded "
            "elements across all dispatched batches").set_fn(
            lambda: self._pad_waste_snapshot()["ratio"])
        self.registry.gauge(
            "serve_queue_depth", "tickets waiting in the micro-batcher "
            "queues (all horizons)").set_fn(
            lambda: sum(b.depth() for b in self.batchers.values()))
        self.registry.gauge(
            "serve_traces", "programs prepared at startup (captured CUDA "
            "graphs; eager warm-up runs where nothing is captured): the "
            "request path must never add one").set_fn(
            lambda: self.trace_count)
        self.registry.gauge(
            "serve_canary_active", "1 while a canary parameter set is "
            "taking traffic").set_fn(
            lambda: float(self._canary is not None))
        self.registry.gauge(
            "serve_quant_max_abs_error", "int8 weight round-trip max-abs "
            "error of the most recently placed parameter set (0 unless "
            "infer_precision='int8')").set_fn(
            lambda: self._quant_err_last)
        program_builds()  # the retrace objective's series, before its
        #                   first snapshot
        flight.add_metrics_provider("serve", self.registry.snapshot)
        self.slo = SLOEngine(default_slos("serve"),
                             [self.registry, default_registry()],
                             export_registry=self.registry,
                             output_dir=serve_dir(scfg.output_dir))
        self.span_log = SpanLog(spans_path(scfg.output_dir),
                                rotate_max_bytes=scfg.ledger_max_bytes)
        # exact recent-window latencies for /v1/stats (the histogram
        # above feeds Prometheus), overall and per horizon
        self._lat_ms: deque[float] = deque(maxlen=2048)
        self._lat_by_h: dict[int, deque] = {
            h: deque(maxlen=2048) for h in self.horizons}
        self._draining = False

        # one MicroBatcher per horizon (a batch shares its rollout
        # length); on the card the double-buffered feed uploads on its
        # stager thread
        def stage_fn():
            if not (scfg.double_buffer and self.device.type == "cuda"):
                return None
            return _Stager(self.device, scfg.buckets, cfg.obs_len,
                           cfg.num_nodes)

        self.batchers: dict[int, MicroBatcher] = {
            h: MicroBatcher(self._make_run_batch(h), scfg.buckets,
                            scfg.max_queue, scfg.max_wait_ms,
                            double_buffer=scfg.double_buffer,
                            stage_fn=stage_fn())
            for h in self.horizons}
        self._incumbent.probe_loss = self.probe_loss(self._incumbent.slot)
        for b in self.batchers.values():
            b.start()
        self.request_log.log(
            "serve_start", buckets=list(scfg.buckets),
            horizons=list(self.horizons),
            max_queue=scfg.max_queue, max_wait_ms=scfg.max_wait_ms,
            deadline_ms=scfg.deadline_ms,
            double_buffer=scfg.double_buffer,
            infer_precision=self.infer_precision,
            incumbent=self._incumbent.hash,
            incumbent_seq=self._incumbent.seq, traces=self.trace_count,
            probe_loss=self._round(self._incumbent.probe_loss))

    # --- startup ---------------------------------------------------------

    def _initial_params(self, cfg, init_ckpt, allow_fresh):
        """(host params or None for the fresh init, hash, seq)."""
        if init_ckpt is not None and not os.path.exists(init_ckpt):
            # a named checkpoint that is missing is an error, never a
            # fresh init
            raise FileNotFoundError(f"no checkpoint to serve at "
                                    f"{init_ckpt}")
        source = init_ckpt or self.slot_path
        if os.path.exists(source):
            # hash -> load -> hash again: a promoter's os.replace can land
            # mid-load, and params labelled with another version's hash
            # would corrupt the reload bookkeeping from the first poll on
            for _ in range(5):
                h = candidate_hash(source)
                ckpt = load_serving_params(
                    source, num_branches=cfg.num_branches,
                    branch_sources=cfg.resolved_branch_sources)
                if candidate_hash(source) == h:
                    break
            else:
                raise RuntimeError(
                    f"checkpoint {source} kept changing underneath the "
                    f"startup load (5 attempts) -- promoter churning too "
                    f"fast; retry")
            seq = promoted_seq(self.promotions_ledger_path, h)
            self.params_source = source
            return ckpt["params"], h, -1 if seq is None else seq
        if allow_fresh:
            self.params_source = f"fresh init (seed {cfg.seed})"
            print(f"[serve] WARNING: no checkpoint at {source}; serving "
                  f"FRESH (untrained) params (--allow-fresh-init).",
                  flush=True)
            return None, "", -1
        raise FileNotFoundError(
            f"no checkpoint to serve: {source} does not exist (run the "
            f"daemon to promote one, pass --ckpt, or --allow-fresh-init)")

    def _warmup(self) -> None:
        """Prepare every (bucket, horizon): on the card each slot's rollout
        is captured after an eager warm-up run (which builds the kernels
        and warms the allocator); where nothing is captured, slot 0 runs
        each pair once eagerly. Measures what the second slot adds."""
        N, T = self.cfg.num_nodes, self.cfg.obs_len
        self._graphs = None
        self._slot_rollouts = None
        self._warm_runs = 0
        weights = [sum(p.numel() * p.element_size()
                       for p in m.parameters()) for m in self._models]
        if self.infer_precision == "int8":
            weights = [sum(v.nbytes for v in p.params.values()
                           if hasattr(v, "q")) + w
                       for p, w in zip(self._precisions, weights)]
        self.slot_bytes = {"weights": weights[1]}
        why = refusal(self.device, self.pipeline.bdgcn_impl)
        if why is None:
            gs = self._graphs = GraphSet(self.device,
                                         self.pipeline.bdgcn_impl)
            self._device_lock = gs.lock
            self._slot_rollouts = [
                RolloutGraphs(gs, m, self.banks, slot=i)
                for i, m in enumerate(self._models)]
            secs, mem = [], [(torch.cuda.memory_allocated(self.device),
                              torch.cuda.memory_reserved(self.device))]
            for r, prec in zip(self._slot_rollouts, self._precisions):
                secs.append(r.capture_all(self.scfg.buckets, self.horizons,
                                          T, N, prec))
                mem.append((torch.cuda.memory_allocated(self.device),
                            torch.cuda.memory_reserved(self.device)))
            self.slot_bytes.update(
                graphs_allocated=mem[2][0] - mem[1][0],
                graphs_reserved=mem[2][1] - mem[1][1],
                slot0_graphs_allocated=mem[1][0] - mem[0][0])
            print(f"[serve] captured {len(gs.graphs)} rollout graphs "
                  f"({SLOTS} parameter slots x buckets "
                  f"{list(self.scfg.buckets)} x horizons "
                  f"{list(self.horizons)}, infer_precision="
                  f"{self.infer_precision}) in {sum(secs):.2f}s; one "
                  f"memory pool, replays serialised by one lock",
                  flush=True)
            return
        self._device_lock = threading.RLock()
        print(f"[serve] rollout graphs: none ({why}); every batch runs "
              f"the eager rollout on its parameter slot", flush=True)
        m, prec = self._models[0], self._precisions[0]
        for b in self.scfg.buckets:
            x = torch.zeros((b, T, N, N, 1), device=self.device)
            k = torch.zeros((b,), dtype=torch.long, device=self.device)
            for h in self.horizons:
                rollout(m, self.banks, x, k, h, prec.dtype, prec.params)
                self._warm_runs += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def trace_count(self) -> int:
        """Programs prepared at startup: the captured graphs (counted live,
        so a capture on the request path would show), else the eager
        warm-up runs."""
        if self._graphs is not None:
            return len(self._graphs.graphs)
        return self._warm_runs

    # --- the slots -------------------------------------------------------

    @property
    def model(self) -> MPGCN:
        """The incumbent slot's module."""
        return self._models[self._incumbent.slot if self._incumbent
                            else 0]

    @property
    def _precision(self) -> Precision:
        """The incumbent slot's precision (its int8 tree)."""
        return self._precisions[self._incumbent.slot if self._incumbent
                                else 0]

    @property
    def _rollouts(self) -> Optional[RolloutGraphs]:
        """The incumbent slot's rollout graphs (None where nothing is
        captured)."""
        if self._slot_rollouts is None:
            return None
        return self._slot_rollouts[self._incumbent.slot if self._incumbent
                                   else 0]

    def _place(self, host_tree) -> int:
        """Copy a host params tree into the idle slot in place (int8: its
        codes and scales too) and return the slot. Holds the device lock,
        so no replay of that slot is in flight meanwhile."""
        state = params_from_jax(host_tree)
        with self._device_lock:
            with self._lock:
                if self._canary is not None:
                    raise RuntimeError("a canary is in flight: no idle "
                                       "parameter slot")
                slot = (0 if self._incumbent is None
                        else 1 - self._incumbent.slot)
            model = self._models[slot]
            with torch.no_grad():
                model.load_state_dict(state)
            if self.infer_precision == "int8":
                params = dict(model.named_parameters())
                requantize_(self._precisions[slot].params, params)
                self._quant_err_last = quantization_error(
                    params, self._precisions[slot].params)["max_abs_error"]
        return slot

    def _run(self, slot: int, x, keys, horizon: int) -> np.ndarray:
        """Slot ``slot``'s rollout of a padded batch: x a host array or a
        staged upload; the forecast on the host."""
        prec = self._precisions[slot]
        with self._device_lock:
            if isinstance(x, _Staged):
                torch.cuda.current_stream(self.device).wait_event(x.event)
                xt, kt = x.x, x.keys
            else:
                xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
                kt = torch.from_numpy(np.asarray(keys, np.int64))
            if self._slot_rollouts is not None:
                return self._slot_rollouts[slot].replay(xt, kt, horizon,
                                                        prec).numpy()
            return rollout(self._models[slot], self.banks,
                           xt.to(self.device), kt.to(self.device), horizon,
                           prec.dtype, prec.params).float().cpu().numpy()

    @staticmethod
    def _round(v, nd: int = 6):
        return None if v is None else round(float(v), nd)

    @property
    def quant_max_abs_error(self) -> float:
        return self._quant_err_last

    @property
    def incumbent_hash(self) -> str:
        with self._lock:
            return self._incumbent.hash

    @property
    def incumbent_seq(self) -> int:
        with self._lock:
            return self._incumbent.seq

    @property
    def incumbent_probe_loss(self) -> Optional[float]:
        with self._lock:
            return self._incumbent.probe_loss

    @property
    def canary_hash(self) -> Optional[str]:
        with self._lock:
            return self._canary.hash if self._canary else None

    def probe_loss(self, slot: int) -> float:
        """Masked MSE of slot ``slot`` on the pinned probe batch, through
        the rollout prepared for the probe bucket at the longest horizon
        (every shorter horizon's rollout is a prefix of it)."""
        preds = self._run(slot, self._probe_x, self._probe_keys,
                          self._probe_h)
        n = self._probe_n
        d = preds[:n] - self._probe_y[:n, :self._probe_h]
        return float(np.mean(d * d))

    def install_canary(self, params, hash_: str, seq: int,
                       probe_loss: Optional[float] = None) -> None:
        """Serve ``params`` -- a slot ``_place`` filled, or a host tree to
        place -- to the canary traffic fraction (service/reload.py's step
        4); ``canary_requests`` 0 promotes at once."""
        slot = params if isinstance(params, int) else self._place(params)
        cand = _ParamSet(slot, hash_, seq, probe_loss)
        with self._lock:
            self._canary = cand
            self._canary_left = self.scfg.canary_requests
            if self._canary_left <= 0:
                self._promote_canary_locked()

    def _promote_canary_locked(self) -> None:
        prev = self._incumbent
        self._incumbent = self._canary
        self._canary = None
        self._m_reloads.labels(verdict="promoted").inc()
        self.reload_log.log("reload_promoted", hash=self._incumbent.hash,
                            seq=self._incumbent.seq,
                            probe_loss=self._round(
                                self._incumbent.probe_loss),
                            previous=prev.hash)
        print(f"[serve] reload PROMOTED {self._incumbent.hash[:12]} "
              f"(seq {self._incumbent.seq}, slot {self._incumbent.slot}); "
              f"previous {prev.hash[:12] or '<fresh>'} released.",
              flush=True)

    def note_reload_rollback(self) -> None:
        """Count a reload the protocol rejected before traffic (smoke
        eval: non-finite or regressed; service/reload.py)."""
        self._m_reloads.labels(verdict="rolled_back").inc()

    def _rollback_canary_locked(self, reason: str) -> None:
        bad = self._canary
        self._canary = None
        self._m_reloads.labels(verdict="rolled_back").inc()
        self.bad_hashes.add(bad.hash)
        self.reload_log.log("reload_rollback", hash=bad.hash,
                            seq=bad.seq, reason=reason)
        print(f"[serve] canary ROLLED BACK ({reason}); incumbent "
              f"{self._incumbent.hash[:12] or '<fresh>'} keeps serving.",
              flush=True)

    # --- request path ----------------------------------------------------

    def _make_run_batch(self, horizon: int):
        """One horizon's batcher seam: route to the canary or the
        incumbent slot, run its rollout, police the canary's output."""

        def run_batch(x, keys, bucket: int, n_live: int):
            with self._batch_seq_lock:
                self._batch_seq += 1
                seq = self._batch_seq
                st = self._pad_stats.setdefault(bucket, [0, 0, 0])
                st[0] += n_live
                st[1] += bucket
                st[2] += 1
            self._faults.maybe_slow_request(seq)
            # the slot is chosen and run under the device lock: no
            # placement into it can land in between
            with self._device_lock:
                with self._lock:
                    use_canary = (self._canary is not None
                                  and seq % self._canary_stride == 0)
                    pset = self._canary if use_canary else self._incumbent
                with step_annotation(seq, "serve_batch"):
                    preds = self._run(pset.slot, x, keys, horizon)
                if use_canary and not np.all(np.isfinite(preds)):
                    # the canary failed live traffic: roll back and serve
                    # this batch again on the incumbent
                    with self._lock:
                        if self._canary is pset:
                            self._rollback_canary_locked(
                                "non-finite canary output on live "
                                "traffic")
                        inc = self._incumbent
                    return self._run(inc.slot, x, keys, horizon), False
            if use_canary:
                with self._lock:
                    if self._canary is pset:
                        self._canary_left -= n_live
                        if self._canary_left <= 0:
                            self._promote_canary_locked()
            return preds, use_canary

        return run_batch

    def _note(self, t: Ticket) -> None:
        """Ticket resolution hook: registry counters, one request-ledger
        row and the request's span chain (on the resolving thread, off
        the submit path)."""
        child = self._m_req_children.get(t.outcome)
        if child is None:  # a benign race: duplicates share the key
            child = self._m_req_children[t.outcome] = \
                self._m_requests.labels(outcome=t.outcome)
        child.inc()
        if t.outcome == OK:
            self._m_latency.observe(t.latency_ms)
            with self._lock:
                self._lat_ms.append(t.latency_ms)
                lat_h = self._lat_by_h.get(t.horizon)
                if lat_h is not None:
                    lat_h.append(t.latency_ms)
        extra = {}
        if (self.scfg.capture_flows and t.outcome == OK
                and t.day_slot is not None):
            extra = capture_row_fields(t.x, t.day_slot)
            if extra:
                with self._lock:
                    self._captured_rows += 1
        self.request_log.log("request", outcome=t.outcome,
                             latency_ms=round(t.latency_ms, 3),
                             bucket=t.bucket, canary=t.canary,
                             horizon=t.horizon, trace=t.trace,
                             **({"error": t.error} if t.error else {}),
                             **extra)
        # request (full latency) -> batcher (queue wait) -> model (the
        # batch's rollout); shed and rejected tickets emit the root only
        rows = [dict(name="serve.request", trace=t.trace, span=t.span,
                     t0=t.t_wall, dur_ms=t.latency_ms, outcome=t.outcome,
                     **({"error": t.error} if t.error else {}))]
        if t.queue_ms is not None:
            bspan = new_span_id()
            rows.append(dict(name="serve.batcher", trace=t.trace,
                             span=bspan, parent=t.span, t0=t.t_wall,
                             dur_ms=t.queue_ms, batch=t.batch_seq))
            if t.model_ms is not None:
                rows.append(dict(name="serve.model", trace=t.trace,
                                 parent=bspan,
                                 t0=t.t_wall + t.queue_ms / 1e3,
                                 dur_ms=t.model_ms, bucket=t.bucket,
                                 canary=t.canary))
        self.span_log.emit_many(rows)

    def submit(self, x, key, deadline_ms: Optional[float] = None,
               trace: Optional[str] = None, tenant: Optional[str] = None,
               horizon: Optional[int] = None,
               day_slot: Optional[int] = None) -> Ticket:
        """Admit one forecast request; always returns a ticket that will
        resolve (answered, shed or rejected). ``x`` is an (obs_len, N,
        N[, 1]) observation window, ``key`` its day-of-week slot,
        ``horizon`` one of the served horizons (None = the default),
        ``trace`` a caller's trace id (None mints one). A single-tenant
        server rejects an explicit ``tenant`` as unknown."""
        if self._faults.take_poison_request(next(self._submit_seq)):
            # the adversarial-traffic arm: the gate must shed it
            from mpgcn_tpu_torch.scenarios.dynamics import poison_request

            x = poison_request(x)
        dl = self.scfg.deadline_ms if deadline_ms is None else deadline_ms
        t = Ticket(x, key if isinstance(key, int) else 0,
                   deadline_s=dl / 1e3 if dl else None,
                   on_resolve=self._note)
        t.trace = trace or new_trace_id()
        t.span = new_span_id()
        if day_slot is not None:
            t.day_slot = int(day_slot)
        h = self._default_horizon if horizon is None else horizon
        t.horizon = h
        if h not in self.batchers:
            t.resolve(REJECT_INVALID,
                      error=f"horizon {horizon!r} is not served (served "
                            f"horizons: {list(self.horizons)})")
            return t
        if tenant is not None:
            t.resolve(REJECT_UNKNOWN_TENANT,
                      error=f"this server is single-tenant (no fleet "
                            f"registry); tenant {tenant!r} is not "
                            f"routable")
            return t
        if self._draining:
            t.resolve(REJECT_DRAINING, error="server draining")
            return t
        verdict = validate_request(x, key, self.cfg.obs_len,
                                   self.cfg.num_nodes)
        if not verdict["ok"]:
            t.resolve(REJECT_INVALID, error=verdict["reason"])
            return t
        with np.errstate(over="ignore"):  # overflow is rejected just below
            arr = np.asarray(x, np.float32)
        if not np.all(np.isfinite(arr)):
            # finite in float64 can overflow float32 (1e39 -> inf): in a
            # shared batch it would fail the model, and on a canary batch
            # roll back a healthy candidate
            t.resolve(REJECT_INVALID,
                      error="values overflow float32 (non-finite after "
                            "cast)")
            return t
        t.x = arr[..., None] if arr.ndim == 3 else arr
        t.key = int(key)
        return self.batchers[h].submit(t)

    def inject_flood(self, n: int) -> None:
        """The ``flood_qps`` fault: submit ``n`` requests built from the
        probe batch as fast as the queue takes them; the excess must shed
        with typed outcomes."""
        x = np.abs(self._probe_x[0, ..., 0])  # passes the gate
        for _ in range(n):
            self.submit(x, int(self._probe_keys[0]))

    # --- lifecycle -------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """SIGTERM, phase 1: reject new work, keep answering the queue."""
        self._draining = True

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """SIGTERM, phase 2: answer every request in flight, then retire
        the workers."""
        self._draining = True
        ok = True
        for b in self.batchers.values():
            ok = b.drain(timeout=timeout) and ok
        self.request_log.log("serve_stop", drained=ok,
                             resolved=self._outcome_counts()[1],
                             traces=self.trace_count)
        return ok

    def close(self) -> None:
        for b in self.batchers.values():
            b.stop()

    # --- observability ---------------------------------------------------

    def _outcome_counts(self) -> tuple[dict, int]:
        """({outcome: count}, total resolved), read from the registry:
        the one source the ledger, /v1/stats and /metrics report from."""
        counts = {dict(k).get("outcome", "?"): int(v)
                  for k, v in self._m_requests.series().items() if k}
        return counts, sum(counts.values())

    def _reload_counts(self) -> dict:
        c = self._m_reloads
        return {"promoted": int(c.labels(verdict="promoted").value),
                "rolled_back": int(c.labels(verdict="rolled_back").value)}

    def _pad_waste_snapshot(self) -> dict:
        """(padded - live) / padded overall and by bucket."""
        with self._batch_seq_lock:
            per = {b: list(st) for b, st in self._pad_stats.items()}
        live = sum(st[0] for st in per.values())
        padded = sum(st[1] for st in per.values())
        return {
            "ratio": (padded - live) / padded if padded else 0.0,
            "live": live, "padded": padded,
            "by_bucket": {
                str(b): {"live": st[0], "padded": st[1],
                         "dispatches": st[2],
                         "waste_ratio": round((st[1] - st[0]) / st[1], 6)}
                for b, st in sorted(per.items())},
        }

    @staticmethod
    def _percentiles(lats: list) -> dict:
        return {"p50": round(lats[len(lats) // 2], 3),
                "p99": round(lats[min(len(lats) - 1,
                                      int(len(lats) * 0.99))], 3),
                "n": len(lats)}

    def stats(self) -> dict:
        """The /v1/stats payload: a view over the registry, the slots'
        provenance, and the port's device, support banks and kernel
        launch counts (counted since they were last set to 0)."""
        counts, resolved = self._outcome_counts()
        with self._lock:
            lats = sorted(self._lat_ms)
            lats_h = {h: sorted(d) for h, d in self._lat_by_h.items()}
            inc = self._incumbent
            can = self._canary
            out = {
                "resolved": resolved,
                "outcomes": counts,
                "traces": self.trace_count,
                "batches": sum(b.batches_dispatched
                               for b in self.batchers.values()),
                "queue_depth": sum(b.depth()
                                   for b in self.batchers.values()),
                "draining": self._draining,
                "device": str(self.device),
                "params": self.params_source,
                "infer_precision": self.infer_precision,
                "quant_max_abs_error": self._quant_err_last,
                "support": self.pipeline.support_stats(),
                "double_buffer": self.scfg.double_buffer,
                "horizons": list(self.horizons),
                "buckets": list(self.scfg.buckets),
                "incumbent": {"hash": inc.hash, "seq": inc.seq,
                              "slot": inc.slot,
                              "probe_loss": self._round(inc.probe_loss)},
                "canary": ({"hash": can.hash, "seq": can.seq,
                            "slot": can.slot, "left": self._canary_left}
                           if can else None),
                "reloads": self._reload_counts(),
                "second_slot_bytes": dict(self.slot_bytes),
                "capture": {"enabled": self.scfg.capture_flows,
                            "rows": self._captured_rows},
            }
        out["pad_waste"] = self._pad_waste_snapshot()
        out["kernel_launches"] = {name: k.launches
                                  for name, k in KERNELS.items()}
        if lats:
            out["latency_ms"] = self._percentiles(lats)
        by_h = {str(h): self._percentiles(hl)
                for h, hl in sorted(lats_h.items()) if hl}
        if by_h:
            out["latency_ms_by_horizon"] = by_h
        out["slo"] = self.slo.report()
        return out

    def metrics_text(self) -> str:
        """Prometheus text of the engine registry merged with the process
        default (program builds, device gauges)."""
        self.slo.tick()
        return render_prometheus(self.registry, default_registry())


# --- HTTP front ---------------------------------------------------------------


_STATUS = {OK: 200, REJECT_INVALID: 400, ERROR_NONFINITE: 500,
           REJECT_UNKNOWN_TENANT: 404, REJECT_TENANT_UNAVAILABLE: 503,
           REJECT_BREAKER_OPEN: 429, SHED_TENANT_QUOTA: 429}

#: request-body byte cap: the HTTP layer bounds what it reads before the
#: admission gate can see a request
_MAX_BODY_BYTES = 64 << 20


def _make_handler(engine):
    """The HTTP front over a ServeEngine or a FleetEngine
    (service/fleet.py): GET /healthz, /v1/stats and /metrics, POST
    /v1/predict; a fleet routes on the body's ``tenant``."""
    from http.server import BaseHTTPRequestHandler

    is_fleet = hasattr(engine, "tenants")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # request rows go to the ledger
            pass

        def _json(self, code: int, payload: dict,
                  trace: Optional[str] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace:
                self.send_header(TRACE_HEADER, trace)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": ("draining" if engine.draining
                               else "serving"),
                    "incumbent": engine.incumbent_hash,
                    "canary": engine.canary_hash})
            elif self.path == "/v1/stats":
                self._json(200, engine.stats())
            elif self.path == "/metrics":
                body = engine.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"ok": False, "error": "not found"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._json(404, {"ok": False, "error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 <= n <= _MAX_BODY_BYTES:
                    self._json(413, {
                        "ok": False, "outcome": REJECT_INVALID,
                        "error": f"request body {n} bytes outside "
                                 f"[0, {_MAX_BODY_BYTES}]"})
                    return
                req = json.loads(self.rfile.read(n))
                x = req["x"]
                key = req.get("key", 0)
                tenant = req.get("tenant")
                if tenant is not None and not isinstance(tenant, str):
                    raise ValueError("tenant must be a string id")
                horizon = req.get("horizon")
                if horizon is not None:
                    # a JSON true must not serve horizon 1
                    if isinstance(horizon, bool) \
                            or not isinstance(horizon, int):
                        raise ValueError("horizon must be an integer")
                day_slot = req.get("day_slot")
                if day_slot is not None:
                    if isinstance(day_slot, bool) \
                            or not isinstance(day_slot, int) \
                            or day_slot < 0:
                        raise ValueError("day_slot must be an integer "
                                         ">= 0")
                req_dl = req.get("deadline_ms")
                if req_dl is not None:
                    # json.loads takes a bare NaN: a typed 400, not a
                    # handler crash
                    req_dl = float(req_dl)
                    if not math.isfinite(req_dl) or req_dl < 0:
                        raise ValueError("deadline_ms must be finite "
                                         "and >= 0")
            except Exception as e:
                self._json(400, {"ok": False,
                                 "outcome": REJECT_INVALID,
                                 "error": f"bad request body: "
                                          f"{type(e).__name__}"})
                return
            # a caller's trace id joins this request to its trace; minted
            # when absent, echoed back either way
            trace = (self.headers.get(TRACE_HEADER) or "").strip()[:64]
            if is_fleet:
                ticket = engine.submit(tenant, x, key, deadline_ms=req_dl,
                                       trace=trace or None,
                                       horizon=horizon, day_slot=day_slot)
            else:
                ticket = engine.submit(x, key, deadline_ms=req_dl,
                                       trace=trace or None, tenant=tenant,
                                       horizon=horizon, day_slot=day_slot)
            dl = engine.scfg.deadline_ms if req_dl is None else req_dl
            if not ticket.wait(timeout=(dl or 0) / 1e3 + 60.0):
                self._json(500, {"ok": False, "outcome": "error-timeout",
                                 "error": "ticket never resolved "
                                          "(harness bug)"})
                return
            payload = {"ok": ticket.ok, "outcome": ticket.outcome,
                       "latency_ms": round(ticket.latency_ms, 3),
                       "bucket": ticket.bucket, "canary": ticket.canary,
                       "trace": ticket.trace,
                       **({"horizon": ticket.horizon}
                          if ticket.horizon is not None else {}),
                       **({"tenant": ticket.tenant}
                          if ticket.tenant else {})}
            if ticket.ok:
                payload["pred"] = np.asarray(ticket.pred).tolist()
            else:
                payload["error"] = ticket.error
            self._json(_STATUS.get(ticket.outcome, 503), payload,
                       trace=ticket.trace)

    return Handler


# --- the command --------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The JAX serve command's flags, less ``--mesh-rungs`` (the mesh-rung
    ladder is not ported), plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli serve",
        description="Online serving: bucket-batched forecasts over HTTP "
                    "from CUDA graphs captured at startup, with admission "
                    "control, load shedding and canaried hot reload of "
                    "the promoted checkpoints.")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: 'cuda' (the default; the "
                        "command refuses to start without it) or 'cpu' "
                        "(the plain PyTorch versions of the kernels)")
    p.add_argument("-out", "--output_dir", default="./service",
                   help="service root (daemon layout): promoted/ is the "
                        "hot-reload slot, accepted/ the day files the "
                        "support banks are rebuilt from")
    p.add_argument("--ckpt", default=None,
                   help="serve this checkpoint instead of the promoted "
                        "slot (hot reload still tracks the slot)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral; the bound address is printed and "
                        "written to <out>/serve/http.json")
    p.add_argument("--buckets", default=None,
                   help="comma-separated padded batch shapes prepared at "
                        "startup (default 1,2,4,8)")
    p.add_argument("--horizons", default=None,
                   help="comma-separated forecast horizons prepared at "
                        "startup (e.g. 1,3,6); a request picks one with "
                        "the body's `horizon` field; empty = -pred only. "
                        "-pred is raised to max(horizons)")
    p.add_argument("--profile", default=None,
                   help="scenario profile name (scenarios/profiles.py): "
                        "sets -obs/-pred/-seed/-sN from the named "
                        "profile's contract (`scenario list`)")
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--deadline-ms", type=float, default=1000.0)
    p.add_argument("--no-double-buffer", dest="double_buffer",
                   action="store_false",
                   help="one-thread feed: staging of batch k+1 waits for "
                        "batch k instead of overlapping it")
    p.add_argument("--fused-epilogue", dest="fused_epilogue",
                   action="store_true",
                   help="the fused epilogues on the serve forward "
                        "(nn/fused.py)")
    p.add_argument("--reload-poll-secs", type=float, default=2.0)
    p.add_argument("--canary-fraction", type=float, default=0.25)
    p.add_argument("--canary-requests", type=int, default=16)
    p.add_argument("--reload-tolerance", type=float, default=0.25)
    p.add_argument("--ledger-max-bytes", type=int, default=8_000_000)
    p.add_argument("--capture-flows", dest="capture_flows",
                   action="store_true",
                   help="log each accepted request's day_slot and newest "
                        "(N, N) observation slot into the request ledger")
    p.add_argument("--fleet", action="store_true",
                   help="multi-tenant mode (service/fleet.py): serve every "
                        "tenant in <out>/fleet/registry.json, each its own "
                        "fault domain (queue, quota, breaker, canary) on "
                        "one shared set of rollout graphs; requests route "
                        "on the body's `tenant` field")
    p.add_argument("--tenant-quota", type=int, default=32,
                   help="per-tenant in-flight admission quota (bulkhead; "
                        "0 = unlimited; a registry entry's `quota` field "
                        "overrides it)")
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive model failures that trip a tenant's "
                        "circuit breaker open (429s for that tenant only; "
                        "0 = breaker off)")
    p.add_argument("--breaker-cooldown", type=float, default=30.0,
                   help="seconds a tripped breaker stays open before its "
                        "half-open probe request is admitted")
    p.add_argument("--window-days", type=int, default=30,
                   help="newest accepted days the support banks and the "
                        "probe split are rebuilt from")
    p.add_argument("--holdout-days", type=int, default=4)
    p.add_argument("--val-days", type=int, default=3)
    p.add_argument("--allow-fresh-init", action="store_true",
                   help="serve fresh (untrained) params when no "
                        "checkpoint exists yet")
    p.add_argument("-trace", "--trace_dir", type=str, default=None,
                   help="torch.profiler trace output dir: the serving "
                        "loop in one window (each batch annotated), "
                        "written there when the server drains")
    p.add_argument("--compile-cache", dest="compile_cache_dir",
                   type=str, default="",
                   help="directory of the built kernel libraries (obs/"
                        "perf/compile_cache.py): a restarted server loads "
                        "them instead of building them "
                        "($MPGCN_COMPILE_CACHE is the env equivalent)")
    p.add_argument("--max-requests", type=int, default=0,
                   help="drain and exit 0 after N resolved requests "
                        "(0 = run until SIGTERM)")
    p.add_argument("--serve-secs", type=float, default=0.0,
                   help="drain and exit 0 after S seconds (0 = run "
                        "until SIGTERM)")
    # model knobs (must match the promoted checkpoints')
    p.add_argument("-obs", "--obs_len", type=int, default=7)
    p.add_argument("-pred", "--pred_len", type=int, default=1)
    p.add_argument("-hidden", "--hidden_dim", type=int, default=32)
    p.add_argument("-kernel", "--kernel_type", type=str,
                   default="random_walk_diffusion")
    p.add_argument("-K", "--cheby_order", type=int, default=2)
    p.add_argument("-M", "--num_branches", type=int, default=2)
    p.add_argument("-batch", "--batch_size", type=int, default=4,
                   help="pipeline batch size for the probe split (not "
                        "the serving buckets)")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("--infer-precision", dest="infer_precision",
                   choices=("auto", "f32", "bf16", "int8"), default="auto",
                   help="request-path precision: bf16 compute, or int8 "
                        "per-channel weight-quantized weights dequantized "
                        "inside the rollout (the same graph count)")
    p.add_argument("--bdgcn-impl", dest="bdgcn_impl",
                   choices=("auto", "kernel", "einsum", "folded", "csr",
                            "ell"), default="auto",
                   help="BDGCN arm of the serving forward, by the port's "
                        "names (kernel: the JAX 'pallas'); ell stores the "
                        "support banks as blocked-ELL containers")
    p.add_argument("--support-payload", dest="support_payload",
                   choices=("f32", "bf16", "int8"), default="f32",
                   help="value payload of the resident sparse support "
                        "banks (int8: codes + per-row-block scales; "
                        "needs --bdgcn-impl ell)")
    p.add_argument("-sN", "--synthetic_N", type=int, default=47,
                   help="synthetic zone count (no accepted/ days)")
    p.add_argument("-sT", "--synthetic_T", type=int, default=120)
    p.add_argument("-faults", "--faults", type=str, default="",
                   help="chaos spec with the serving faults flood_qps=K / "
                        "poison_reload=K / slow_request=K / "
                        "poison_requests=K (resilience/faults.py)")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="accepted for supervisor compatibility; the "
                        "server is stateless beyond the promoted slot "
                        "and its ledgers, so a relaunch just serves")
    return p


def _build_data(ns, tcfg):
    """(cfg, data) for the engine: the support banks from the newest
    accepted days of the daemon layout (the preprocessing retrains use),
    else the synthetic series."""
    from mpgcn_tpu_torch.data.loader import (
        load_dataset,
        preprocess_od,
        synthetic_adjacency,
    )
    from mpgcn_tpu_torch.service.daemon import window_split_ratio
    from mpgcn_tpu_torch.service.ingest import day_filename, parse_day_index

    accepted_dir = os.path.join(ns.output_dir, "accepted")
    ids = []
    if os.path.isdir(accepted_dir):
        ids = sorted(i for i in (parse_day_index(f)
                                 for f in os.listdir(accepted_dir))
                     if i is not None)[-ns.window_days:]
    min_days = (tcfg.obs_len + tcfg.pred_len + ns.val_days
                + ns.holdout_days + tcfg.batch_size)
    if len(ids) >= min_days:
        raw = np.stack([np.load(os.path.join(accepted_dir,
                                             day_filename(i)))
                        for i in ids]).astype(np.float64)
        N = raw.shape[1]
        adj_path = os.path.join(ns.output_dir, "adjacency.npy")
        adj = (np.load(adj_path) if os.path.exists(adj_path)
               else synthetic_adjacency(N, tcfg.seed))
        cfg = tcfg.replace(num_nodes=N, split_ratio=window_split_ratio(
            len(ids), tcfg.obs_len, tcfg.pred_len, ns.val_days,
            ns.holdout_days))
        print(f"[serve] support banks from {len(ids)} accepted days "
              f"(day {ids[0]}..{ids[-1]}, N={N})", flush=True)
        return cfg, preprocess_od(raw, adj, cfg)
    data, _ = load_dataset(tcfg)
    return tcfg.replace(num_nodes=data["OD"].shape[1]), data


def main(argv=None) -> int:
    import signal
    from http.server import ThreadingHTTPServer

    from mpgcn_tpu_torch.obs.device import DeviceSampler
    from mpgcn_tpu_torch.service.reload import CanaryReloader
    from mpgcn_tpu_torch.utils.atomic import atomic_write_bytes

    from mpgcn_tpu_torch.obs.perf import compile_cache
    from mpgcn_tpu_torch.utils.profiling import trace_if

    ns = build_parser().parse_args(argv)
    try:
        device = resolve_device(ns.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve: {e}") from None
    if ns.profile:
        # the profile's contract wins for the model-shape knobs it declares
        from mpgcn_tpu_torch.scenarios.profiles import get_profile

        prof = get_profile(ns.profile)
        ns.obs_len = prof.obs_len
        ns.pred_len = prof.horizon
        ns.seed = prof.folded_seed
        ns.synthetic_N = prof.num_nodes
        print(f"[serve] scenario profile {prof.name!r}: obs_len="
              f"{prof.obs_len}, pred_len={prof.horizon}, N="
              f"{prof.num_nodes}, seed={prof.folded_seed}", flush=True)
    # the kernel-library directory before the engine builds anything
    compile_cache.enable(ns.compile_cache_dir or None)
    # the serving shapes resolve explicit flag > tuned profile of the
    # device's platform > guessed default (tune/registry.py; `tune
    # buckets --write` plans them from observed traffic)
    from mpgcn_tpu_torch.tune.registry import device_platform, tuned_or_default

    plat = device_platform(device)
    buckets = tuple(tuned_or_default(
        "serve_buckets",
        explicit=(tuple(int(b) for b in ns.buckets.split(",") if b.strip())
                  if ns.buckets is not None else None), platform=plat))
    if ns.horizons is not None:
        # an explicit flag (the empty single-horizon form included) is
        # never overridden by a profile
        horizons = tuple(int(h) for h in ns.horizons.split(",")
                         if h.strip())
    else:
        horizons = tuple(tuned_or_default("serve_horizons", platform=plat))
    if horizons:
        # the model config's pred_len covers the longest horizon
        ns.pred_len = max(ns.pred_len, max(horizons))
    scfg_kw = dict(
        output_dir=ns.output_dir, buckets=buckets, horizons=horizons,
        max_queue=ns.max_queue, max_wait_ms=ns.max_wait_ms,
        deadline_ms=ns.deadline_ms, double_buffer=ns.double_buffer,
        reload_poll_secs=ns.reload_poll_secs,
        canary_fraction=ns.canary_fraction,
        canary_requests=ns.canary_requests,
        reload_tolerance=ns.reload_tolerance,
        ledger_max_bytes=ns.ledger_max_bytes,
        capture_flows=ns.capture_flows)
    if ns.fleet:
        scfg = FleetConfig(**scfg_kw, tenant_max_inflight=ns.tenant_quota,
                           breaker_threshold=ns.breaker_threshold,
                           breaker_cooldown_s=ns.breaker_cooldown)
    else:
        scfg = ServeConfig(**scfg_kw)
    tcfg = MPGCNConfig(
        mode="test", data="synthetic", input_dir=ns.output_dir,
        output_dir=serve_dir(ns.output_dir), obs_len=ns.obs_len,
        pred_len=ns.pred_len, batch_size=ns.batch_size,
        hidden_dim=ns.hidden_dim, kernel_type=ns.kernel_type,
        cheby_order=ns.cheby_order, num_branches=ns.num_branches,
        seed=ns.seed, synthetic_N=ns.synthetic_N,
        synthetic_T=ns.synthetic_T, faults=ns.faults,
        infer_precision=ns.infer_precision,
        fused_epilogue=ns.fused_epilogue,
        support_payload=ns.support_payload)
    faults = FaultPlan.from_config(tcfg)
    cfg, data = _build_data(ns, tcfg)
    if ns.fleet:
        from mpgcn_tpu_torch.service.fleet import build_fleet

        engine, reloader = build_fleet(cfg, data, scfg, ns.output_dir,
                                       device=device, faults=faults,
                                       bdgcn_impl=ns.bdgcn_impl)
    else:
        engine = ServeEngine(cfg, data, scfg, device=device, faults=faults,
                             init_ckpt=ns.ckpt,
                             allow_fresh=ns.allow_fresh_init,
                             bdgcn_impl=ns.bdgcn_impl)
        reloader = CanaryReloader(engine, scfg, faults=faults)
    reloader.start()
    sampler = DeviceSampler().start()
    # the -trace window opens before the address is published, so every
    # request a client sends after reading http.json is in it
    window = contextlib.ExitStack()
    window.enter_context(trace_if(ns.trace_dir, device))

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

    httpd = _Server((ns.host, ns.port), _make_handler(engine))
    port = httpd.server_address[1]
    atomic_write_bytes(http_info_path(ns.output_dir), json.dumps(
        {"host": ns.host, "port": port, "pid": os.getpid()}).encode())
    print(f"[serve] listening on http://{ns.host}:{port} "
          f"(stats: /v1/stats, health: /healthz)", flush=True)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   daemon=True, name="mpgcn-serve-http")
    http_thread.start()

    stop = threading.Event()

    def _on_sig(signum, frame):
        name = signal.Signals(signum).name.encode()
        os.write(2, name + b" received: draining (finish in-flight, "
                        b"reject new) and exiting 0.\n")
        engine.begin_drain()
        stop.set()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _on_sig)
        except ValueError:
            pass
    flood = faults.take_flood()
    if flood:
        args = (flood,)
        if ns.fleet:
            # the flood targets one tenant's fault domain (fault_tenant
            # indexes the sorted ids)
            ids = sorted(engine.tenants)
            args = (ids[min(faults.fault_tenant, len(ids) - 1)], flood)
        threading.Thread(target=engine.inject_flood, args=args,
                         daemon=True, name="mpgcn-serve-flood").start()
    t0 = time.time()
    try:
        while not stop.is_set():
            stop.wait(0.2)
            # burn detection must not depend on anyone scraping
            engine.slo.tick()
            if ns.max_requests and engine.stats()["resolved"] >= \
                    ns.max_requests:
                engine.begin_drain()
                break
            if ns.serve_secs and time.time() - t0 >= ns.serve_secs:
                engine.begin_drain()
                break
    finally:
        window.close()  # the trace is written here
        reloader.stop()
        sampler.stop()
        drained = engine.drain(timeout=60.0)
        httpd.shutdown()
        httpd.server_close()
        if stop.is_set():
            # a signalled drain leaves a postmortem beside the ledgers
            flight.dump_to_dir(serve_dir(ns.output_dir),
                               reason="serve-sigterm-drain")
        for sig, h in prev.items():
            signal.signal(sig, h if h is not None else signal.SIG_DFL)
    print(f"[serve] drained ({'clean' if drained else 'TIMED OUT'}); "
          f"exiting 0.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
