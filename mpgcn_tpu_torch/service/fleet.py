"""The multi-tenant serving fleet (counterpart of
mpgcn_tpu/service/fleet.py): many tenants' models in one process, each
tenant its own fault domain.

  * **registry and routing** -- the tenants come from the crash-safe
    manifest (service/registry.py); each has the daemon layout of its own
    (its ``promoted/`` slot and promotions ledger), and a request names
    its ``tenant``. An unknown or unavailable tenant is a typed
    rejection.
  * **bulkheads** -- each tenant has its own micro-batcher queue per
    horizon and an in-flight quota (service/tenants.py): one tenant's
    overload sheds inside its own walls (``shed-tenant-quota``,
    ``shed-queue-full``).
  * **circuit breaker** -- consecutive model failures trip the tenant's
    breaker: its requests come back 429 (``rejected-breaker-open``)
    without touching the device, and a half-open probe recovers it.
  * **per-tenant canary reload** -- each tenant runs the whole reload
    protocol of service/reload.py (sequence check, integrity gate before
    placement, smoke eval, canary fraction, mid-flight rollback) against
    its own slot, through ``CanaryReloader`` driving a per-tenant view:
    one tenant's bad candidate rolls back alone.

**One set of graphs for every tenant.** The JAX fleet shares one
compiled executable per (bucket, horizon) and passes each tenant's
parameters as arguments. The port's CUDA graphs read the weights where
they lie (train/graphs.py), so the fleet keeps one *execution model*
(one ``MPGCN`` of the fleet's config and, under ``-infer-precision
int8``, its quantized tree) whose rollouts are captured once per
(bucket, horizon) at startup: ``stats()["traces"]`` is |buckets| x
|horizons| with one tenant or many, and requests, reloads, rollbacks and
a tenant's recovery add none. Each tenant keeps its incumbent (and,
during a reload, its canary) resident on the device at the fleet's
inference precision: f32 weights, or the int8 codes and scales. A batch
takes the device lock, copies the chosen set into the execution model's
tensors in place (one ``torch._foreach_copy_`` a dtype), then replays; where
nothing is captured (the CPU, the ELL arm: graphs.py ``refusal``) the
same execution model runs the eager rollout after the same copy. Lock
order: a tenant's lock, released, then the device lock; nothing takes a
tenant lock while it holds the device lock.

Every tenant must fit the fleet's model config (N, obs_len, branches):
the support banks and the graphs are shared, what differs is the
parameter set. Not ported: the JAX fleet's mesh-degradation ladder
(``mesh_rungs``; multi-device, ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import FleetConfig, MPGCNConfig, default_slos
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.mpgcn import MPGCN, infer_dtype_of
from mpgcn_tpu_torch.obs import flight
from mpgcn_tpu_torch.obs.metrics import (
    MetricsRegistry,
    default_registry,
    program_builds,
    render_prometheus,
)
from mpgcn_tpu_torch.obs.perf.slo import SLOEngine
from mpgcn_tpu_torch.obs.trace import SpanLog, new_span_id, new_trace_id, spans_path
from mpgcn_tpu_torch.quant.int8 import (
    QuantizedTensor,
    quantization_error,
    quantize_params,
)
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service.batcher import (
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
from mpgcn_tpu_torch.service.registry import TenantRegistry
from mpgcn_tpu_torch.service.reload import (
    CanaryReloader,
    promoted_seq,
    validate_candidate,
)
from mpgcn_tpu_torch.service.serve import (
    KERNELS,
    requests_ledger_path,
    reloads_ledger_path,
    serve_dir,
)
from mpgcn_tpu_torch.service.tenants import (
    BREAKER_FAILURE_OUTCOMES,
    CLOSED,
    REJECT_BREAKER_OPEN,
    REJECT_TENANT_UNAVAILABLE,
    REJECT_UNKNOWN_TENANT,
    SHED_TENANT_QUOTA,
    CircuitBreaker,
    TenantQuota,
)
from mpgcn_tpu_torch.train.graphs import (
    GraphSet,
    Precision,
    RolloutGraphs,
    refusal,
)
from mpgcn_tpu_torch.train.predict import rollout
from mpgcn_tpu_torch.utils.convert import params_from_jax
from mpgcn_tpu_torch.utils.logging import JsonlLogger


class _ParamSet:
    """One resident parameter set of a tenant and its provenance:
    ``params`` is ``{name: tensor or QuantizedTensor}`` on the fleet's
    device (a plain attribute: swapping it changes what the tenant
    serves), with the slot-file hash, the promotions-ledger sequence and
    the probe loss."""

    __slots__ = ("params", "hash", "seq", "probe_loss")

    def __init__(self, params: dict, hash_: str, seq: int,
                 probe_loss: Optional[float] = None):
        self.params = params
        self.hash = hash_
        self.seq = seq
        self.probe_loss = probe_loss


def _tree_bytes(params: dict) -> int:
    return int(sum(v.nbytes if isinstance(v, QuantizedTensor)
                   else v.numel() * v.element_size()
                   for v in params.values()))


def _flat(params: dict, names) -> list:
    """The tensors of ``params`` in ``names`` order (an int8 entry as its
    codes, then its scales)."""
    out = []
    for n in names:
        v = params[n]
        if isinstance(v, QuantizedTensor):
            out += [v.q, v.scale]
        else:
            out.append(v)
    return out


def _by_dtype(tensors: list) -> dict:
    """``tensors`` grouped by dtype, in order: the operand lists of the
    in-place copy (``torch._foreach_copy_`` takes one launch for a list
    of one dtype; a list of mixed dtypes copies tensor by tensor)."""
    out: dict = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


class _TenantState:
    """What one tenant owns: its parameter sets, bulkhead, breaker,
    batchers and reload bookkeeping, changed under its own lock."""

    def __init__(self, tenant_id: str, root: str, model: str,
                 quota_limit: int, breaker: CircuitBreaker):
        self.id = tenant_id
        self.root = root
        self.slot_path = promoted_path(root, model)
        self.promotions_ledger_path = ledger_path(root)
        self.lock = threading.Lock()
        self.incumbent: Optional[_ParamSet] = None
        self.canary: Optional[_ParamSet] = None
        self.canary_left = 0
        self.bad_hashes: set[str] = set()
        self.quota = TenantQuota(quota_limit)
        self.breaker = breaker
        # one MicroBatcher per served horizon (a batch shares its length)
        self.batchers: dict[int, MicroBatcher] = {}
        self.scenario: Optional[str] = None  # a registry scenario label
        self.support_payload: Optional[str] = None  # as registered
        self.default_horizon: Optional[int] = None
        self.unavailable_reason: Optional[str] = None
        self.resident_bytes = 0
        self.lat_ms: deque[float] = deque(maxlen=2048)
        self.lat_by_h: dict[int, deque] = {}
        self.lat_hist = None  # the per-tenant histogram child

    @property
    def available(self) -> bool:
        with self.lock:
            return self.incumbent is not None or self.canary is not None


class _TenantLog:
    """Tags every reload-ledger row a tenant's reloader writes with the
    tenant, so the fleet's one reloads.jsonl names each fault domain."""

    __slots__ = ("_log", "_tenant")

    def __init__(self, log: JsonlLogger, tenant: str):
        self._log = log
        self._tenant = tenant

    def log(self, event: str, **fields) -> None:
        self._log.log(event, tenant=self._tenant, **fields)


class _TenantView:
    """The engine surface ``CanaryReloader`` drives, scoped to one
    tenant's slot, ledger and parameter sets (read under its lock)."""

    def __init__(self, fleet: "FleetEngine", ts: _TenantState):
        self._fleet = fleet
        self._ts = ts
        self.cfg = fleet.cfg
        self.slot_path = ts.slot_path
        self.promotions_ledger_path = ts.promotions_ledger_path
        self.reload_log = _TenantLog(fleet.reload_log, ts.id)
        self.span_log = fleet.span_log

    @property
    def bad_hashes(self) -> set:
        return self._ts.bad_hashes

    @property
    def incumbent_hash(self) -> str:
        with self._ts.lock:
            return self._ts.incumbent.hash if self._ts.incumbent else ""

    @property
    def incumbent_seq(self) -> int:
        with self._ts.lock:
            return self._ts.incumbent.seq if self._ts.incumbent else -1

    @property
    def incumbent_probe_loss(self) -> Optional[float]:
        with self._ts.lock:
            return (self._ts.incumbent.probe_loss
                    if self._ts.incumbent else None)

    @property
    def canary_hash(self) -> Optional[str]:
        with self._ts.lock:
            return self._ts.canary.hash if self._ts.canary else None

    def _place(self, host_tree) -> dict:
        return self._fleet._place(host_tree)

    def probe_loss(self, params: dict) -> float:
        return self._fleet.probe_loss(params)

    def note_reload_rollback(self) -> None:
        self._fleet._count_reload(self._ts.id, "rolled_back")

    def install_canary(self, params, hash_: str, seq: int,
                       probe_loss: Optional[float] = None) -> None:
        self._fleet.install_canary(self._ts.id, params, hash_, seq,
                                   probe_loss=probe_loss)


class FleetEngine:
    """The multi-tenant serving core on ``device``. ``cfg`` and ``data``
    give the shared model architecture and support banks (every tenant
    must fit them); ``registry`` names the tenants and their slots.
    ``bdgcn_impl`` picks the BDGCN arm as for ``ModelTrainer``."""

    def __init__(self, cfg: MPGCNConfig, data: dict, fcfg: FleetConfig,
                 registry: TenantRegistry, device="cuda",
                 faults: Optional[FaultPlan] = None,
                 bdgcn_impl: str = "auto"):
        self.device = resolve_device(device)
        self.fcfg = self.scfg = fcfg  # scfg: the reloader's name for it
        self.registry = registry
        self._faults = faults if faults is not None else FaultPlan.parse("")
        self.horizons = tuple(fcfg.horizons) or (cfg.pred_len,)
        if max(self.horizons) > cfg.pred_len:
            raise ValueError(
                f"horizons={self.horizons} exceed the fleet model "
                f"config's pred_len={cfg.pred_len}")
        self._default_horizon = (cfg.pred_len if cfg.pred_len in
                                 self.horizons else self.horizons[-1])
        self._probe_h = self.horizons[-1]
        root = fcfg.output_dir
        os.makedirs(serve_dir(root), exist_ok=True)
        self.request_log = JsonlLogger(requests_ledger_path(root),
                                       rotate_max_bytes=fcfg.ledger_max_bytes)
        self.reload_log = JsonlLogger(reloads_ledger_path(root),
                                      rotate_max_bytes=fcfg.ledger_max_bytes)
        self.span_log = SpanLog(spans_path(root),
                                rotate_max_bytes=fcfg.ledger_max_bytes)

        # --- the shared execution model and banks ----------------------
        pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        self.cfg = cfg = cfg.replace(num_nodes=pipeline.num_nodes)
        self.pipeline = pipeline
        self.banks = pipeline.banks
        self.model = MPGCN.from_config(
            cfg, device=self.device,
            bdgcn_impl=pipeline.bdgcn_impl).eval()
        print(pipeline.dispatch_line(self.model.lstm_impl))
        self.infer_precision = cfg.resolved_infer_precision
        self._quant_err_last = 0.0
        weights = dict(self.model.named_parameters())
        self._names = list(weights)
        self._shapes = {n: tuple(w.shape) for n, w in weights.items()}
        qtree = (quantize_params(weights)
                 if self.infer_precision == "int8" else None)
        self._precision = Precision(self.infer_precision,
                                    infer_dtype_of(cfg), qtree)
        # the execution model's tensors the in-place copy writes: the
        # int8 tree's codes and scales (its dense entries are the module's
        # own), else the module's weights
        self._dst = _by_dtype(_flat(qtree if qtree is not None else weights,
                                    self._names))

        # --- the probe batch (smoke evals, flood requests) -------------
        md = pipeline.modes["test"]
        n = min(len(md), fcfg.buckets[-1])
        self._probe_bucket = pick_bucket(n, fcfg.buckets)
        sel = np.arange(n)
        sel = np.concatenate([sel, np.full(self._probe_bucket - n,
                                           sel[-1])]).astype(int)
        px, py = pipeline.gather_xy("test", sel)
        self._probe_x = np.asarray(px, np.float32)
        self._probe_y = np.asarray(py, np.float32)
        self._probe_keys = np.asarray(md.keys[sel], np.int32)
        self._probe_n = n

        self._batch_seq = 0
        self._batch_seq_lock = threading.Lock()
        self._submit_seq = itertools.count(1)
        self._captured_rows: dict[str, int] = {}
        self._captured_lock = threading.Lock()
        self.startup_s = 0.0
        self._warmup()

        # --- metrics ------------------------------------------------------
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "serve_requests", "resolved requests by tenant + typed "
            "outcome")
        self._m_req_children: dict[tuple, object] = {}
        self._m_latency = self.metrics.histogram(
            "serve_request_latency_ms", "accepted-request latency (ms), "
            "all tenants")
        self._m_reloads = self.metrics.counter(
            "serve_reloads", "hot-reload verdicts by tenant")
        self._m_breaker = self.metrics.gauge(
            "serve_breaker_state", "per-tenant circuit breaker "
            "(0=closed, 1=half-open, 2=open)")
        self._m_resident = self.metrics.gauge(
            "serve_tenant_resident_bytes", "per-tenant resident "
            "parameter bytes on the device (int8 codes and scales under "
            "infer_precision int8)")
        self._m_quota_shed = self.metrics.counter(
            "serve_tenant_quota_shed", "per-tenant quota-bulkhead sheds")
        self._m_scenario = self.metrics.gauge(
            "serve_tenant_scenario", "scenario label per tenant (1 with "
            "tenant and scenario labels)")
        self.metrics.gauge(
            "serve_traces", "programs prepared at startup (captured CUDA "
            "graphs of the shared execution model; eager warm-up runs "
            "where nothing is captured): requests, reloads and tenants "
            "add none").set_fn(lambda: self.trace_count)
        self.metrics.gauge(
            "serve_mesh_devices", "devices of the active mesh rung (0 = "
            "single-device serving)").set_fn(lambda: 0.0)
        self.metrics.gauge(
            "serve_tenants_resident", "registered tenants currently "
            "serving (incumbent or canary resident)").set_fn(
            lambda: float(sum(ts.available
                              for ts in self.tenants.values())))
        program_builds()  # the retrace objective's series
        flight.add_metrics_provider("fleet", self.metrics.snapshot)
        self.slo = SLOEngine(default_slos("serve"),
                             [self.metrics, default_registry()],
                             export_registry=self.metrics,
                             output_dir=serve_dir(root))

        # --- tenants ------------------------------------------------------
        self._draining = False
        self.tenants: dict[str, _TenantState] = {}
        self._views: dict[str, _TenantView] = {}
        for idx, tid in enumerate(registry.ids()):
            self._add_tenant(idx, tid, registry.tenants[tid])
        self.request_log.log(
            "fleet_start", tenants=registry.ids(),
            available=[t for t, ts in self.tenants.items()
                       if ts.available],
            buckets=list(fcfg.buckets), horizons=list(self.horizons),
            mesh_rungs=[], infer_precision=self.infer_precision,
            traces=self.trace_count)

    # --- the shared programs ------------------------------------------------

    def _warmup(self) -> None:
        """Prepare every (bucket, horizon) once on the execution model: on
        the card its rollout is captured after an eager warm-up run; where
        nothing is captured, each pair runs once eagerly."""
        N, T = self.cfg.num_nodes, self.cfg.obs_len
        t0 = time.perf_counter()
        self._graphs = None
        self._rollouts = None
        self._warm_runs = 0
        self.graph_bytes = {"allocated": 0, "reserved": 0}
        why = refusal(self.device, self.pipeline.bdgcn_impl)
        if why is None:
            gs = self._graphs = GraphSet(self.device,
                                         self.pipeline.bdgcn_impl)
            self._device_lock = gs.lock
            self._rollouts = RolloutGraphs(gs, self.model, self.banks)
            m0 = (torch.cuda.memory_allocated(self.device),
                  torch.cuda.memory_reserved(self.device))
            self._rollouts.capture_all(self.fcfg.buckets, self.horizons,
                                       T, N, self._precision)
            self.graph_bytes = {
                "allocated": torch.cuda.memory_allocated(self.device) - m0[0],
                "reserved": torch.cuda.memory_reserved(self.device) - m0[1]}
            self.startup_s = time.perf_counter() - t0
            print(f"[fleet] captured {len(gs.graphs)} rollout graphs of one "
                  f"execution model (buckets {list(self.fcfg.buckets)} x "
                  f"horizons {list(self.horizons)}, infer_precision="
                  f"{self.infer_precision}) in {self.startup_s:.2f}s; every "
                  f"tenant replays them on its resident parameters",
                  flush=True)
            return
        self._device_lock = threading.RLock()
        prec = self._precision
        for b in self.fcfg.buckets:
            x = torch.zeros((b, T, N, N, 1), device=self.device)
            k = torch.zeros((b,), dtype=torch.long, device=self.device)
            for h in self.horizons:
                rollout(self.model, self.banks, x, k, h, prec.dtype,
                        prec.params)
                self._warm_runs += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.startup_s = time.perf_counter() - t0
        print(f"[fleet] rollout graphs: none ({why}); every batch copies its "
              f"tenant's parameters into the execution model and runs the "
              f"eager rollout", flush=True)

    @property
    def trace_count(self) -> int:
        """Programs prepared at startup: the captured graphs (counted live),
        else the eager warm-up runs."""
        if self._graphs is not None:
            return len(self._graphs.graphs)
        return self._warm_runs

    # --- placement and the shared run ---------------------------------------

    def _place(self, host_tree) -> dict:
        """A host params tree (the JAX layout) as a resident parameter set:
        device tensors at the fleet's inference precision (int8: its codes
        and scales, quantized on the host as the JAX package does). The
        integrity gate (reload.validate_candidate) runs before this on
        every load path."""
        state = params_from_jax(host_tree)
        if set(state) != set(self._names):
            missing = sorted(set(self._names) - set(state))
            extra = sorted(set(state) - set(self._names))
            raise ValueError(f"parameter tree does not fit the fleet's "
                             f"model: missing {missing[:4]}, unexpected "
                             f"{extra[:4]}")
        for n, v in state.items():
            if tuple(v.shape) != self._shapes[n]:
                raise ValueError(f"parameter {n} has shape "
                                 f"{tuple(v.shape)}, the fleet's model "
                                 f"{self._shapes[n]}")
        state = {n: state[n].float() for n in self._names}
        if self.infer_precision == "int8":
            q = quantize_params(state)
            self._quant_err_last = quantization_error(
                state, q)["max_abs_error"]
            return {n: v.to(self.device) for n, v in q.items()}
        return {n: v.to(self.device) for n, v in state.items()}

    def _copy_in(self, params: dict) -> None:
        """Copy a resident set into the execution model in place, one
        ``torch._foreach_copy_`` a dtype; the caller holds the device
        lock."""
        src = _by_dtype(_flat(params, self._names))
        with torch.no_grad():
            for dtype, dst in self._dst.items():
                torch._foreach_copy_(dst, src[dtype])

    def _run(self, params: dict, x, keys, horizon: int) -> np.ndarray:
        """``params``' rollout of a padded host batch (x, keys) through the
        shared programs; the forecast on the host."""
        prec = self._precision
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        kt = torch.from_numpy(np.asarray(keys, np.int64))
        with self._device_lock:
            self._copy_in(params)
            if self._rollouts is not None:
                return self._rollouts.replay(xt, kt, horizon, prec).numpy()
            return rollout(self.model, self.banks, xt.to(self.device),
                           kt.to(self.device), horizon, prec.dtype,
                           prec.params).float().cpu().numpy()

    def probe_loss(self, params: dict) -> float:
        """Masked MSE of a resident set on the pinned probe batch, through
        the probe bucket's program at the longest horizon."""
        preds = self._run(params, self._probe_x, self._probe_keys,
                          self._probe_h)
        n = self._probe_n
        d = preds[:n] - self._probe_y[:n, :self._probe_h]
        return float(np.mean(d * d))

    # --- tenant lifecycle -----------------------------------------------------

    def _add_tenant(self, idx: int, tid: str, entry: dict) -> None:
        quota = int(entry.get("quota", self.fcfg.tenant_max_inflight))
        breaker_child = self._m_breaker.labels(tenant=tid)
        lat_child = self._m_latency.labels(tenant=tid)
        breaker = CircuitBreaker(
            self.fcfg.breaker_threshold, self.fcfg.breaker_cooldown_s,
            on_transition=lambda s, c=breaker_child: c.set(float(s)))
        breaker_child.set(float(CLOSED))
        ts = _TenantState(tid, entry["root"], self.cfg.model, quota,
                          breaker)
        ts.lat_hist = lat_child
        ts.scenario = entry.get("scenario")
        ts.support_payload = entry.get("support_payload")
        if ts.scenario:
            self._m_scenario.labels(tenant=tid,
                                    scenario=str(ts.scenario)).set(1.0)
        # an entry's scenario horizon is the tenant's default where it is
        # served; otherwise the fleet-wide default
        th = entry.get("horizon")
        ts.default_horizon = (int(th)
                              if isinstance(th, int)
                              and not isinstance(th, bool)
                              and int(th) in self.horizons
                              else self._default_horizon)
        if self._faults.take_corrupt_tenant_slot(idx):
            _truncate_file(ts.slot_path)
        self._load_incumbent(ts)
        ts.lat_by_h = {h: deque(maxlen=2048) for h in self.horizons}
        for h in self.horizons:
            # the per-tenant feed: no stage_fn (the JAX fleet's neither);
            # the graph's replay uploads the batch
            ts.batchers[h] = MicroBatcher(
                self._make_run_batch(ts, h), self.fcfg.buckets,
                self.fcfg.max_queue, self.fcfg.max_wait_ms,
                double_buffer=self.fcfg.double_buffer)
            ts.batchers[h].start()
        self.tenants[tid] = ts
        self._views[tid] = _TenantView(self, ts)

    def _load_incumbent(self, ts: _TenantState) -> None:
        """Load, validate and place a tenant's promoted slot; on any failure
        the tenant starts unavailable (typed 503s) and its reloader keeps
        polling the slot, so a good promotion recovers it."""
        if not os.path.exists(ts.slot_path):
            ts.unavailable_reason = "no promoted checkpoint yet"
            self.request_log.log("tenant_unavailable", tenant=ts.id,
                                 reason=ts.unavailable_reason)
            return
        try:
            for _ in range(5):
                h = candidate_hash(ts.slot_path)
                # the gate before placement: integrity and branch spec on
                # host bytes; nothing reaches the device for a bad slot
                ckpt = validate_candidate(
                    ts.slot_path, num_branches=self.cfg.num_branches,
                    branch_sources=self.cfg.resolved_branch_sources)
                if candidate_hash(ts.slot_path) == h:
                    break
            else:
                raise RuntimeError("slot kept changing underneath the "
                                   "startup load (5 attempts)")
            seq = promoted_seq(ts.promotions_ledger_path, h)
            pset = _ParamSet(self._place(ckpt["params"]), h,
                             -1 if seq is None else seq)
            pset.probe_loss = self.probe_loss(pset.params)
            with ts.lock:
                ts.incumbent = pset
                ts.resident_bytes = _tree_bytes(pset.params)
            self._m_resident.labels(tenant=ts.id).set(ts.resident_bytes)
            ts.unavailable_reason = None
        except Exception as e:
            ts.unavailable_reason = f"{type(e).__name__}: {e}"[:300]
            self.request_log.log("tenant_unavailable", tenant=ts.id,
                                 reason=ts.unavailable_reason)
            print(f"[fleet] tenant {ts.id} UNAVAILABLE at startup "
                  f"({ts.unavailable_reason}); its slot keeps being "
                  f"polled -- a good promotion recovers it.", flush=True)

    def make_reloaders(self) -> dict:
        """One CanaryReloader per tenant over its view. The fault plan
        rides only the targeted tenant's (``fault_tenant``, an index into
        the sorted ids), so e.g. poison_reload poisons one fault domain."""
        out = {}
        for idx, tid in enumerate(sorted(self.tenants)):
            faults = (self._faults
                      if (self._faults.active
                          and idx == self._faults.fault_tenant)
                      else None)
            out[tid] = CanaryReloader(self._views[tid], self.fcfg,
                                      faults=faults)
        return out

    # --- reloads ----------------------------------------------------------

    def install_canary(self, tid: str, params, hash_: str, seq: int,
                       probe_loss: Optional[float] = None) -> None:
        """Serve ``params`` (a resident set ``_place`` made, or a host tree
        to place) to tenant ``tid``'s canary fraction; ``canary_requests``
        0 promotes at once."""
        ts = self.tenants[tid]
        if isinstance(params, dict) and "branches" in params:
            params = self._place(params)
        cand = _ParamSet(params, hash_, seq, probe_loss)
        with ts.lock:
            ts.canary = cand
            ts.canary_left = self.fcfg.canary_requests
            if ts.canary_left <= 0:
                self._promote_canary_locked(ts)
        ts.unavailable_reason = None

    def _promote_canary_locked(self, ts: _TenantState) -> None:
        prev = ts.incumbent
        ts.incumbent = ts.canary
        ts.canary = None
        ts.resident_bytes = _tree_bytes(ts.incumbent.params)
        self._m_resident.labels(tenant=ts.id).set(ts.resident_bytes)
        self._count_reload(ts.id, "promoted")
        self.reload_log.log("reload_promoted", tenant=ts.id,
                            hash=ts.incumbent.hash, seq=ts.incumbent.seq,
                            previous=prev.hash if prev else None)
        print(f"[fleet] tenant {ts.id}: reload PROMOTED "
              f"{ts.incumbent.hash[:12]} (seq {ts.incumbent.seq})",
              flush=True)

    def _rollback_canary_locked(self, ts: _TenantState,
                                reason: str) -> None:
        bad = ts.canary
        ts.canary = None
        ts.bad_hashes.add(bad.hash)
        self._count_reload(ts.id, "rolled_back")
        self.reload_log.log("reload_rollback", tenant=ts.id,
                            hash=bad.hash, seq=bad.seq, reason=reason)
        print(f"[fleet] tenant {ts.id}: canary ROLLED BACK ({reason}); "
              f"incumbent keeps serving.", flush=True)

    def _count_reload(self, tid: str, verdict: str) -> None:
        self._m_reloads.labels(tenant=tid, verdict=verdict).inc()

    def _canary_stride(self) -> int:
        return max(1, round(1.0 / self.fcfg.canary_fraction))

    # --- request path -----------------------------------------------------

    def _snapshot(self, ts: _TenantState, seq: int):
        """(use_canary, pset, params) under the tenant lock."""
        with ts.lock:
            use_canary = (ts.canary is not None
                          and (ts.incumbent is None
                               or seq % self._canary_stride() == 0))
            pset = ts.canary if use_canary else ts.incumbent
            params = pset.params if pset is not None else None
        return use_canary, pset, params

    def _make_run_batch(self, ts: _TenantState, horizon: int):
        """One (tenant, horizon) batcher seam: the tenant's canary or
        incumbent through the shared programs, the canary's output
        policed."""

        def run_batch(x, keys, bucket: int, n_live: int):
            with self._batch_seq_lock:
                self._batch_seq += 1
                seq = self._batch_seq
            self._faults.maybe_slow_request(seq)
            use_canary, pset, params = self._snapshot(ts, seq)
            if pset is None:
                # a canary-only tenant whose canary rolled back while these
                # tickets queued
                raise RuntimeError(
                    f"tenant {ts.id} has no servable model (canary "
                    f"rolled back mid-flight); retry after its daemon "
                    f"promotes a candidate")
            preds = self._run(params, x, keys, horizon)
            if use_canary:
                if not np.all(np.isfinite(preds)):
                    with ts.lock:
                        if ts.canary is pset:
                            self._rollback_canary_locked(
                                ts, "non-finite canary output on live "
                                    "traffic")
                        inc = ts.incumbent
                        inc_params = inc.params if inc is not None else None
                    if inc_params is None:
                        # nothing to serve again on: the batcher types
                        # these rows error-nonfinite, for this tenant only
                        return preds, False
                    return self._run(inc_params, x, keys, horizon), False
                with ts.lock:
                    if ts.canary is pset:
                        ts.canary_left -= n_live
                        if ts.canary_left <= 0:
                            self._promote_canary_locked(ts)
            return preds, use_canary

        return run_batch

    def _note(self, ts: _TenantState, t: Ticket) -> None:
        """Resolution hook: per-tenant counters, quota release, breaker
        feedback, one ledger row and the span chain."""
        if t._quota_held:
            ts.quota.release()
        key = (ts.id, t.outcome)
        child = self._m_req_children.get(key)
        if child is None:
            child = self._m_req_children[key] = self._m_requests.labels(
                tenant=ts.id, outcome=t.outcome)
        child.inc()
        if t._breaker_probe:
            # the probe's fate decides recovery; a non-model outcome
            # aborts so the next request can probe
            if t.outcome == OK:
                ts.breaker.probe_result(ok=True)
            elif t.outcome in BREAKER_FAILURE_OUTCOMES:
                ts.breaker.probe_result(ok=False)
            else:
                ts.breaker.probe_abort()
        elif t.outcome in BREAKER_FAILURE_OUTCOMES:
            ts.breaker.record(ok=False)
        elif t.outcome == OK:
            ts.breaker.record(ok=True)
        if t.outcome == OK:
            self._m_latency.observe(t.latency_ms)
            if ts.lat_hist is not None:
                ts.lat_hist.observe(t.latency_ms)
            with ts.lock:
                ts.lat_ms.append(t.latency_ms)
                lat_h = ts.lat_by_h.get(t.horizon)
                if lat_h is not None:
                    lat_h.append(t.latency_ms)
        extra = {}
        if (self.fcfg.capture_flows and t.outcome == OK
                and t.day_slot is not None):
            extra = capture_row_fields(t.x, t.day_slot)
            if extra:
                with self._captured_lock:
                    self._captured_rows[ts.id] = \
                        self._captured_rows.get(ts.id, 0) + 1
        self.request_log.log("request", tenant=ts.id, outcome=t.outcome,
                             latency_ms=round(t.latency_ms, 3),
                             bucket=t.bucket, canary=t.canary,
                             horizon=t.horizon, trace=t.trace,
                             **({"error": t.error} if t.error else {}),
                             **extra)
        rows = [dict(name="serve.request", trace=t.trace, span=t.span,
                     t0=t.t_wall, dur_ms=t.latency_ms, tenant=ts.id,
                     outcome=t.outcome,
                     **({"error": t.error} if t.error else {}))]
        if t.queue_ms is not None:
            bspan = new_span_id()
            rows.append(dict(name="serve.batcher", trace=t.trace,
                             span=bspan, parent=t.span, t0=t.t_wall,
                             dur_ms=t.queue_ms, tenant=ts.id,
                             batch=t.batch_seq))
            if t.model_ms is not None:
                rows.append(dict(name="serve.model", trace=t.trace,
                                 parent=bspan,
                                 t0=t.t_wall + t.queue_ms / 1e3,
                                 dur_ms=t.model_ms, bucket=t.bucket,
                                 tenant=ts.id, canary=t.canary))
        self.span_log.emit_many(rows)

    def submit(self, tenant: Optional[str], x, key,
               deadline_ms: Optional[float] = None,
               trace: Optional[str] = None,
               horizon: Optional[int] = None,
               day_slot: Optional[int] = None) -> Ticket:
        """Admit one forecast request for ``tenant`` at ``horizon`` (None:
        the tenant's default). Always returns a ticket that resolves;
        every wall (unknown tenant, unserved horizon, draining,
        unavailable tenant, open breaker, invalid input, quota, queue,
        deadline) is a typed outcome, in the JAX fleet's order."""
        if self._faults.take_poison_request(next(self._submit_seq)):
            # the adversarial-traffic arm: the gate must shed it
            from mpgcn_tpu_torch.scenarios.dynamics import poison_request

            x = poison_request(x)
        if tenant is None and len(self.tenants) == 1:
            tenant = next(iter(self.tenants))
        ts = self.tenants.get(tenant) if tenant is not None else None
        dl = self.fcfg.deadline_ms if deadline_ms is None else deadline_ms
        if ts is None:
            t = Ticket(x, key if isinstance(key, int) else 0)
            t.trace = trace or new_trace_id()
            t.span = new_span_id()
            t.horizon = (self._default_horizon if horizon is None
                         else horizon)
            t.resolve(REJECT_UNKNOWN_TENANT,
                      error=f"unknown tenant {tenant!r} (registered: "
                            f"{sorted(self.tenants)})")
            self._count_unrouted(t)
            return t
        h = (ts.default_horizon or self._default_horizon) \
            if horizon is None else horizon
        t = Ticket(x, key if isinstance(key, int) else 0,
                   deadline_s=dl / 1e3 if dl else None,
                   on_resolve=lambda tk, ts=ts: self._note(ts, tk))
        t.tenant = ts.id
        t.trace = trace or new_trace_id()
        t.span = new_span_id()
        t.horizon = h
        if day_slot is not None:
            t.day_slot = int(day_slot)
        if h not in ts.batchers:
            t.resolve(REJECT_INVALID,
                      error=f"horizon {horizon!r} is not served (served "
                            f"horizons: {list(self.horizons)})")
            return t
        if self._draining:
            t.resolve(REJECT_DRAINING, error="server draining")
            return t
        if not ts.available:
            t.resolve(REJECT_TENANT_UNAVAILABLE,
                      error=f"tenant {tenant} has no servable model "
                            f"({ts.unavailable_reason})")
            return t
        admitted, is_probe = ts.breaker.allow()
        if not admitted:
            t.resolve(REJECT_BREAKER_OPEN,
                      error=f"tenant {tenant} circuit breaker is "
                            f"{ts.breaker.state_name} (consecutive "
                            f"model failures); retry after cooldown")
            return t
        t._breaker_probe = is_probe
        verdict = validate_request(x, key, self.cfg.obs_len,
                                   self.cfg.num_nodes)
        if not verdict["ok"]:
            t.resolve(REJECT_INVALID, error=verdict["reason"])
            return t
        with np.errstate(over="ignore"):  # overflow is rejected just below
            arr = np.asarray(x, np.float32)
        if not np.all(np.isfinite(arr)):
            t.resolve(REJECT_INVALID,
                      error="values overflow float32 (non-finite after "
                            "cast)")
            return t
        if not ts.quota.acquire():
            self._m_quota_shed.labels(tenant=ts.id).inc()
            t.resolve(SHED_TENANT_QUOTA,
                      error=f"tenant {tenant} in-flight quota "
                            f"({ts.quota.limit}) exhausted (bulkhead "
                            f"shed)")
            return t
        t._quota_held = True  # released in _note at resolution
        t.x = arr[..., None] if arr.ndim == 3 else arr
        t.key = int(key)
        return ts.batchers[h].submit(t)

    def _count_unrouted(self, t: Ticket) -> None:
        child = self._m_req_children.get((None, t.outcome))
        if child is None:
            child = self._m_req_children[(None, t.outcome)] = \
                self._m_requests.labels(tenant="_unrouted",
                                        outcome=t.outcome)
        child.inc()
        self.request_log.log("request", tenant=None, outcome=t.outcome,
                             latency_ms=round(t.latency_ms, 3),
                             trace=t.trace, error=t.error)

    def inject_flood(self, tenant: str, n: int) -> None:
        """``n`` gate-valid requests into one tenant's walls: its quota and
        queue must shed typed while every other tenant stays clean."""
        x = np.abs(self._probe_x[0, ..., 0])
        for _ in range(n):
            self.submit(tenant, x, int(self._probe_keys[0]))

    # --- lifecycle and observability -----------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        self._draining = True

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        self._draining = True
        ok = True
        for ts in self.tenants.values():
            for b in ts.batchers.values():
                ok = b.drain(timeout=timeout) and ok
        self.request_log.log("fleet_stop", drained=ok,
                             traces=self.trace_count)
        return ok

    def close(self) -> None:
        for ts in self.tenants.values():
            for b in ts.batchers.values():
                b.stop()

    @property
    def incumbent_hash(self) -> str:
        """The sorted tenant:hash map, for /healthz."""
        return ",".join(f"{tid}:{(self._views[tid].incumbent_hash or '')[:12]}"
                        for tid in sorted(self.tenants))

    @property
    def canary_hash(self) -> Optional[str]:
        cans = {tid: v.canary_hash for tid, v in self._views.items()
                if v.canary_hash}
        return ",".join(f"{t}:{h[:12]}" for t, h in sorted(cans.items())) \
            or None

    @staticmethod
    def _pct(lats: list, q: float) -> Optional[float]:
        """Nearest rank, as the JAX package's obs/stats.py computes it."""
        if not lats:
            return None
        return round(lats[min(len(lats) - 1, int(len(lats) * q))], 3)

    def stats(self) -> dict:
        """The /v1/stats payload: fleet totals and a section per tenant,
        the JAX keys, with the port's device, graph bytes and kernel
        launch counts."""
        counts: dict[str, dict] = {}
        total = 0
        for key, v in self._m_requests.series().items():
            if not key:
                continue
            lbl = dict(key)
            counts.setdefault(lbl.get("tenant", "?"), {})[
                lbl.get("outcome", "?")] = int(v)
            total += int(v)
        tenants = {}
        for tid, ts in sorted(self.tenants.items()):
            with ts.lock:
                inc, can = ts.incumbent, ts.canary
                lats = sorted(ts.lat_ms)
                lats_h = {h: sorted(d) for h, d in ts.lat_by_h.items()
                          if d}
            tenants[tid] = {
                "available": ts.available,
                **({"scenario": ts.scenario} if ts.scenario else {}),
                **({"support_payload": ts.support_payload}
                   if ts.support_payload else {}),
                "outcomes": counts.get(tid, {}),
                "breaker": ts.breaker.state_name,
                "breaker_trips": ts.breaker.trips,
                "quota": {"limit": ts.quota.limit,
                          "inflight": ts.quota.inflight,
                          "shed": ts.quota.shed},
                "resident_bytes": ts.resident_bytes,
                "queue_depth": sum(b.depth()
                                   for b in ts.batchers.values()),
                "incumbent": ({"hash": inc.hash, "seq": inc.seq}
                              if inc else None),
                "canary": ({"hash": can.hash, "left": ts.canary_left}
                           if can else None),
                "latency_ms": {"p50": self._pct(lats, 0.5),
                               "p99": self._pct(lats, 0.99),
                               "n": len(lats)},
                **({"latency_ms_by_horizon": {
                        str(h): {"p50": self._pct(hl, 0.5),
                                 "p99": self._pct(hl, 0.99),
                                 "n": len(hl)}
                        for h, hl in sorted(lats_h.items())}}
                   if lats_h else {}),
                **({"unavailable_reason": ts.unavailable_reason}
                   if ts.unavailable_reason else {}),
                **({"captured_rows": self._captured_rows.get(tid, 0)}
                   if self.fcfg.capture_flows else {}),
            }
        return {
            "fleet": True,
            "resolved": total,
            "capture": {"enabled": self.fcfg.capture_flows,
                        "rows": sum(self._captured_rows.values())},
            "tenants": tenants,
            "traces": self.trace_count,
            "batches": sum(b.batches_dispatched
                           for ts in self.tenants.values()
                           for b in ts.batchers.values()),
            "draining": self._draining,
            "infer_precision": self.infer_precision,
            "quant_max_abs_error": self._quant_err_last,
            "support": self.pipeline.support_stats(),
            "horizons": list(self.horizons),
            "mesh": {"rungs": [], "devices": 0, "degrades": 0},
            "device": str(self.device),
            "graph_bytes": dict(self.graph_bytes),
            "startup_s": round(self.startup_s, 3),
            "kernel_launches": {name: k.launches
                                for name, k in KERNELS.items()},
            "slo": self.slo.report(),
        }

    def metrics_text(self) -> str:
        self.slo.tick()
        return render_prometheus(self.metrics, default_registry())


def _truncate_file(path: str) -> None:
    """The corrupt_tenant_slot fault: tear the slot to half its bytes (a
    torn write that beat the atomic rename)."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    print(f"FAULT INJECTED: truncated tenant slot {path} "
          f"({size} -> {size // 2} bytes)", flush=True)


class FleetReloader:
    """One poll loop over every tenant's CanaryReloader: a reload error in
    one tenant's poll is logged and the loop moves on."""

    def __init__(self, fleet: FleetEngine):
        self.fleet = fleet
        self.reloaders = fleet.make_reloaders()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_all(self) -> dict:
        out = {}
        for tid, rel in sorted(self.reloaders.items()):
            try:
                out[tid] = rel.poll()
            except Exception as e:
                out[tid] = "error"
                self.fleet.reload_log.log(
                    "reload_error", tenant=tid,
                    error=f"{type(e).__name__}: {e}"[:300])
        return out

    def start(self) -> None:
        if self.fleet.fcfg.reload_poll_secs <= 0 or self._thread:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mpgcn-fleet-reloader")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_all()
            self._stop.wait(self.fleet.fcfg.reload_poll_secs)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def build_fleet(cfg: MPGCNConfig, data: dict, fcfg: FleetConfig, root: str,
                device="cuda", faults: Optional[FaultPlan] = None,
                bdgcn_impl: str = "auto"
                ) -> tuple[FleetEngine, FleetReloader]:
    """The command's construction: load the manifest under ``root``
    (refusing a corrupt or empty one: serving a wrong tenant set is worse
    than not serving), then the engine and its reloader."""
    registry = TenantRegistry.load(root, missing_ok=False)
    if not len(registry):
        raise ValueError(f"fleet registry at {root} has no tenants; "
                         f"`python -m mpgcn_tpu_torch.cli fleet add <id>` "
                         f"first")
    engine = FleetEngine(cfg, data, fcfg, registry, device=device,
                         faults=faults, bdgcn_impl=bdgcn_impl)
    return engine, FleetReloader(engine)
