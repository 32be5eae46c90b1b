"""The front tier (counterpart of mpgcn_tpu/service/router.py): a
device-free router over N ``serve --fleet`` replica processes.

``serve --fleet`` (service/fleet.py) keeps every tenant in one process:
one OOM, one wedged CUDA context or one kill -9 takes every city down
together. This module adds the availability axis: N whole fleet
replicas (each a stock ``python -m mpgcn_tpu_torch.cli serve --fleet``
child over the SAME shared tenant roots, service/replica.py) behind one
HTTP front door speaking the serve contract (/v1/predict, /v1/stats,
/healthz, /metrics), so the blast radius of a replica death is one
retried request, not an outage.

The router owns:

  * **consistent tenant routing** -- rendezvous hashing gives every
    tenant a stable replica preference order that survives membership
    churn (only requests of tenants mapped to a dead replica move);
    round-robin rotation WITHIN the tenant's replica set spreads one
    tenant's load across siblings.
  * **active health probing** -- each replica's /healthz is probed on
    an interval and the verdicts feed a per-replica CircuitBreaker
    (service/tenants.py -- the same half-open-probe machine the fleet
    uses per tenant), so a flapping replica is taken out of rotation
    and re-admitted by probe, not by luck.
  * **request-level failover** -- a replica that times out, resets the
    connection, or answers 503 rejected-draining is transparently
    retried on the next sibling in rendezvous order, within the
    request's own deadline budget. Predictions are pure functions of
    the promoted params, so the retry is idempotent by construction.
    Typed application outcomes (4xx, nonfinite 500, tenant 404/429)
    surface verbatim: they would fail identically everywhere, and
    retrying a quota rejection is how retry storms start.
  * **rolling deploys** -- one replica at a time: drain (SIGTERM,
    serve finishes in-flight work), restart (the kernel libraries are
    reused, the rollout graphs captured again), re-admit only after
    /healthz AND a real /v1/predict smoke probe pass. Siblings keep
    serving throughout.
  * **SLO-burn autoscaling** -- the router feeds its own per-request
    latencies into a multi-window burn-rate engine (obs/perf/slo.py)
    and a hysteresis controller (service/autoscale.py) turns sustained
    BURNING into a spawned replica and sustained OK into a retired
    one, inside [min_replicas, max_replicas].

Device-free (pinned by test): the front tier is stdlib HTTP + process
supervision and imports no torch; the replica children are the only
processes that touch the card. The router adds no ``--device`` flag of
its own: a replica runs on the card unless the pass-through arguments
say ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from mpgcn_tpu_torch.config import RouterConfig
from mpgcn_tpu_torch.obs.metrics import MetricsRegistry, render_prometheus
from mpgcn_tpu_torch.obs.perf.slo import SLOEngine, SLOSpec
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service.autoscale import Autoscaler
from mpgcn_tpu_torch.service.registry import TenantRegistry
from mpgcn_tpu_torch.service.replica import ReplicaProcess, _http_info
from mpgcn_tpu_torch.service.tenants import CLOSED, CircuitBreaker
from mpgcn_tpu_torch.utils.logging import JsonlLogger

__all__ = ["Router", "router_dir", "router_info_path", "build_parser",
           "main"]

#: replica lifecycle states (the router's admission machine; the
#: breaker is a SEPARATE, orthogonal axis gating an ADMITTED replica)
RESTARTING = "restarting"    # process launched, port not yet bound
JOINING = "joining"          # address known, awaiting health + smoke
ADMITTED = "admitted"        # routable (modulo breaker + partition)
DRAINING = "draining"        # rolling deploy: finishing in-flight work
STOPPED = "stopped"          # retired (scale-down / close)

#: serve's trace-propagation header, echoed end to end
TRACE_HEADER = "X-MPGCN-Trace"

_MAX_BODY_BYTES = 64 << 20   # same cap as serve.py's front door


def router_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "router")


def router_info_path(output_dir: str) -> str:
    """Where the `router` command publishes its bound address
    ({host, port, pid}) -- the router-level analog of serve's
    http.json."""
    return os.path.join(router_dir(output_dir), "http.json")


class _ReplicaHandle:
    """One replica's admission state as the router sees it: the child
    process, the lifecycle state, and the transport circuit breaker.

    State mutations happen under the router lock; the (blocking)
    network and process verbs never do.
    """

    def __init__(self, proc: ReplicaProcess, breaker: CircuitBreaker):
        self.proc = proc
        self.breaker = breaker
        self.state = RESTARTING
        self.partitioned_until = 0.0   # injected one-way partition
        self.routed = 0                # requests proxied to this replica
        self.deaths = 0
        self.state_since = time.monotonic()

    @property
    def idx(self) -> int:
        return self.proc.idx

    def set_state(self, state: str) -> None:
        self.state = state
        self.state_since = time.monotonic()


class Router:
    """The front tier: replica supervision + routing + autoscaling.

    Lifecycle: ``start()`` launches the initial replicas and the
    control thread; ``wait_ready()`` blocks until they are admitted;
    ``close()`` tears everything down. ``handle_predict`` is the
    request path (called from HTTP handler threads).
    """

    def __init__(self, rcfg: RouterConfig, serve_args: list,
                 faults: Optional[FaultPlan] = None,
                 env: Optional[dict] = None):
        self.rcfg = rcfg
        self.root = rcfg.output_dir
        self.serve_args = list(serve_args)
        self.faults = faults if faults is not None else FaultPlan.parse(
            None)
        self._env = env
        self._lock = threading.Lock()
        self.handles: dict[int, _ReplicaHandle] = {}
        self._next_idx = 0
        self._rr: dict[str, int] = {}      # per-tenant rotation cursor
        self._n_routed = 0                 # proxied requests (fault key)
        self.draining = False
        self._stop = threading.Event()
        self._control: Optional[threading.Thread] = None
        self.deploys = 0

        os.makedirs(router_dir(self.root), exist_ok=True)
        self.ledger = JsonlLogger(
            os.path.join(router_dir(self.root), "router.jsonl"),
            rotate_max_bytes=rcfg.ledger_max_bytes)

        # --- metrics + SLO engine (the autoscale control signal) -----------
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "router_requests", "routed requests by typed outcome")
        self._m_req_children: dict[str, object] = {}
        self._m_latency = self.metrics.histogram(
            "router_request_latency_ms", "accepted end-to-end request "
            "latency through the front tier (ms)")
        self._m_lat_children: dict[str, object] = {}
        self._m_failovers = self.metrics.counter(
            "router_failovers", "transparent same-request retries on a "
            "sibling replica")
        self._m_probe_fail = self.metrics.counter(
            "router_probe_failures", "failed replica health probes")
        self._m_breaker = self.metrics.gauge(
            "router_breaker_state", "per-replica circuit breaker "
            "(0=closed, 1=half-open, 2=open)")
        self._m_admitted = self.metrics.gauge(
            "router_replicas_admitted", "replicas currently routable")
        self._m_admitted.set_fn(lambda: float(len(self._admitted())))
        self._m_replicas = self.metrics.gauge(
            "router_replicas", "replicas currently supervised (any "
            "non-stopped state)")
        self._m_replicas.set_fn(lambda: float(self._supervised_count()))
        self.slo = SLOEngine(
            [SLOSpec(name="router_latency_p99", kind="latency_p99",
                     metric="router_request_latency_ms",
                     objective=rcfg.slo_p99_ms, per_label="tenant",
                     windows_s=(15.0, 90.0), burn_threshold=2.0,
                     plane="router",
                     description="p99 of routed request latency (ms); "
                                 "the autoscaler's control signal")],
            [self.metrics], export_registry=self.metrics,
            output_dir=router_dir(self.root))
        self.autoscaler: Optional[Autoscaler] = None
        if rcfg.autoscale:
            self.autoscaler = Autoscaler(
                min_replicas=rcfg.min_replicas,
                max_replicas=rcfg.max_replicas,
                scale_up=self._scale_up, scale_down=self._scale_down,
                count=self._supervised_count,
                up_after=rcfg.scale_up_after,
                down_after=rcfg.scale_down_after,
                cooldown_ticks=rcfg.scale_cooldown_ticks)

        # smoke-probe body (zeros; predictions are pure, any input
        # exercises the whole rollout path) -- built lazily: the
        # registry may not exist until start()
        self._smoke_body: Optional[bytes] = None

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Launch the initial replica set and the control thread."""
        for _ in range(self.rcfg.replicas):
            self._launch_locked()
        self._control = threading.Thread(
            target=self._control_loop, daemon=True,
            name="mpgcn-router-control")
        self._control.start()
        self.ledger.log("router_start", replicas=self.rcfg.replicas,
                        autoscale=self.rcfg.autoscale)

    def wait_ready(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every non-stopped replica is ADMITTED (or the
        budget runs out). A replica's startup builds any kernel
        library not yet built and captures its rollout graphs."""
        budget = (self.rcfg.ready_timeout_s if timeout_s is None
                  else timeout_s)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            with self._lock:
                live = [h for h in self.handles.values()
                        if h.state != STOPPED]
                if live and all(h.state == ADMITTED for h in live):
                    return True
            time.sleep(0.1)
        return False

    def begin_drain(self) -> None:
        """Front-door drain: answer in-flight, reject new requests with
        the typed rejected-draining outcome (an upstream LB of routers
        can fail over on it, same contract as the replicas')."""
        self.draining = True
        self.ledger.log("router_drain")

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the control thread and terminate every replica."""
        self._stop.set()
        if self._control is not None:
            self._control.join(timeout=10.0)
        with self._lock:
            handles = list(self.handles.values())
            for h in handles:
                h.set_state(STOPPED)
        for h in handles:
            h.proc.terminate(timeout_s=timeout_s)
        self.ledger.log("router_stop")

    def _launch_locked(self) -> _ReplicaHandle:
        """Create + launch one replica handle (caller-synchronous; the
        Popen itself is cheap, discovery is the control thread's job)."""
        idx = self._next_idx
        self._next_idx += 1
        breaker_child = self._m_breaker.labels(replica=f"r{idx}")
        breaker = CircuitBreaker(
            self.rcfg.breaker_threshold, self.rcfg.breaker_cooldown_s,
            on_transition=lambda s, c=breaker_child: c.set(float(s)))
        breaker_child.set(float(CLOSED))
        h = _ReplicaHandle(
            ReplicaProcess(idx, self.root, self.serve_args,
                           env=self._env), breaker)
        h.proc.start()
        self.handles[idx] = h
        self.ledger.log("replica_launch", replica=idx,
                        pid=h.proc.pid, generation=h.proc.generation)
        return h

    # --- membership views ---------------------------------------------------

    def _admitted(self) -> list:
        # list() first: the metrics set_fn callbacks read this from
        # scrape threads without the router lock
        return [h for h in list(self.handles.values())
                if h.state == ADMITTED]

    def _supervised_count(self) -> int:
        return sum(1 for h in list(self.handles.values())
                   if h.state != STOPPED)

    def _is_partitioned(self, h: _ReplicaHandle) -> bool:
        return time.monotonic() < h.partitioned_until

    # --- routing ------------------------------------------------------------

    def _order(self, tenant: str) -> list:
        """The tenant's replica walk order: rendezvous hash over the
        ADMITTED set (stable preference ranking per tenant; membership
        churn only moves tenants whose winners left), truncated to the
        configured replica-set size, then rotated round-robin so one
        tenant's load spreads across its whole set."""
        with self._lock:
            ranked = sorted(
                self._admitted(),
                key=lambda h: hashlib.blake2b(
                    f"{tenant}|{h.idx}".encode(),
                    digest_size=8).digest(),
                reverse=True)
            k = self.rcfg.replica_set_size
            rset = ranked[:k] if k > 0 else ranked
            if not rset:
                return []
            cursor = self._rr.get(tenant, 0)
            self._rr[tenant] = cursor + 1
            start = cursor % len(rset)
            return rset[start:] + rset[:start]

    def _typed(self, outcome: str, error: str, t0: float,
               attempts: int, trace: str) -> tuple:
        body = {"ok": False, "outcome": outcome, "error": error,
                "router": True, "attempts": attempts,
                "latency_ms": (time.monotonic() - t0) * 1e3,
                "trace": trace}
        status = {"rejected-invalid": 400}.get(outcome, 503)
        return status, json.dumps(body).encode(), outcome

    def handle_predict(self, raw: bytes, trace: str = "") -> tuple:
        """Route one /v1/predict body; returns (status, body_bytes,
        outcome). The raw bytes are forwarded verbatim (the replica
        owns validation); the router parses only what routing needs."""
        t0 = time.monotonic()
        if self.draining:
            st, body, oc = self._typed(
                "rejected-draining", "router is draining", t0, 0, trace)
            self._account(oc, None, t0)
            return st, body, oc
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                # the JAX router lets req.get raise AttributeError here
                # and drops the connection; the port types it
                raise ValueError(f"body is a JSON {type(req).__name__}, "
                                 f"not an object")
            tenant = str(req.get("tenant", ""))
            deadline_ms = req.get("deadline_ms", None)
            deadline_ms = (float(deadline_ms) if deadline_ms is not None
                           else self.rcfg.deadline_ms)
            if not (deadline_ms >= 0):   # NaN fails this too
                raise ValueError(f"bad deadline_ms {deadline_ms!r}")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            st, body, oc = self._typed(
                "rejected-invalid", f"unroutable body: {e}", t0, 0,
                trace)
            self._account(oc, None, t0)
            return st, body, oc

        with self._lock:
            self._n_routed += 1
            n = self._n_routed
        self._inject_faults(n)

        budget_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        attempts = 0
        transport_failures = 0
        order = self._order(tenant)
        last_err = "no admitted replica"
        for h in order:
            if attempts >= self.rcfg.failover_attempts:
                break
            remaining = None
            if budget_s is not None:
                remaining = budget_s - (time.monotonic() - t0)
                if remaining <= 0:
                    st, body, oc = self._typed(
                        "shed-deadline",
                        f"deadline exhausted after {attempts} "
                        f"attempt(s): {last_err}", t0, attempts, trace)
                    self._account(oc, tenant, t0, failovers=attempts)
                    return st, body, oc
            admitted, is_probe = h.breaker.allow()
            if not admitted or h.state != ADMITTED:
                if is_probe:
                    h.breaker.probe_abort()
                continue
            attempts += 1
            with self._lock:
                h.routed += 1
                n_to = h.routed
            self.faults.maybe_slow_replica(h.idx, n_to)
            if budget_s is not None:
                # re-check AFTER the (possibly stalled) admission path:
                # a slow-replica stall must shed, not forward against a
                # stale budget
                remaining = budget_s - (time.monotonic() - t0)
                if remaining <= 0:
                    if is_probe:   # shed != a probe verdict
                        h.breaker.probe_abort()
                    st, body, oc = self._typed(
                        "shed-deadline",
                        f"deadline exhausted at attempt {attempts}",
                        t0, attempts, trace)
                    self._account(oc, tenant, t0,
                                  failovers=attempts - 1)
                    return st, body, oc
            ok_transport, result = self._forward(
                h, raw, trace, remaining)
            if is_probe:
                h.breaker.probe_result(ok_transport)
            else:
                h.breaker.record(ok_transport)
            if not ok_transport:
                last_err = str(result)
                transport_failures += 1
                self._m_failovers.inc()
                self.ledger.log("failover", tenant=tenant,
                                replica=h.idx, error=last_err[:200])
                continue
            status, resp_body, outcome = result
            if status == 503 and outcome == "rejected-draining":
                # the replica is mid-deploy: healthy transport, but
                # this request must land on a sibling
                last_err = f"r{h.idx} draining"
                self._m_failovers.inc()
                self.ledger.log("failover", tenant=tenant,
                                replica=h.idx, error="draining")
                continue
            self._account(outcome, tenant, t0, replica=h.idx,
                          failovers=attempts - 1, accepted=status == 200)
            return status, resp_body, outcome

        if transport_failures or attempts:
            oc_name, msg = "rejected-no-replica", (
                f"all {attempts} attempt(s) failed: {last_err}")
        else:
            oc_name, msg = "rejected-no-replica", last_err
        st, body, oc = self._typed(oc_name, msg, t0, attempts, trace)
        self._account(oc, tenant, t0, failovers=max(0, attempts - 1))
        return st, body, oc

    def _forward(self, h: _ReplicaHandle, raw: bytes, trace: str,
                 remaining_s: Optional[float]) -> tuple:
        """One proxy attempt. Returns (transport_ok, payload):
        transport_ok=False -> payload is the error string (failover);
        transport_ok=True  -> payload is (status, body_bytes, outcome)
        -- an HTTP status from the replica IS an answer, the breaker
        measures transport health, not application outcomes."""
        if self._is_partitioned(h):
            return False, f"r{h.idx} partitioned"
        base = h.proc.base_url
        if base is None:
            return False, f"r{h.idx} has no address"
        timeout = self.rcfg.connect_timeout_s
        if remaining_s is not None:
            timeout = min(max(remaining_s, 1e-3),
                          max(self.rcfg.connect_timeout_s, remaining_s))
        req = urllib.request.Request(
            base + "/v1/predict", data=raw,
            headers={"Content-Type": "application/json",
                     TRACE_HEADER: trace},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
                return True, (resp.status, body,
                              self._outcome_of(body))
        except urllib.error.HTTPError as e:
            body = e.read()
            return True, (e.code, body, self._outcome_of(body))
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            return False, f"{type(e).__name__}: {e}"

    @staticmethod
    def _outcome_of(body: bytes) -> str:
        try:
            return str(json.loads(body).get("outcome", ""))
        except (ValueError, AttributeError):
            return ""

    def _account(self, outcome: str, tenant: Optional[str], t0: float,
                 replica: Optional[int] = None, failovers: int = 0,
                 accepted: bool = False) -> None:
        child = self._m_req_children.get(outcome)
        if child is None:
            child = self._m_requests.labels(outcome=outcome or "none")
            self._m_req_children[outcome] = child
        child.inc()
        latency_ms = (time.monotonic() - t0) * 1e3
        if accepted:
            self._m_latency.observe(latency_ms)
            if tenant:
                lat = self._m_lat_children.get(tenant)
                if lat is None:
                    lat = self._m_latency.labels(tenant=tenant)
                    self._m_lat_children[tenant] = lat
                lat.observe(latency_ms)
        self.ledger.log("route", tenant=tenant, outcome=outcome,
                        replica=replica, failovers=failovers,
                        latency_ms=round(latency_ms, 3))

    def _inject_faults(self, n_routed: int) -> None:
        """Front-tier chaos verbs (resilience/faults.py): the plan
        votes, the router does the damage to the TARGETED replica."""
        if not self.faults.active:
            return
        target = self.handles.get(self.faults.fault_replica)
        if self.faults.take_kill_replica(n_routed) and target is not None:
            target.proc.kill()     # control loop detects + restarts
        if (self.faults.take_partition_replica(n_routed)
                and target is not None):
            target.partitioned_until = (time.monotonic()
                                        + self.faults.partition_secs)

    # --- control loop (probe / admit / restart / autoscale) -----------------

    def _control_loop(self) -> None:
        while not self._stop.wait(self.rcfg.probe_interval_s):
            try:
                self._control_pass()
            except Exception as e:   # supervision must not die quietly
                self.ledger.log("control_error",
                                error=f"{type(e).__name__}: {e}"[:300])

    def _control_pass(self) -> None:
        with self._lock:
            snapshot = list(self.handles.values())
        for h in snapshot:
            if h.state in (STOPPED, DRAINING):
                continue
            if not h.proc.alive:
                self._on_death(h)
                continue
            if h.state == RESTARTING:
                info = _http_info(h.proc.root)
                if info and "port" in info:
                    h.proc.host = info.get("host", "127.0.0.1")
                    h.proc.port = int(info["port"])
                    with self._lock:
                        h.set_state(JOINING)
                    self.ledger.log("replica_bound", replica=h.idx,
                                    port=h.proc.port)
                continue
            healthy = self._probe(h)
            if h.state == JOINING and healthy and self._smoke(h):
                with self._lock:
                    h.set_state(ADMITTED)
                self.ledger.log("replica_admitted", replica=h.idx,
                                generation=h.proc.generation)
        report = self.slo.tick()
        if self.autoscaler is not None:
            row = self.autoscaler.tick(report)
            if row["action"] not in ("hold", "cooldown"):
                self.ledger.log("autoscale", **row)

    def _probe(self, h: _ReplicaHandle) -> bool:
        """One health probe, fed through the replica's breaker with the
        same allow/probe_result protocol the request path uses -- the
        prober is what re-closes a tripped breaker once the replica
        answers again."""
        if self._is_partitioned(h):
            ok = False
        else:
            resp = h.proc.healthz(timeout_s=self.rcfg.probe_timeout_s)
            ok = resp is not None and resp.get("status") in (
                "serving", "draining")
        admitted, is_probe = h.breaker.allow()
        if admitted:
            if is_probe:
                h.breaker.probe_result(ok)
            else:
                h.breaker.record(ok)
        if not ok:
            self._m_probe_fail.inc()
            self.ledger.log("probe_failed", replica=h.idx,
                            breaker=h.breaker.state_name)
        return ok

    def _smoke_payload(self) -> Optional[bytes]:
        if self._smoke_body is not None:
            return self._smoke_body
        if self.rcfg.smoke_obs <= 0:
            return None
        reg = TenantRegistry.load(self.root, missing_ok=False)
        tenant = sorted(reg.ids())[0]
        obs, n = self.rcfg.smoke_obs, self.rcfg.smoke_nodes
        x = [[[0.0] * n for _ in range(n)] for _ in range(obs)]
        self._smoke_body = json.dumps(
            {"x": x, "key": 0, "tenant": tenant,
             "deadline_ms": 0}).encode()
        return self._smoke_body

    def _smoke(self, h: _ReplicaHandle) -> bool:
        """Re-admission gate beyond liveness: one real prediction must
        come back OK (the whole path -- registry, placed params,
        captured rollout -- not just the HTTP loop). Disabled when
        smoke_obs=0 (shape-agnostic deployments)."""
        body = self._smoke_payload()
        if body is None:
            return True
        base = h.proc.base_url
        if base is None or self._is_partitioned(h):
            return False
        req = urllib.request.Request(
            base + "/v1/predict", data=body,
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.rcfg.probe_timeout_s * 5) as resp:
                ok = bool(json.loads(resp.read()).get("ok"))
        except (urllib.error.URLError, OSError, ValueError):
            ok = False
        if not ok:
            self.ledger.log("smoke_failed", replica=h.idx)
        return ok

    def _on_death(self, h: _ReplicaHandle) -> None:
        rc = h.proc.proc.returncode if h.proc.proc else None
        with self._lock:
            h.deaths += 1
        self.ledger.log("replica_died", replica=h.idx, rc=rc,
                        deaths=h.deaths, state=h.state)
        if not self.rcfg.restart_dead or self._stop.is_set():
            with self._lock:
                h.set_state(STOPPED)
            return
        h.proc.terminate(timeout_s=1.0)   # reap + close the log handle
        h.proc.start()                    # kernel libraries reused
        with self._lock:
            h.set_state(RESTARTING)
        self.ledger.log("replica_restart", replica=h.idx,
                        generation=h.proc.generation)

    # --- rolling deploy -----------------------------------------------------

    def rolling_deploy(self) -> dict:
        """Restart every admitted replica, one at a time: drain ->
        SIGTERM -> relaunch (the kernel libraries reused) ->
        re-admission only after /healthz + smoke pass. Siblings keep
        serving, so per-tenant p99 stays in the SLO band (pinned by
        tests/test_torch_router.py)."""
        with self._lock:
            targets = sorted(self._admitted(), key=lambda h: h.idx)
        self.deploys += 1
        self.ledger.log("deploy_start", replicas=[h.idx
                                                  for h in targets])
        done, ok = [], True
        for h in targets:
            with self._lock:
                if h.state != ADMITTED:
                    continue   # died mid-deploy; control loop owns it
                h.set_state(DRAINING)
            self.ledger.log("deploy_drain", replica=h.idx)
            h.proc.terminate(timeout_s=self.rcfg.drain_timeout_s)
            h.proc.start()
            with self._lock:
                h.set_state(RESTARTING)
            deadline = time.monotonic() + self.rcfg.ready_timeout_s
            while time.monotonic() < deadline:
                if h.state == ADMITTED:
                    break
                time.sleep(0.1)
            if h.state != ADMITTED:
                ok = False
                self.ledger.log("deploy_stuck", replica=h.idx,
                                state=h.state)
                break
            done.append(h.idx)
            self.ledger.log("deploy_readmitted", replica=h.idx,
                            generation=h.proc.generation)
        self.ledger.log("deploy_done", ok=ok, deployed=done)
        return {"ok": ok, "deployed": done}

    # --- autoscale verbs ----------------------------------------------------

    def _scale_up(self) -> None:
        with self._lock:
            h = self._launch_locked()
        self.ledger.log("scale_up", replica=h.idx)

    def _scale_down(self) -> None:
        """Retire the highest-index admitted replica (drain in a side
        thread; the control loop must keep probing meanwhile)."""
        with self._lock:
            admitted = sorted(self._admitted(), key=lambda h: h.idx)
            if not admitted:
                return
            h = admitted[-1]
            h.set_state(STOPPED)
        self.ledger.log("scale_down", replica=h.idx)
        threading.Thread(
            target=lambda: h.proc.terminate(
                timeout_s=self.rcfg.drain_timeout_s),
            daemon=True, name=f"mpgcn-router-retire-r{h.idx}").start()

    # --- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                f"r{h.idx}": {
                    "state": h.state, "pid": h.proc.pid,
                    "port": h.proc.port,
                    "generation": h.proc.generation,
                    "breaker": h.breaker.state_name,
                    "routed": h.routed, "deaths": h.deaths,
                    "partitioned": self._is_partitioned(h)}
                for h in self.handles.values()}
            admitted = len(self._admitted())
            routed = self._n_routed
        out = {"routed": routed, "admitted": admitted,
               "replicas": replicas, "deploys": self.deploys,
               "draining": self.draining,
               "slo": self.slo.tick()}
        if self.autoscaler is not None:
            out["autoscale"] = {
                "replicas": self._supervised_count(),
                "last": (self.autoscaler.actions[-1]
                         if self.autoscaler.actions else None)}
        return out

    def healthz(self) -> dict:
        return {"status": "draining" if self.draining else "serving",
                "admitted": len(self._admitted()),
                "replicas": self._supervised_count()}

    def metrics_text(self) -> str:
        return render_prometheus(self.metrics)


# --- HTTP front door --------------------------------------------------------

def _make_handler(router: Router):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # the ledger is the log
            pass

        def _reply(self, status: int, body: bytes,
                   trace: str = "") -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace:
                self.send_header(TRACE_HEADER, trace)
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/v1/predict":
                self._reply(404, b'{"error": "not found"}')
                return
            trace = self.headers.get(TRACE_HEADER, "")
            length = int(self.headers.get("Content-Length", 0))
            if length > _MAX_BODY_BYTES:
                self._reply(413, json.dumps(
                    {"ok": False, "outcome": "rejected-invalid",
                     "error": "body too large"}).encode(), trace)
                return
            raw = self.rfile.read(length)
            status, body, _ = router.handle_predict(raw, trace=trace)
            self._reply(status, body, trace)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, json.dumps(router.healthz()).encode())
            elif self.path == "/v1/stats":
                self._reply(200, json.dumps(router.stats()).encode())
            elif self.path == "/metrics":
                body = router.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, b'{"error": "not found"}')

    return Handler


# --- CLI ---------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli router",
        description="device-free front tier over N serve --fleet replicas "
                    "(failover, rolling deploys, SLO-burn autoscaling). "
                    "Arguments after `--` are passed through to every "
                    "replica's serve invocation.")
    p.add_argument("-out", "--output-dir", default="./service",
                   help="fleet root (tenant registry + router state)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral; published in router/http.json")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--replica-set-size", type=int, default=0,
                   help="replicas per tenant (0 = all admitted)")
    p.add_argument("--probe-interval", type=float, default=0.5,
                   help="health-probe period (s)")
    p.add_argument("--probe-timeout", type=float, default=2.0)
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive transport failures that open a "
                        "replica's breaker (0 disables)")
    p.add_argument("--breaker-cooldown", type=float, default=2.0)
    p.add_argument("--deadline-ms", type=float, default=1000.0,
                   help="default request deadline when the body names "
                        "none (0 = unbounded)")
    p.add_argument("--failover-attempts", type=int, default=3)
    p.add_argument("--connect-timeout", type=float, default=2.0)
    p.add_argument("--ready-timeout", type=float, default=600.0)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--no-restart-dead", dest="restart_dead",
                   action="store_false",
                   help="leave dead replicas down (chaos A/B arm)")
    p.add_argument("--smoke-obs", type=int, default=0,
                   help="obs_len of the re-admission smoke prediction "
                        "(0 disables; set with --smoke-nodes)")
    p.add_argument("--smoke-nodes", type=int, default=0)
    p.add_argument("--autoscale", action="store_true",
                   help="SLO-burn-driven replica autoscaling")
    p.add_argument("--slo-p99-ms", type=float, default=250.0)
    p.add_argument("--scale-up-after", type=int, default=2)
    p.add_argument("--scale-down-after", type=int, default=6)
    p.add_argument("--scale-cooldown", type=int, default=3)
    p.add_argument("--serve-secs", type=float, default=0,
                   help="exit after this long (0 = until SIGTERM)")
    p.add_argument("-faults", "--faults", default="",
                   help="front-tier fault spec (resilience/faults.py)")
    p.add_argument("serve_args", nargs=argparse.REMAINDER,
                   help="passed to every replica's `serve --fleet`")
    return p


def main(argv=None) -> int:
    import signal
    from http.server import ThreadingHTTPServer

    from mpgcn_tpu_torch.utils.atomic import atomic_write_bytes

    ns = build_parser().parse_args(argv)
    serve_args = list(ns.serve_args)
    if serve_args and serve_args[0] == "--":
        serve_args = serve_args[1:]
    rcfg = RouterConfig(
        output_dir=ns.output_dir, replicas=ns.replicas,
        min_replicas=ns.min_replicas, max_replicas=ns.max_replicas,
        replica_set_size=ns.replica_set_size,
        probe_interval_s=ns.probe_interval,
        probe_timeout_s=ns.probe_timeout,
        breaker_threshold=ns.breaker_threshold,
        breaker_cooldown_s=ns.breaker_cooldown,
        deadline_ms=ns.deadline_ms,
        failover_attempts=ns.failover_attempts,
        connect_timeout_s=ns.connect_timeout,
        ready_timeout_s=ns.ready_timeout,
        drain_timeout_s=ns.drain_timeout,
        restart_dead=ns.restart_dead, smoke_obs=ns.smoke_obs,
        smoke_nodes=ns.smoke_nodes, autoscale=ns.autoscale,
        slo_p99_ms=ns.slo_p99_ms, scale_up_after=ns.scale_up_after,
        scale_down_after=ns.scale_down_after,
        scale_cooldown_ticks=ns.scale_cooldown)
    faults = FaultPlan.parse(ns.faults or os.environ.get(
        "MPGCN_FAULTS", ""))
    router = Router(rcfg, serve_args, faults=faults)
    router.start()
    ready = router.wait_ready()
    print(f"[router] replicas {'ready' if ready else 'NOT ready'} "
          f"({len(router._admitted())}/{rcfg.replicas} admitted)",
          flush=True)

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

    httpd = _Server((ns.host, ns.port), _make_handler(router))
    port = httpd.server_address[1]
    atomic_write_bytes(router_info_path(ns.output_dir), json.dumps(
        {"host": ns.host, "port": port, "pid": os.getpid()}).encode())
    print(f"[router] listening on http://{ns.host}:{port} "
          f"(stats: /v1/stats, health: /healthz)", flush=True)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   daemon=True,
                                   name="mpgcn-router-http")
    http_thread.start()

    stop = threading.Event()

    def _on_sig(signum, frame):
        name = signal.Signals(signum).name.encode()
        os.write(2, name + b" received: draining the front tier and "
                        b"exiting 0.\n")
        router.begin_drain()
        stop.set()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _on_sig)
        except ValueError:
            pass
    t0 = time.time()
    try:
        while not stop.is_set():
            stop.wait(0.2)
            if ns.serve_secs and time.time() - t0 >= ns.serve_secs:
                router.begin_drain()
                break
    finally:
        httpd.shutdown()
        router.close()
        for sig, h in prev.items():
            signal.signal(sig, h if h is not None else signal.SIG_DFL)
    print("[router] stopped; exiting 0.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
