"""The port's front tier (service/router.py, replica.py, autoscale.py,
config.py ``RouterConfig``, ``python -m mpgcn_tpu_torch.cli router``)
against the JAX package's, on the CPU. Both tiers are device-free, so
both run in this one process:

  (a) the port's tier imports neither torch, numpy nor JAX;
  (b) ``RouterConfig`` refuses what the JAX one refuses; the parsers'
      flags and defaults are the same and equal ``RouterConfig``'s;
  (c) the rendezvous walk order is the JAX router's, tenant for tenant,
      through membership churn and at replica-set sizes 0, 1 and 2;
  (d) ``Autoscaler`` and ``worst_state`` follow the JAX ones step for
      step on drawn tick sequences, and the closed loop over the port's
      fake-clock ``SLOEngine`` spawns once and retires without flapping;
  (e) both routers over the same fake replica HTTP servers (dead port,
      503 draining, typed 4xx/500, slow past the deadline, partitioned,
      the one-shot kill / partition / slow fault verbs, the control
      pass's restart and re-admission) give the same status, outcome,
      attempts and router flag per request and the same ledger events;
  (f) the port's Router and HTTP front over 2 real ``serve --fleet
      --device cpu`` replicas serving 3 tenants: kill -9 mid traffic with
      no accepted request failing, one distinct answer per tenant, the
      re-admission ledger order; a partition that trips the breaker and
      is re-closed by the prober; a rolling deploy under traffic; the
      graph count unmoved on every incarnation; then a drain;
  (g) without ``--device cpu`` in the pass-through arguments no replica
      is admitted on a box without a card: 503 rejected-no-replica, and
      each replica's log holds serve's CUDA refusal.

Size of (f): the JAX flagship's (tests/test_router.py:902-904): N=6, obs
5, hidden 8, T=60, buckets (1, 2), horizon 1; three tenants on the
port's seeded init (the first seed with both ReLU heads live) and two
scaled copies of it."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpgcn_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from mpgcn_tpu.service import autoscale as jax_autoscale
from mpgcn_tpu.service import router as jax_router
from mpgcn_tpu.service import tenants as jax_tenants
from mpgcn_tpu.service.config import RouterConfig as JaxRouterConfig
from mpgcn_tpu_torch.config import MPGCNConfig, RouterConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.obs.metrics import MetricsRegistry
from mpgcn_tpu_torch.obs.perf import slo
from mpgcn_tpu_torch.obs.perf.slo import BURNING, OK, WARN
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service import autoscale, router, tenants
from mpgcn_tpu_torch.service.registry import TenantRegistry
from mpgcn_tpu_torch.service.router import (
    ADMITTED,
    JOINING,
    Router,
    _make_handler,
)
from mpgcn_tpu_torch.train.checkpoint import save_checkpoint
from mpgcn_tpu_torch.train.predict import graphs_for

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, OBS, H = 6, 5, 8
TENANTS = ("nyc", "sf", "la")


def _pkg(name):
    """One package's front tier under common names."""
    if name == "jax":
        return types.SimpleNamespace(
            name=name, router=jax_router, autoscale=jax_autoscale,
            tenants=jax_tenants, FaultPlan=JaxFaultPlan,
            RouterConfig=JaxRouterConfig)
    return types.SimpleNamespace(
        name=name, router=router, autoscale=autoscale, tenants=tenants,
        FaultPlan=FaultPlan, RouterConfig=RouterConfig)


JAX, PORT = _pkg("jax"), _pkg("port")


# --- (a) the tier imports no torch, numpy or JAX ------------------------------


@pytest.mark.parametrize("mod", ["mpgcn_tpu_torch.service.router",
                                 "mpgcn_tpu_torch.service.replica",
                                 "mpgcn_tpu_torch.service.autoscale"])
def test_front_tier_imports_no_torch_numpy_or_jax(mod):
    code = (f"import sys; import {mod}; "
            f"bad = [m for m in ('torch', 'numpy', 'jax') "
            f"if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, \
        f"importing {mod} pulled in {proc.stdout}{proc.stderr[-1000:]}"


def test_router_command_starts_without_torch():
    """``cli.py router`` dispatches before torch is imported: its help
    comes from a process that never loaded torch or numpy."""
    code = ("import sys\n"
            "from mpgcn_tpu_torch.cli import main\n"
            "try:\n"
            "    main(['router', '--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert "--replica-set-size" in proc.stdout


# --- (b) RouterConfig and the parser -------------------------------------------


@pytest.mark.parametrize("bad", [
    {"replicas": 0},
    {"min_replicas": 0},
    {"replicas": 5, "max_replicas": 4},
    {"min_replicas": 3, "replicas": 2, "max_replicas": 4},
    {"replica_set_size": -1},
    {"failover_attempts": 0},
    {"breaker_threshold": -1},
    {"probe_interval_s": 0},
    {"slo_p99_ms": 0},
    {"deadline_ms": -1},
    {"smoke_obs": 5},
    {"smoke_nodes": 6},
    {"scale_up_after": 0},
    {"scale_down_after": 0},
    {"probe_timeout_s": 0},
    {"connect_timeout_s": -1},
    {"ready_timeout_s": 0},
    {"drain_timeout_s": 0},
    {"breaker_cooldown_s": -0.5},
    {"ledger_max_bytes": -1},
    {"scale_cooldown_ticks": -1},
])
def test_router_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as port_err:
        RouterConfig(**bad)
    with pytest.raises(ValueError) as jax_err:
        JaxRouterConfig(**bad)
    assert str(port_err.value) == str(jax_err.value)


def test_router_config_fields_and_replace_match_jax():
    import dataclasses

    port = [(f.name, f.default) for f in dataclasses.fields(RouterConfig)]
    jax = [(f.name, f.default) for f in dataclasses.fields(JaxRouterConfig)]
    assert port == jax
    rcfg = RouterConfig(replicas=3, max_replicas=6)
    r2 = rcfg.replace(deadline_ms=0.0)
    assert r2.replicas == 3 and r2.deadline_ms == 0.0
    assert rcfg.deadline_ms == 1000.0


def _actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.nargs,
             a.const, a.required, type(a).__name__)
            for a in parser._actions]


def test_router_parser_matches_jax_and_router_config():
    assert _actions(router.build_parser()) == \
        _actions(jax_router.build_parser())
    ns = router.build_parser().parse_args(["-out", "/tmp/x"])
    rcfg = RouterConfig(output_dir="/tmp/x")
    pairs = {"replicas": "replicas", "min_replicas": "min_replicas",
             "max_replicas": "max_replicas",
             "replica_set_size": "replica_set_size",
             "probe_interval": "probe_interval_s",
             "probe_timeout": "probe_timeout_s",
             "breaker_threshold": "breaker_threshold",
             "breaker_cooldown": "breaker_cooldown_s",
             "deadline_ms": "deadline_ms",
             "failover_attempts": "failover_attempts",
             "connect_timeout": "connect_timeout_s",
             "ready_timeout": "ready_timeout_s",
             "drain_timeout": "drain_timeout_s",
             "restart_dead": "restart_dead", "smoke_obs": "smoke_obs",
             "smoke_nodes": "smoke_nodes", "autoscale": "autoscale",
             "slo_p99_ms": "slo_p99_ms",
             "scale_up_after": "scale_up_after",
             "scale_down_after": "scale_down_after",
             "scale_cooldown": "scale_cooldown_ticks",
             "output_dir": "output_dir"}
    for flag, field in pairs.items():
        assert getattr(ns, flag) == getattr(rcfg, field), flag
    ns2 = router.build_parser().parse_args(
        ["-out", "/tmp/x", "--", "--device", "cpu", "-obs", "5"])
    assert ns2.serve_args == ["--", "--device", "cpu", "-obs", "5"]


# --- fakes (no torch, no subprocesses) -----------------------------------------


class _FakeProc:
    """Stands in for ReplicaProcess: a fixed address (or None = never
    bound), an always-alive process surface, kill/terminate recorders."""

    def __init__(self, idx, port=None, root="/nonexistent/mpgcn-fake"):
        self.idx = idx
        self.root = root
        self.host = "127.0.0.1" if port is not None else None
        self.port = port
        self.generation = 1
        self.proc = None
        self.killed = False

    @property
    def base_url(self):
        if self.port is None:
            return None
        return f"http://{self.host}:{self.port}"

    @property
    def alive(self):
        return not self.killed

    @property
    def pid(self):
        return 4242

    def healthz(self, timeout_s=2.0):
        return {"status": "serving"}

    def start(self):
        self.generation += 1
        self.killed = False
        self.host = self.port = None

    def terminate(self, timeout_s=30.0):
        return 0

    def kill(self):
        self.killed = True


def _bare_router(pkg, root, faults=None, **kw):
    """A Router with no control thread and no real replicas: handles are
    injected by the test, start() is not called."""
    rcfg = pkg.RouterConfig(output_dir=str(root),
                            **{"max_replicas": 8, **kw})
    return pkg.router.Router(rcfg, [], faults=faults)


def _add_fake(pkg, rt, idx, port=None, state="admitted", root=None):
    h = pkg.router._ReplicaHandle(
        _FakeProc(idx, port=port, **({"root": root} if root else {})),
        pkg.tenants.CircuitBreaker(rt.rcfg.breaker_threshold,
                                   rt.rcfg.breaker_cooldown_s))
    h.set_state(state)
    rt.handles[idx] = h
    return h


def _spawn_replica_http(reply):
    """One canned-answer replica: POST /v1/predict answers reply(raw,
    n_hits) -> (status, doc); GET /healthz serves. Returns (server, port,
    hits)."""
    hits = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, status, doc):
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            hits.append(raw)
            self._send(*reply(raw, len(hits)))

        def do_GET(self):
            self._send(200, {"status": "serving"})

    class _Srv(ThreadingHTTPServer):
        daemon_threads = True

    srv = _Srv(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1], hits


def _ok_reply(raw, n):
    return 200, {"ok": True, "outcome": "ok", "pred": [0.0],
                 "served_by": "fake"}


def _draining_reply(raw, n):
    return 503, {"ok": False, "outcome": "rejected-draining",
                 "error": "draining"}


def _slow_reply(raw, n):
    time.sleep(0.4)
    return 200, {"ok": True, "outcome": "ok", "pred": [0.0]}


def _typed_reply(status, outcome):
    def reply(raw, n):
        return status, {"ok": False, "outcome": outcome, "error": "x"}
    return reply


def _dead_port():
    """A bound-then-closed ephemeral port: connecting is refused."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _predict_body(tenant="t0", **extra):
    return json.dumps({"tenant": tenant, "x": [0.0], "key": 0,
                       **extra}).encode()


def _ledger(rt):
    path = os.path.join(rt.root, "router", "router.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


#: ledger fields that are times, latencies or a fake's bound port
_VOLATILE = ("t", "latency_ms", "port")


def _events(rt):
    return [{k: v for k, v in row.items() if k not in _VOLATILE}
            for row in _ledger(rt)]


def _answer(resp):
    status, body, outcome = resp
    doc = json.loads(body)
    return (status, outcome, doc.get("outcome"), doc.get("attempts"),
            doc.get("router"))


# --- (c) rendezvous order --------------------------------------------------------


@pytest.mark.parametrize("set_size", [0, 1, 2])
def test_rendezvous_order_matches_jax_through_churn(tmp_path, set_size):
    """200 tenants, memberships of 1-5 replicas with replicas joining and
    leaving; each tenant asked twice a membership (the rotation)."""
    routers = {p.name: _bare_router(p, tmp_path / p.name,
                                    replica_set_size=set_size)
               for p in (JAX, PORT)}
    memberships = [[0], [0, 1], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3, 4],
                   [0, 2, 3, 4], [2, 3, 4, 5], [3, 5], [5], [1, 3, 5, 6, 7]]
    for members in memberships:
        orders = {}
        for pkg in (JAX, PORT):
            rt = routers[pkg.name]
            for idx in list(rt.handles):
                if idx not in members:
                    rt.handles[idx].set_state("stopped")
            for idx in members:
                if idx in rt.handles:
                    rt.handles[idx].set_state("admitted")
                else:
                    _add_fake(pkg, rt, idx)
            orders[pkg.name] = [[h.idx for h in rt._order(f"tenant{t}")]
                                for t in range(200) for _ in range(2)]
        assert orders["port"] == orders["jax"], members
        want = min(len(members), set_size or len(members))
        assert all(len(o) == want for o in orders["port"])


def test_rendezvous_order_is_stable_and_rotates(tmp_path):
    rt = _bare_router(PORT, tmp_path)
    for i in range(4):
        _add_fake(PORT, rt, i)
    o1 = [h.idx for h in rt._order("nyc")]
    assert sorted(o1) == [0, 1, 2, 3]
    assert [h.idx for h in rt._order("nyc")] == o1[1:] + o1[:1]
    rt._rr.clear()
    assert [h.idx for h in rt._order("nyc")] == o1


# --- (d) the autoscaler ------------------------------------------------------------


def _report(code):
    return {"slos": [{"state_code": code}]}


def test_worst_state_reads_reports_defensively():
    reports = [None, {}, {"slos": "garbage"}, {"slos": []},
               {"slos": [{"state_code": WARN}, {"state_code": BURNING},
                         {"no_code": 1}]},
               {"slos": [{"state_code": "2"}, {"state_code": WARN}]}]
    got = [autoscale.worst_state(r) for r in reports]
    assert got == [jax_autoscale.worst_state(r) for r in reports]
    assert got == [OK, OK, OK, OK, BURNING, WARN]


def _drive(pkg, bounds, knobs, codes):
    lo, hi, start = bounds
    n = [start]
    calls = []
    sc = pkg.autoscale.Autoscaler(
        min_replicas=lo, max_replicas=hi,
        scale_up=lambda: (n.__setitem__(0, n[0] + 1), calls.append("up")),
        scale_down=lambda: (n.__setitem__(0, n[0] - 1),
                            calls.append("down")),
        count=lambda: n[0], **knobs)
    rows = [sc.tick(None if c is None else _report(c)) for c in codes]
    return rows, calls, (sc.burn_streak, sc.ok_streak, sc.cooldown)


@settings(max_examples=60, deadline=None)
@given(lo=st.integers(1, 3), extra=st.integers(0, 3),
       up=st.integers(1, 4), down=st.integers(1, 6),
       cooldown=st.integers(0, 3),
       codes=st.lists(st.sampled_from([OK, WARN, BURNING, None]),
                      max_size=40))
def test_autoscaler_follows_jax_step_for_step(lo, extra, up, down, cooldown,
                                              codes):
    bounds = (lo, lo + extra, lo + extra // 2)
    knobs = dict(up_after=up, down_after=down, cooldown_ticks=cooldown)
    assert _drive(PORT, bounds, knobs, codes) == \
        _drive(JAX, bounds, knobs, codes)


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0, max_replicas=2), dict(min_replicas=3,
                                               max_replicas=2),
    dict(min_replicas=1, max_replicas=2, up_after=0),
    dict(min_replicas=1, max_replicas=2, down_after=0),
    dict(min_replicas=1, max_replicas=2, cooldown_ticks=-1)])
def test_autoscaler_refuses_what_jax_refuses(kw):
    cb = dict(scale_up=lambda: None, scale_down=lambda: None,
              count=lambda: 1)
    with pytest.raises(ValueError) as a:
        autoscale.Autoscaler(**kw, **cb)
    with pytest.raises(ValueError) as b:
        jax_autoscale.Autoscaler(**kw, **cb)
    assert str(a.value) == str(b.value)


def test_autoscale_loop_closes_against_burn_rate_engine():
    """tests/test_router.py:789 on the port: a fake-clock SLOEngine over
    the router's latency histogram drives the controller -- sustained
    over-objective p99 spawns a replica once, recovery retires it, and
    no spawn follows the retire."""
    clock = [1000.0]
    reg = MetricsRegistry()
    hist = reg.histogram("router_request_latency_ms", "test")
    eng = slo.SLOEngine(
        [slo.SLOSpec(name="router_latency_p99", kind="latency_p99",
                     metric="router_request_latency_ms", objective=100.0,
                     windows_s=(5.0, 30.0), burn_threshold=2.0)],
        [reg], min_tick_interval_s=0.0, clock=lambda: clock[0])
    n = [1]
    sc = autoscale.Autoscaler(
        min_replicas=1, max_replicas=2,
        scale_up=lambda: n.__setitem__(0, n[0] + 1),
        scale_down=lambda: n.__setitem__(0, n[0] - 1),
        count=lambda: n[0], up_after=2, down_after=3, cooldown_ticks=1)
    states, actions = [], []

    def tick(latency_ms, count=20):
        for _ in range(count):
            hist.observe(latency_ms)
        clock[0] += 5.0
        report = eng.tick()
        states.append(autoscale.worst_state(report))
        actions.append(sc.tick(report)["action"])

    for _ in range(6):
        tick(500.0)
    assert BURNING in states
    assert actions.count("scale-up") == 1 and n[0] == 2
    for _ in range(16):
        tick(2.0)
    assert "scale-down" in actions and n[0] == 1
    assert "scale-up" not in actions[actions.index("scale-down"):]


# --- (e) both routers over the same fakes ---------------------------------------


def _sc_dead_breaker(pkg, root):
    """A dead replica in rotation: every request fails over to the live
    sibling and the dead one's breaker opens after 2 failures."""
    rt = _bare_router(pkg, root, breaker_threshold=2,
                      breaker_cooldown_s=60.0, failover_attempts=3,
                      connect_timeout_s=2.0)
    srv, port, hits = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(pkg, rt, 0, port=_dead_port())
        _add_fake(pkg, rt, 1, port=port)
        out = [_answer(rt.handle_predict(_predict_body("t")))
               for _ in range(8)]
    finally:
        srv.shutdown()
    return out, (len(hits), rt.handles[0].breaker.state_name,
                 rt.handles[0].breaker.trips)


def _sc_typed(pkg, root):
    """Typed application outcomes surface after exactly one attempt."""
    out, counts = [], []
    for status, outcome in ((404, "rejected-unknown-tenant"),
                            (429, "shed-tenant-quota"),
                            (500, "error-nonfinite"),
                            (400, "rejected-invalid")):
        rt = _bare_router(pkg, os.path.join(root, str(status)))
        s0, p0, h0 = _spawn_replica_http(_typed_reply(status, outcome))
        s1, p1, h1 = _spawn_replica_http(_typed_reply(status, outcome))
        try:
            _add_fake(pkg, rt, 0, port=p0)
            _add_fake(pkg, rt, 1, port=p1)
            out.append(_answer(rt.handle_predict(_predict_body())))
            counts.append(len(h0) + len(h1))
        finally:
            s0.shutdown()
            s1.shutdown()
    return out, counts


def _sc_draining(pkg, root):
    rt = _bare_router(pkg, root)
    s0, p0, h0 = _spawn_replica_http(_draining_reply)
    s1, p1, h1 = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(pkg, rt, 0, port=p0)
        _add_fake(pkg, rt, 1, port=p1)
        out = [_answer(rt.handle_predict(_predict_body("t")))
               for _ in range(6)]
    finally:
        s0.shutdown()
        s1.shutdown()
    return out, (len(h0), len(h1))


def _sc_deadline(pkg, root):
    """Two replicas slower than a 150 ms budget: a typed shed, fast."""
    rt = _bare_router(pkg, root, connect_timeout_s=5.0)
    s0, p0, _ = _spawn_replica_http(_slow_reply)
    s1, p1, _ = _spawn_replica_http(_slow_reply)
    try:
        _add_fake(pkg, rt, 0, port=p0)
        _add_fake(pkg, rt, 1, port=p1)
        t0 = time.monotonic()
        out = [_answer(rt.handle_predict(_predict_body(deadline_ms=150)))]
        took = time.monotonic() - t0
    finally:
        s0.shutdown()
        s1.shutdown()
    return out, took < 2.0


def _sc_invalid_and_drain(pkg, root):
    rt = _bare_router(pkg, root)
    srv, port, hits = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(pkg, rt, 0, port=port)
        out = [_answer(rt.handle_predict(b"not json")),
               _answer(rt.handle_predict(
                   _predict_body(deadline_ms=float("nan")))),
               _answer(rt.handle_predict(_predict_body(deadline_ms=-5))),
               _answer(rt.handle_predict(_predict_body(deadline_ms="x")))]
        rt.handles[0].set_state(JOINING)
        out.append(_answer(rt.handle_predict(_predict_body())))
        rt.handles[0].set_state(ADMITTED)
        out.append(_answer(rt.handle_predict(_predict_body(deadline_ms=0))))
        rt.begin_drain()
        out.append(_answer(rt.handle_predict(_predict_body())))
    finally:
        srv.shutdown()
    return out, len(hits)


def _sc_partitioned(pkg, root):
    rt = _bare_router(pkg, root, breaker_threshold=0)
    s0, p0, h0 = _spawn_replica_http(_ok_reply)
    s1, p1, h1 = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(pkg, rt, 0, port=p0)
        _add_fake(pkg, rt, 1, port=p1)
        rt.handles[0].partitioned_until = time.monotonic() + 60.0
        out = [_answer(rt.handle_predict(_predict_body("t")))
               for _ in range(6)]
        rt.handles[0].partitioned_until = 0.0   # healed
        out += [_answer(rt.handle_predict(_predict_body("t")))
                for _ in range(4)]
    finally:
        s0.shutdown()
        s1.shutdown()
    return out, (len(h0), len(h1))


def _sc_slow_fault(pkg, root):
    """slow_replica stalls the proxy path after admission: the budget is
    re-checked and the request shed, not forwarded; one-shot."""
    faults = pkg.FaultPlan.parse(
        "slow_replica=1,fault_replica=0,slow_secs=0.4")
    rt = _bare_router(pkg, root, faults=faults)
    srv, port, hits = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(pkg, rt, 0, port=port)
        out = [_answer(rt.handle_predict(_predict_body(deadline_ms=150))),
               _answer(rt.handle_predict(_predict_body(deadline_ms=1000)))]
    finally:
        srv.shutdown()
    return out, len(hits)


def _sc_kill_partition_control(pkg, root):
    """kill_replica at request 2 and partition_replica at request 4 on
    r0; then the control pass: the dead r0 restarts, binds (its
    http.json), and is admitted by probe; a partitioned probe fails."""
    faults = pkg.FaultPlan.parse("kill_replica=2,partition_replica=4,"
                                 "fault_replica=0,partition_secs=30")
    rt = _bare_router(pkg, root, faults=faults, breaker_threshold=2,
                      breaker_cooldown_s=60.0)
    s0, p0, h0 = _spawn_replica_http(_ok_reply)
    s1, p1, h1 = _spawn_replica_http(_ok_reply)
    froot = os.path.join(str(root), "fake_r0")
    os.makedirs(os.path.join(froot, "serve"))
    with open(os.path.join(froot, "serve", "http.json"), "w") as f:
        json.dump({"host": "127.0.0.1", "port": p0, "pid": 1}, f)
    try:
        _add_fake(pkg, rt, 0, port=p0, root=froot)
        _add_fake(pkg, rt, 1, port=p1)
        out = [_answer(rt.handle_predict(_predict_body("t")))
               for _ in range(3)]
        out.append(rt.handles[0].proc.killed)
        for _ in range(3):    # died -> restart -> bound -> admitted
            rt._control_pass()
            out.append(rt.handles[0].state)
        out += [_answer(rt.handle_predict(_predict_body("t")))
                for _ in range(4)]   # r0 partitioned from request 4
        for _ in range(3):
            rt._control_pass()
            out.append((rt.handles[0].state,
                        rt.handles[0].breaker.state_name))
        out.append(rt.stats()["replicas"]["r0"]["partitioned"])
    finally:
        s0.shutdown()
        s1.shutdown()
    return out, (len(h0), len(h1), rt.handles[0].proc.generation)


SCENARIOS = {"dead_replica_breaker": _sc_dead_breaker,
             "typed_outcomes": _sc_typed, "draining": _sc_draining,
             "deadline_walk": _sc_deadline,
             "invalid_and_drain": _sc_invalid_and_drain,
             "partitioned": _sc_partitioned,
             "slow_replica_fault": _sc_slow_fault,
             "kill_partition_control": _sc_kill_partition_control}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_routers_agree_over_fake_replicas(tmp_path, name):
    """Each scenario through the JAX router, then the port's: the same
    per-request (status, outcome, body outcome, attempts, router flag),
    the same fake-side counts, the same ledger events (times, latencies
    and bound ports left out)."""
    got = {}
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        os.makedirs(root)
        answers, extra = SCENARIOS[name](pkg, str(root))
        rows = []
        for dirpath, _, files in sorted(os.walk(root)):
            if "router.jsonl" in files:
                rows.append(_events(types.SimpleNamespace(
                    root=os.path.dirname(dirpath))))
        got[pkg.name] = (answers, extra, rows)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    answers = got["port"][0]
    if name == "dead_replica_breaker":
        assert all(a[:2] == (200, "ok") for a in answers)
        assert got["port"][1] == (8, "open", 1)
    elif name == "deadline_walk":
        assert answers[0][:2] == (503, "shed-deadline") and got["port"][1]
    elif name == "slow_replica_fault":
        assert [a[:2] for a in answers] == [(503, "shed-deadline"),
                                            (200, "ok")]
        assert got["port"][1] == 1
    elif name == "kill_partition_control":
        assert answers[3] is True
        assert answers[4:7] == ["restarting", "joining", "admitted"]
        assert answers[-2] == ("admitted", "open")


def test_router_stats_healthz_metrics_surface(tmp_path):
    rt = _bare_router(PORT, tmp_path)
    srv, port, _ = _spawn_replica_http(_ok_reply)
    try:
        _add_fake(PORT, rt, 0, port=port)
        rt.handle_predict(_predict_body("t"))
        st_ = rt.stats()
        assert st_["routed"] == 1 and st_["admitted"] == 1
        assert st_["replicas"]["r0"]["state"] == ADMITTED
        assert st_["replicas"]["r0"]["breaker"] == "closed"
        hz = rt.healthz()
        assert hz["status"] == "serving" and hz["admitted"] == 1
        text = rt.metrics_text()
        for metric in ("router_requests", "router_failovers",
                       "router_replicas_admitted",
                       "router_request_latency_ms", "router_breaker_state"):
            assert metric in text
    finally:
        srv.shutdown()


def test_http_front_echoes_trace_and_types_big_bodies(tmp_path):
    """The front door: the trace header echoed, a body over 64 MiB a typed
    413 without reading it, /healthz, /v1/stats, /metrics, 404s."""
    rt = _bare_router(PORT, tmp_path)
    srv, port, _ = _spawn_replica_http(_ok_reply)

    class _Srv(ThreadingHTTPServer):
        daemon_threads = True

    httpd = _Srv(("127.0.0.1", 0), _make_handler(rt))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _add_fake(PORT, rt, 0, port=port)
        req = urllib.request.Request(
            base + "/v1/predict", data=_predict_body("t"),
            headers={"Content-Type": "application/json",
                     router.TRACE_HEADER: "abc123"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.headers[router.TRACE_HEADER] == "abc123"
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=30)
        conn.putrequest("POST", "/v1/predict")
        conn.putheader("Content-Length", str((64 << 20) + 1))
        conn.endheaders()
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        assert resp.status == 413 and doc["outcome"] == "rejected-invalid"
        conn.close()
        for path in ("/healthz", "/v1/stats"):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                assert r.status == 200 and json.load(r)
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert b"router_requests" in r.read()
        for method, path in (("GET", "/nope"), ("POST", "/v1/other")):
            req = urllib.request.Request(
                base + path, method=method,
                data=b"{}" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404
    finally:
        httpd.shutdown()
        srv.shutdown()


# --- (f) real replicas: serve --fleet --device cpu -------------------------------


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Three tenants under one fleet root: the port's seeded init (the
    first seed with both branches' ReLU heads live on the test windows)
    and two scaled copies, each promoted with its ledger row."""
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    out = tmp_path_factory.mktemp("torch_router")
    kw = dict(mode="test", synthetic_T=60, synthetic_N=N, hidden_dim=H,
              obs_len=OBS, pred_len=1, batch_size=4)
    cfg = MPGCNConfig(**kw)
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(num_nodes=N)
    pipe = DataPipeline(cfg, data, "cpu")
    md = pipe.modes["test"]
    x = torch.from_numpy(np.array(md.x[:4], np.float32))
    keys = torch.from_numpy(np.asarray(md.keys[:4], np.int64))
    for seed in range(64):
        model = MPGCN.from_config(cfg.replace(seed=seed), device="cpu")
        with torch.no_grad():
            _, hidden = model(x, graphs_for(pipe.banks, keys, model.sources),
                              return_hidden=True)
            if all((torch.relu(br.fc(h)) != 0).float().mean() > 0.1
                   for br, h in zip(model.branches, hidden)):
                break
    else:
        raise AssertionError("no seed below 64 leaves both heads live")
    extra = {"num_branches": 2, "branch_sources": ["static", "dynamic"]}
    root = str(out / "svc")
    reg = TenantRegistry.load(root)
    for i, tid in enumerate(TENANTS):
        ckpt = str(out / f"{tid}.pkl")
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 if i == 0 else 1.01)
        save_checkpoint(ckpt, model, 0, extra=extra)
        troot = reg.add(tid)["root"]
        slot = promoted_path(troot)
        promote_checkpoint(ckpt, slot)
        JsonlLogger(ledger_path(troot)).log(
            "gate", attempt=1, promoted=True,
            candidate_hash=candidate_hash(slot))
    bodies = {tid: {"tenant": tid, "x": md.x[i, ..., 0].tolist(),
                    "key": int(md.keys[i])}
              for i, tid in enumerate(TENANTS)}
    return {"root": root, "bodies": bodies}


_SERVE_ARGS = ["-obs", str(OBS), "-hidden", str(H), "-sN", str(N), "-sT",
               "60", "--buckets", "1,2", "--max-wait-ms", "1",
               "--deadline-ms", "8000", "--reload-poll-secs", "60"]


def _replica_env():
    threads = max(1, (os.cpu_count() or 1) // (2 * int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(threads))
    env.pop("MPGCN_FAULTS", None)
    return env


def _http(base, path, payload=None, timeout=60):
    req = urllib.request.Request(
        base + path, data=(json.dumps(payload).encode()
                           if payload is not None else None),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _replica_stats(rt, idx):
    with urllib.request.urlopen(rt.handles[idx].proc.base_url + "/v1/stats",
                                timeout=30) as r:
        return json.load(r)


def _tail(rt, idx, n=2000):
    h = rt.handles.get(idx)
    if h is None:
        return "<no handle>"
    path = os.path.join(h.proc.root, f"replica_gen{h.proc.generation - 1}"
                                     f".log")
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError as e:
        return f"<no log: {e}>"


def _subsequence(want, seq):
    it = iter(seq)
    return all(any(e == w for e in it) for w in want)


def _wait(cond, secs, what):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_real_replicas_kill_partition_rolling_deploy(stack):
    """The JAX flagship (tests/test_router.py:934) on the port, over 2
    real ``serve --fleet --device cpu`` replicas behind the real HTTP
    front: (A) kill -9 r1 at request 10: no accepted request fails, one
    distinct answer per tenant, r1 re-admitted after died / restart /
    bound / admitted; (B) a partition of r1 at request 31 trips its
    breaker, the prober re-closes it; (C) a rolling deploy under traffic:
    every answer 200, generations bump, the SLO never BURNING; the graph
    count the same on every incarnation; then a drain answers 503."""
    root = stack["root"]
    faults = FaultPlan.parse("kill_replica=10,partition_replica=31,"
                             "fault_replica=1,partition_secs=1.2")
    rcfg = RouterConfig(
        output_dir=root, replicas=2, probe_interval_s=0.2,
        probe_timeout_s=5.0, breaker_threshold=2, breaker_cooldown_s=0.5,
        deadline_ms=8000.0, failover_attempts=3, connect_timeout_s=10.0,
        ready_timeout_s=240.0, drain_timeout_s=60.0, smoke_obs=OBS,
        smoke_nodes=N, slo_p99_ms=5000.0)
    rt = Router(rcfg, ["--device", "cpu", *_SERVE_ARGS], faults=faults,
                env=_replica_env())

    class _Srv(ThreadingHTTPServer):
        daemon_threads = True

    httpd = None
    try:
        rt.start()
        assert rt.wait_ready(240.0), (
            "replicas never admitted; r0: " + _tail(rt, 0) + " r1: "
            + _tail(rt, 1))
        httpd = _Srv(("127.0.0.1", 0), _make_handler(rt))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, hz = _http(base, "/healthz")
        assert code == 200 and hz["status"] == "serving" \
            and hz["admitted"] == 2
        # one rollout graph (program) a bucket; the smoke rode them
        traces = _replica_stats(rt, 0)["traces"]
        assert traces == 2 and _replica_stats(rt, 1)["traces"] == traces

        # ---- (A) kill -9 r1 at proxied request 10 ----
        results, lock = [], threading.Lock()

        def burst(tenant, n_req):
            for _ in range(n_req):
                res = _http(base, "/v1/predict", stack["bodies"][tenant])
                with lock:
                    results.append((tenant, *res))

        threads = [threading.Thread(target=burst, args=(t, 8))
                   for t in TENANTS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert len(results) == 24
        bad = [(t, c, d.get("outcome")) for t, c, d in results if c != 200]
        assert not bad, f"accepted requests failed across the kill: {bad}"
        preds = {}
        for t in TENANTS:
            got = {json.dumps(d["pred"]) for tt, _, d in results if tt == t}
            assert len(got) == 1, f"tenant {t}: answers diverged"
            preds[t] = got.pop()
        assert len(set(preds.values())) == 3, "tenants answered alike"
        # the kill is synchronous (ReplicaProcess.kill waits for the
        # corpse), so r1's process is dead now; the death is counted by
        # the control pass, which may still be inside a slow probe of r0
        assert rt.handles[1].deaths or not rt.handles[1].proc.alive, (
            "the kill_replica fault never landed on r1")
        _wait(lambda: rt.handles[1].deaths >= 1, 60,
              "the control pass to count r1's death")
        assert rt.handles[1].deaths == 1
        _wait(lambda: rt.handles[1].state == ADMITTED
              and rt.handles[1].proc.generation == 2, 180,
              "r1's re-admission: " + _tail(rt, 1))
        events = [r["event"] for r in _ledger(rt) if r.get("replica") == 1]
        order = [e for e in events if e in (
            "replica_died", "replica_restart", "replica_bound",
            "replica_admitted")]
        assert _subsequence(["replica_died", "replica_restart",
                             "replica_bound", "replica_admitted"],
                            order[order.index("replica_died"):]), order
        assert _replica_stats(rt, 1)["traces"] == traces

        # ---- (B) partition r1 at request 31: breaker trips, re-closes ----
        trips0 = rt.handles[1].breaker.trips
        for i in range(12):          # requests 25..36
            t = TENANTS[i % 3]
            code, doc = _http(base, "/v1/predict", stack["bodies"][t])
            assert code == 200, (t, code, doc)
            assert json.dumps(doc["pred"]) == preds[t]
        _wait(lambda: rt.handles[1].breaker.trips > trips0, 30,
              "the partition to trip r1's breaker")
        _wait(lambda: rt.handles[1].breaker.state == tenants.CLOSED
              and not rt._is_partitioned(rt.handles[1]), 30,
              "the prober to re-close r1's breaker")
        assert any(r["replica"] == 1 for r in _ledger(rt)
                   if r["event"] == "probe_failed")
        assert _replica_stats(rt, 0)["traces"] == traces
        assert _replica_stats(rt, 1)["traces"] == traces

        # ---- (C) rolling deploy under live traffic ----
        gens = {i: rt.handles[i].proc.generation for i in rt.handles}
        stop = threading.Event()
        bg = []

        def background():
            i = 0
            while not stop.is_set():
                t = TENANTS[i % 3]
                code, doc = _http(base, "/v1/predict", stack["bodies"][t])
                bg.append((t, code, json.dumps(doc.get("pred"))))
                i += 1
                time.sleep(0.05)

        bgt = threading.Thread(target=background)
        bgt.start()
        try:
            dep = rt.rolling_deploy()
        finally:
            stop.set()
            bgt.join(90)
        assert dep["ok"] and sorted(dep["deployed"]) == sorted(gens), dep
        for i, g in gens.items():
            assert rt.handles[i].proc.generation == g + 1
        assert bg, "background traffic never ran"
        bad = [row[:2] for row in bg if row[1] != 200]
        assert not bad, f"requests failed during the rolling deploy: {bad}"
        assert all(p == preds[t] for t, _, p in bg)
        assert autoscale.worst_state(rt.slo.tick()) < BURNING
        assert _replica_stats(rt, 0)["traces"] == traces
        assert _replica_stats(rt, 1)["traces"] == traces

        code, st_ = _http(base, "/v1/stats")
        assert code == 200 and st_["deploys"] == 1 and st_["admitted"] == 2
        assert st_["replicas"]["r1"]["deaths"] == 1
        with urllib.request.urlopen(base + "/metrics", timeout=20) as r:
            assert b"router_failovers" in r.read()
        rt.begin_drain()
        code, doc = _http(base, "/v1/predict", stack["bodies"]["nyc"])
        assert code == 503 and doc["outcome"] == "rejected-draining"
        assert doc["router"] is True
    finally:
        if httpd is not None:
            httpd.shutdown()
        rt.close()
    assert not any(h.proc.alive for h in rt.handles.values())


# --- (g) no card, no --device cpu: no replica admitted ---------------------------


def test_replicas_refuse_without_a_card(stack, tmp_path):
    """The router adds no device flag: without ``--device cpu`` each
    replica runs serve on the card, which this box lacks -- it exits with
    serve's CUDA refusal and the router admits nothing."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the replicas would serve on it")
    root = str(tmp_path / "svc")
    src = TenantRegistry.load(stack["root"])
    TenantRegistry(root, {t: {**e, "root": os.path.abspath(e["root"])}
                          for t, e in src.tenants.items()}).save()
    rcfg = RouterConfig(output_dir=root, replicas=2, probe_interval_s=0.1,
                        restart_dead=False)
    rt = Router(rcfg, _SERVE_ARGS, env=_replica_env())
    try:
        rt.start()
        _wait(lambda: all(h.state == "stopped"
                          for h in rt.handles.values()), 120,
              "both replicas to exit")
        assert not rt.wait_ready(0.5)
        status, body, outcome = rt.handle_predict(
            json.dumps(stack["bodies"]["nyc"]).encode())
        doc = json.loads(body)
        assert (status, outcome, doc["router"]) == (
            503, "rejected-no-replica", True)
        assert rt.healthz()["admitted"] == 0
        for idx in rt.handles:
            log = _tail(rt, idx, n=100000)
            assert "torch.cuda.is_available() is False" in log, log
        died = [r for r in _ledger(rt) if r["event"] == "replica_died"]
        assert sorted(r["replica"] for r in died) == [0, 1]
        assert all(r["rc"] not in (0, None) for r in died)
    finally:
        rt.close()


def test_non_object_body_is_typed_where_jax_raises(tmp_path):
    """A JSON body that is not an object: the JAX router's ``req.get``
    raises AttributeError (its HTTP front drops the connection); the
    port answers the typed 400 and touches no replica."""
    for body in (b"[1, 2]", b"3", b'"nyc"', b"null"):
        with pytest.raises(AttributeError):
            _bare_router(JAX, tmp_path / "jax").handle_predict(body)
        rt = _bare_router(PORT, tmp_path / "port")
        status, raw, outcome = rt.handle_predict(body)
        doc = json.loads(raw)
        assert (status, outcome, doc["router"], doc["attempts"]) == (
            400, "rejected-invalid", True, 0)
        assert "not an object" in doc["error"]


def test_router_command_serves_and_exits_0_on_sigterm(stack, tmp_path):
    """``python -m mpgcn_tpu_torch.cli router ... -- --device cpu ...`` as
    its own process: router/http.json once its replica is admitted, an
    answer through it, SIGTERM -> drained, exit 0, no replica left."""
    import signal

    root = str(tmp_path / "svc")
    src = TenantRegistry.load(stack["root"])
    TenantRegistry(root, {t: {**e, "root": os.path.abspath(e["root"])}
                          for t, e in src.tenants.items()}).save()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "router", "-out", root,
         "--replicas", "1", "--probe-interval", "0.1", "--smoke-obs",
         str(OBS), "--smoke-nodes", str(N), "--", "--device", "cpu",
         *_SERVE_ARGS], cwd=ROOT, env=_replica_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = router.router_info_path(root)
        _wait(lambda: os.path.exists(info) or proc.poll() is not None, 120,
              "router/http.json")
        assert proc.poll() is None, proc.communicate()
        with open(info) as f:
            doc = json.load(f)
        assert doc["pid"] == proc.pid
        base = f"http://127.0.0.1:{doc['port']}"
        code, hz = _http(base, "/healthz")
        assert code == 200 and hz == {"status": "serving", "admitted": 1,
                                      "replicas": 1}
        code, ans = _http(base, "/v1/predict", stack["bodies"]["sf"])
        assert code == 200 and ans["tenant"] == "sf" and ans["ok"]
        code, st_ = _http(base, "/v1/stats")
        pid = st_["replicas"]["r0"]["pid"]
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    assert "replicas ready (1/1 admitted)" in stdout
    assert "[router] stopped; exiting 0." in stdout
    assert "SIGTERM received" in stderr
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    events = [r["event"] for r in _ledger(types.SimpleNamespace(root=root))]
    assert events[0] == "replica_launch" and events[-1] == "router_stop"
    assert "router_drain" in events
