"""The port's multi-tenant fleet (service/fleet.py, registry.py,
tenants.py) against the JAX package's, on the CPU: registry files cross
both ways (a kill mid-write leaves the old or the new file), the breaker
and the quota follow the JAX state machines step for step, the two
``FleetEngine``s give the same typed outcome per scripted request and the
same per-tenant counts, and the JAX fleet tests (tests/test_fleet.py) run
on the port: routing, the gate before placement, each fault confined to
its tenant, the HTTP front's status codes, per-tenant stats, the
``fleet`` command and the serve flags; one shared set of programs for 1
and 4 tenants; and ``serve --fleet --device cpu`` end to end.

Size (the JAX fleet tests'): N=6, obs 5, hidden 8, T=60, buckets (1, 2,
4), horizon 1; the checkpoints are the JAX init at SEED (the first seed
that leaves both branches' ReLU heads live) and a nudged copy. Answers against the JAX fleet to rtol 1e-4 /
atol 1e-4 (the rollout's); the port's fleet against its own ServeEngine
bit for bit."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from mpgcn_tpu.service import fleet as jax_fleet
from mpgcn_tpu.service import promote as jax_promote
from mpgcn_tpu.service import registry as jax_registry
from mpgcn_tpu.service import tenants as jax_tenants
from mpgcn_tpu.service.config import FleetConfig as JaxFleetConfig
from mpgcn_tpu.train import ModelTrainer
from mpgcn_tpu.train.checkpoint import save_checkpoint
from mpgcn_tpu.utils import logging as jax_logging
from mpgcn_tpu_torch.config import FleetConfig, MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service import fleet, promote, registry, serve, tenants
from mpgcn_tpu_torch.service.tenants import (
    CLOSED,
    OPEN,
    REJECT_BREAKER_OPEN,
    REJECT_TENANT_UNAVAILABLE,
    REJECT_UNKNOWN_TENANT,
    SHED_TENANT_QUOTA,
)
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils import logging as port_logging
from mpgcn_tpu_torch.utils.convert import params_from_jax, read_checkpoint

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, OBS, H = 6, 5, 8
SEED = 10  # the first JAX init seed at these sizes with both heads live
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, obs_len=OBS,
          pred_len=1, batch_size=4, seed=SEED)
EXTRA = {"num_branches": 2, "branch_sources": ["static", "dynamic"]}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Two JAX-written checkpoints (manifest and integrity record): the
    seeded init and a nudged copy of it (the reload candidate); the test
    windows."""
    import jax

    out = tmp_path_factory.mktemp("torch_fleet")
    cfg = MPGCNConfig(mode="test", **KW)
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(num_nodes=N)
    jcfg = JaxConfig(mode="test", data="synthetic", **KW).replace(
        num_nodes=N)
    params = ModelTrainer(jcfg, data).params
    ckpt, ckpt2 = str(out / "MPGCN_od.pkl"), str(out / "cand.pkl")
    save_checkpoint(ckpt, params, 0, extra=EXTRA)
    save_checkpoint(ckpt2, jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(1.01), params), 1,
        extra=EXTRA)
    pipe = DataPipeline(cfg, data, "cpu")
    md = pipe.modes["test"]
    # every branch's ReLU head live, so no comparison passes vacuously
    model = MPGCN.from_config(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)))
    x = torch.from_numpy(np.array(md.x[:4], np.float32))
    keys = torch.from_numpy(np.asarray(md.keys[:4], np.int64))
    with torch.no_grad():
        _, hidden = model(x, graphs_for(pipe.banks, keys, model.sources),
                          return_hidden=True)
        for br, h in zip(model.branches, hidden):
            assert (torch.relu(br.fc(h)) != 0).float().mean() > 0.1
    return {"cfg": cfg, "jcfg": jcfg, "data": data, "ckpt": ckpt,
            "ckpt2": ckpt2, "x": np.array(md.x), "keys": np.asarray(md.keys)}


def _pkg(name):
    """One package's fleet surface under common names."""
    if name == "jax":
        return types.SimpleNamespace(
            name=name, fleet=jax_fleet, registry=jax_registry,
            promote=jax_promote, logging=jax_logging,
            FaultPlan=JaxFaultPlan, FleetConfig=JaxFleetConfig,
            engine_kw={})
    return types.SimpleNamespace(
        name=name, fleet=fleet, registry=registry, promote=promote,
        logging=port_logging, FaultPlan=FaultPlan, FleetConfig=FleetConfig,
        engine_kw={"device": "cpu"})


PORT = _pkg("port")


def _promote(tenant_root, ckpt, attempt=1, pkg=PORT):
    slot = pkg.promote.promoted_path(tenant_root)
    pkg.promote.promote_checkpoint(ckpt, slot)
    pkg.logging.JsonlLogger(pkg.promote.ledger_path(tenant_root)).log(
        "gate", attempt=attempt, promoted=True,
        candidate_hash=pkg.promote.candidate_hash(slot))
    return slot


def _fleet(stack, root, tenants=("nyc", "sf"), faults=None, promote=True,
           pkg=PORT, reg=None, **fcfg_kw):
    """A fleet over ``root``'s registry (made here unless given), each new
    tenant's incumbent promoted from the stack's checkpoint."""
    root = str(root)
    if reg is None:
        reg = pkg.registry.TenantRegistry.load(root)
        for tid in tenants:
            entry = reg.add(tid)
            if promote:
                _promote(entry["root"], stack["ckpt"], pkg=pkg)
    fcfg = pkg.FleetConfig(output_dir=root,
                           **{"buckets": (1, 2, 4), "max_queue": 8,
                              "max_wait_ms": 2.0, **fcfg_kw})
    cfg = stack["jcfg"] if pkg.name == "jax" else stack["cfg"]
    eng = pkg.fleet.FleetEngine(cfg, stack["data"], fcfg, reg,
                                faults=faults, **pkg.engine_kw)
    return eng, reg


def _req(stack, i=0):
    n = len(stack["x"])
    return stack["x"][i % n], int(stack["keys"][i % n])


def _ok_roundtrip(eng, stack, tenant, i=0):
    t = eng.submit(tenant, *_req(stack, i))
    assert t.wait(30), f"tenant {tenant} request hung"
    return t


def _rows(root, kind=None, ledger="requests"):
    return port_logging.read_events(
        os.path.join(str(root), "serve", f"{ledger}.jsonl"), kind)


# --- registry ------------------------------------------------------------------


def test_registry_files_cross_both_ways(tmp_path):
    """tests/test_fleet.py:62 on the port, and each package reads the
    other's manifest: the same ids, roots, quotas and payloads."""
    root = str(tmp_path)
    reg = registry.TenantRegistry.load(root)
    assert len(reg) == 0
    e = reg.add("nyc", quota=4, support_payload="int8")
    assert os.path.isdir(e["root"])
    for bad in ("../evil", ""):
        with pytest.raises(ValueError):
            reg.add(bad)
    with pytest.raises(ValueError):
        reg.add("x", support_payload="f16")
    theirs = jax_registry.TenantRegistry.load(root)
    assert theirs.tenants == reg.tenants
    theirs.add("sf", quota=2)
    ours = registry.TenantRegistry.load(root)
    assert ours.ids() == ["nyc", "sf"] and ours.tenants == \
        jax_registry.TenantRegistry.load(root).tenants
    assert ours.tenant_root("sf") == theirs.tenant_root("sf")
    ours.remove("nyc")
    assert jax_registry.TenantRegistry.load(root).ids() == ["sf"]
    with pytest.raises(KeyError):
        ours.remove("nyc")
    with open(registry.registry_path(root), "w") as f:
        f.write('{"tenants": [truncated')
    with pytest.raises(registry.RegistryCorruptError):
        registry.TenantRegistry.load(root)
    with open(registry.registry_path(root), "w") as f:
        json.dump({"tenants": {"t": {"quota": 1}}}, f)
    with pytest.raises(registry.RegistryCorruptError):
        registry.TenantRegistry.load(root)
    with pytest.raises(FileNotFoundError):
        registry.TenantRegistry.load(str(tmp_path / "none"),
                                     missing_ok=False)


def test_registry_sigkill_mid_write_loads_old_or_new(tmp_path):
    """tests/test_fleet.py:92: the port's writer killed on either side of
    its os.replace leaves the old or the new manifest, which both
    packages load."""
    root = str(tmp_path)
    registry.TenantRegistry.load(root).add("nyc")

    def run(inject):
        code = ("import os\n"
                "import mpgcn_tpu_torch.utils.atomic as atomic\n"
                "from mpgcn_tpu_torch.service.registry import "
                "TenantRegistry\n"
                f"{inject}\n"
                f"TenantRegistry.load({root!r}).add('sf')\n"
                "os._exit(9)\n")
        p = subprocess.run([sys.executable, "-c", code], timeout=180,
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
        assert p.returncode == 9
        ids = registry.TenantRegistry.load(root).ids()
        assert jax_registry.TenantRegistry.load(root).ids() == ids
        return ids

    assert run("def die(src, dst):\n    os._exit(9)\n"
               "atomic.os.replace = die") == ["nyc"]
    assert run("_real = os.replace\n"
               "def die(src, dst):\n    _real(src, dst)\n    os._exit(9)\n"
               "atomic.os.replace = die") == ["nyc", "sf"]


# --- the walls: the JAX state machines step for step ---------------------------


_BREAKER_OPS = st.lists(st.one_of(
    st.sampled_from(["allow", "ok", "fail", "probe_ok", "probe_fail",
                     "probe_abort", "state"]),
    st.floats(0.0, 12.0)), max_size=40)


@settings(max_examples=60, deadline=None)
@given(threshold=st.integers(0, 4), cooldown=st.floats(0.0, 10.0),
       ops=_BREAKER_OPS)
def test_breaker_follows_the_jax_state_machine(threshold, cooldown, ops):
    """The same scripted sequence on one fake clock (a float advances
    it): every return value, state, trip count and transition the same."""
    now = [0.0]
    seen = {"port": [], "jax": []}
    pb = tenants.CircuitBreaker(threshold, cooldown, clock=lambda: now[0],
                                on_transition=seen["port"].append)
    jb = jax_tenants.CircuitBreaker(threshold, cooldown,
                                    clock=lambda: now[0],
                                    on_transition=seen["jax"].append)
    for op in ops:
        if isinstance(op, float):
            now[0] += op
            continue
        got = []
        for b in (pb, jb):
            if op == "allow":
                got.append(b.allow())
            elif op in ("ok", "fail"):
                got.append(b.record(op == "ok"))
            elif op in ("probe_ok", "probe_fail"):
                got.append(b.probe_result(op == "probe_ok"))
            elif op == "probe_abort":
                got.append(b.probe_abort())
            else:
                got.append((b.state, b.state_name))
        assert got[0] == got[1], op
        assert (pb.state, pb.trips) == (jb.state, jb.trips), op
    assert seen["port"] == seen["jax"]


@settings(max_examples=40, deadline=None)
@given(limit=st.integers(0, 3),
       ops=st.lists(st.sampled_from(["acquire", "release"]), max_size=30))
def test_quota_follows_the_jax_bulkhead(limit, ops):
    pq, jq = tenants.TenantQuota(limit), jax_tenants.TenantQuota(limit)
    for op in ops:
        assert getattr(pq, op)() == getattr(jq, op)()
        assert (pq.inflight, pq.shed) == (jq.inflight, jq.shed)


def test_outcome_names_and_config_validation_match(tmp_path):
    """The typed outcomes and breaker states are the JAX strings and
    codes; FleetConfig validates as the JAX one, and the mesh ladder the
    JAX fleet takes is refused by name (multi-device work)."""
    for name in ("SHED_TENANT_QUOTA", "REJECT_BREAKER_OPEN",
                 "REJECT_UNKNOWN_TENANT", "REJECT_TENANT_UNAVAILABLE",
                 "BREAKER_FAILURE_OUTCOMES", "CLOSED", "HALF_OPEN",
                 "OPEN"):
        assert getattr(tenants, name) == getattr(jax_tenants, name), name
    d = str(tmp_path)
    ours, ref = FleetConfig(output_dir=d), JaxFleetConfig(output_dir=d)
    for f in ("tenant_max_inflight", "breaker_threshold",
              "breaker_cooldown_s", "mesh_rungs", "buckets", "max_queue"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert isinstance(ours, ServeConfig)
    for kw in ({"tenant_max_inflight": -1}, {"breaker_threshold": -1},
               {"breaker_cooldown_s": -1}, {"mesh_rungs": (4, 8)},
               {"mesh_rungs": (8, 8)}, {"mesh_rungs": (0,)},
               {"buckets": ()}, {"canary_fraction": 0.0}):
        for cls in (FleetConfig, JaxFleetConfig):
            with pytest.raises(ValueError):
                cls(output_dir=d, **kw)
    JaxFleetConfig(output_dir=d, mesh_rungs=(8, 4, 2, 1))
    with pytest.raises(ValueError, match="Queue 1 item 6"):
        FleetConfig(output_dir=d, mesh_rungs=(8, 4, 2, 1))
    FleetConfig(output_dir=d, tenant_max_inflight=0, breaker_threshold=0,
                breaker_cooldown_s=0.0)


# --- the two fleets on one registry -----------------------------------------


def test_port_fleet_matches_the_jax_fleet(stack, tmp_path):
    """One registry (nyc on the init, sf on the candidate, down with no
    slot), read by both packages' fleets (ledgers apart); the same
    scripted requests give the same typed outcome each, answers within
    the rollout's 1e-4, and the same per-tenant outcome counts; the
    port's answers equal its own ServeEngine's on each checkpoint bit for
    bit."""
    root = str(tmp_path / "reg")
    reg = registry.TenantRegistry.load(root)
    _promote(reg.add("nyc")["root"], stack["ckpt"])
    _promote(reg.add("sf")["root"], stack["ckpt2"])
    reg.add("down")
    x, key = _req(stack, 0)
    bad_shape = np.ones((OBS, N + 1, N + 1), np.float32)
    nan_x = np.array(x)
    nan_x[0, 0, 0] = np.nan
    script = [("nyc", x, key, None), ("sf", *_req(stack, 1), None),
              ("tokyo", x, key, None), (None, x, key, None),
              ("down", x, key, None), ("nyc", bad_shape, key, None),
              ("sf", x, key, 3), ("nyc", nan_x, key, None),
              ("sf", *_req(stack, 2), None), ("nyc", *_req(stack, 3), None)]
    got = {}
    for name in ("port", "jax"):
        pkg = _pkg(name)
        reg_p = pkg.registry.TenantRegistry.load(root)
        eng, _ = _fleet(stack, tmp_path / name, pkg=pkg, reg=reg_p)
        try:
            tickets = [eng.submit(tid, xx, kk, horizon=h)
                       for tid, xx, kk, h in script]
            for t in tickets:
                assert t.wait(60)
            stats = eng.stats()
            got[name] = ([(t.outcome, t.tenant,
                           None if t.pred is None else np.asarray(t.pred))
                          for t in tickets], stats, eng.trace_count)
        finally:
            eng.close()
    (ours, s_ours, tr_ours), (ref, s_ref, tr_ref) = got["port"], got["jax"]
    assert [o[:2] for o in ours] == [o[:2] for o in ref]
    assert [o[0] for o in ours] == [
        "ok", "ok", REJECT_UNKNOWN_TENANT, REJECT_UNKNOWN_TENANT,
        REJECT_TENANT_UNAVAILABLE, "rejected-invalid", "rejected-invalid",
        "rejected-invalid", "ok", "ok"]
    for (o, _, p), (_, _, q) in zip(ours, ref):
        if o == "ok":
            assert (p != 0).mean() > 0.1  # a live output
            np.testing.assert_allclose(p, q, **TOL)
    assert tr_ours == tr_ref == 3
    assert s_ours["resolved"] == s_ref["resolved"] == len(script)
    for tid in ("nyc", "sf", "down"):
        a, b = s_ours["tenants"][tid], s_ref["tenants"][tid]
        assert a["outcomes"] == b["outcomes"], tid
        for k in ("available", "breaker", "breaker_trips", "quota"):
            assert a[k] == b[k], (tid, k)
    assert set(s_ref) <= set(s_ours)
    # the port's fleet against its own single-tenant engine, bit for bit
    for tid, ckpt, i in (("nyc", stack["ckpt"], 0), ("sf", stack["ckpt2"], 1)):
        eng = serve.ServeEngine(stack["cfg"], stack["data"], ServeConfig(
            output_dir=str(tmp_path / f"one_{tid}"), buckets=(1, 2, 4)),
            device="cpu", init_ckpt=ckpt)
        try:
            t = eng.submit(*_req(stack, i))
            assert t.wait(30) and t.ok
            assert np.array_equal(np.asarray(t.pred), ours[i][2])
        finally:
            eng.close()


def test_int8_fleet_matches_the_jax_int8_fleet(stack, tmp_path):
    """At infer_precision int8 each tenant's resident set is its int8
    codes and scales: the same resident bytes as the JAX fleet's, answers
    within 1e-4 of the JAX fleet's and bit for bit those of the port's
    int8 ServeEngine on the same checkpoint."""
    root = str(tmp_path / "reg")
    reg = registry.TenantRegistry.load(root)
    _promote(reg.add("nyc")["root"], stack["ckpt"])
    _promote(reg.add("sf")["root"], stack["ckpt2"])
    got = {}
    for name in ("port", "jax"):
        pkg = _pkg(name)
        s8 = {**stack, "cfg": stack["cfg"].replace(infer_precision="int8"),
              "jcfg": stack["jcfg"].replace(infer_precision="int8")}
        eng, _ = _fleet(s8, tmp_path / name, pkg=pkg,
                        reg=pkg.registry.TenantRegistry.load(root),
                        buckets=(1, 2))
        try:
            got[name] = ({t: np.asarray(_ok_roundtrip(eng, stack, t, i).pred)
                          for i, t in enumerate(("nyc", "sf"))},
                         {t: v["resident_bytes"]
                          for t, v in eng.stats()["tenants"].items()})
        finally:
            eng.close()
    (ours, bytes_ours), (ref, bytes_ref) = got["port"], got["jax"]
    assert bytes_ours == bytes_ref
    f32 = sum(p.numel() * 4 for p in params_from_jax(
        read_checkpoint(stack["ckpt"])["params"]).values())
    assert bytes_ours["nyc"] < 0.5 * f32
    for t in ("nyc", "sf"):
        np.testing.assert_allclose(ours[t], ref[t], **TOL)
    for i, (t, ckpt) in enumerate((("nyc", stack["ckpt"]),
                                   ("sf", stack["ckpt2"]))):
        eng = serve.ServeEngine(
            stack["cfg"].replace(infer_precision="int8"), stack["data"],
            ServeConfig(output_dir=str(tmp_path / f"one_{t}"),
                        buckets=(1, 2)), device="cpu", init_ckpt=ckpt)
        try:
            tk = eng.submit(*_req(stack, i))
            assert tk.wait(30) and tk.ok
            assert np.array_equal(np.asarray(tk.pred), ours[t])
        finally:
            eng.close()


# --- the JAX fleet tests on the port -------------------------------------------


def test_fleet_routes_per_tenant_and_types_unknown(stack, tmp_path):
    """tests/test_fleet.py:263, :298 and :314: per-tenant routing, unknown
    and ambiguous tenants typed, the programs shared, ledger rows by
    tenant; one tenant takes a request with no tenant."""
    eng, _ = _fleet(stack, tmp_path / "svc")
    try:
        assert eng.trace_count == 3
        t = _ok_roundtrip(eng, stack, "nyc")
        assert t.ok and t.tenant == "nyc"
        t2 = _ok_roundtrip(eng, stack, "sf")
        assert t2.ok and t2.tenant == "sf"
        np.testing.assert_array_equal(np.asarray(t.pred),
                                      np.asarray(t2.pred))
        assert eng.submit("tokyo", *_req(stack)).outcome == \
            REJECT_UNKNOWN_TENANT
        assert eng.submit(None, *_req(stack)).outcome == \
            REJECT_UNKNOWN_TENANT
        assert eng.trace_count == 3
        rows = _rows(tmp_path / "svc", "request")
        assert {r.get("tenant") for r in rows} >= {"nyc", "sf", None}
    finally:
        eng.close()
    solo, _ = _fleet(stack, tmp_path / "solo", tenants=("solo",))
    try:
        t = solo.submit(None, *_req(stack))
        assert t.wait(30) and t.ok and t.tenant == "solo"
    finally:
        solo.close()


def test_corrupt_candidate_rejected_before_placement(stack, tmp_path):
    """tests/test_fleet.py:322: a torn candidate never reaches the
    placement seam; the tenant keeps serving."""
    eng, reg = _fleet(stack, tmp_path / "svc", tenants=("nyc",))
    try:
        places = []
        real_place = eng._place
        eng._place = lambda tree: (places.append(1), real_place(tree))[1]
        with open(stack["ckpt2"], "rb") as f:
            torn = f.read()[:300]
        slot = promote.promoted_path(reg.tenant_root("nyc"))
        with open(slot, "wb") as f:
            f.write(torn)
        port_logging.JsonlLogger(promote.ledger_path(
            reg.tenant_root("nyc"))).log(
            "gate", attempt=2, promoted=True,
            candidate_hash=promote.candidate_hash(slot))
        rel = fleet.CanaryReloader(eng._views["nyc"], eng.fcfg)
        assert rel.poll() == "rejected-integrity"
        assert places == []
        assert _ok_roundtrip(eng, stack, "nyc").ok
    finally:
        eng.close()


def test_quota_saturation_blast_radius_one_tenant(stack, tmp_path):
    """tests/test_fleet.py:356: one tenant's flood sheds inside its walls;
    the other's requests all succeed; no program is added."""
    eng, _ = _fleet(stack, tmp_path / "svc", tenants=("flooded", "calm"),
                    tenant_max_inflight=4, max_queue=4, deadline_ms=0)
    try:
        traces0 = eng.trace_count
        x, key = _req(stack)
        flood = [eng.submit("flooded", x, key) for _ in range(60)]
        calm = [_ok_roundtrip(eng, stack, "calm", i) for i in range(6)]
        for t in flood:
            assert t.wait(60)
        outcomes = {t.outcome for t in flood}
        shed = {SHED_TENANT_QUOTA, "shed-queue-full"}
        assert outcomes <= ({"ok"} | shed), outcomes
        assert outcomes & shed
        assert all(t.ok for t in calm)
        assert eng.trace_count == traces0
        s = eng.stats()
        assert s["tenants"]["calm"]["outcomes"] == {"ok": 6}
        assert s["tenants"]["calm"]["quota"]["shed"] == 0
        assert s["tenants"]["flooded"]["quota"]["inflight"] == 0
        assert sum(s["tenants"]["flooded"]["outcomes"].get(o, 0)
                   for o in shed) > 0
    finally:
        eng.close()


def _poisoned(params):
    return {k: v * float("nan") for k, v in params.items()}


def test_breaker_trips_one_tenant_and_recovers(stack, tmp_path):
    """tests/test_fleet.py:389: a tenant whose resident params go NaN
    trips its breaker (429-typed without the device), its neighbour keeps
    serving, and after the cooldown the half-open probe closes it."""
    eng, _ = _fleet(stack, tmp_path / "svc", tenants=("bad", "good"),
                    breaker_threshold=3, breaker_cooldown_s=0.2)
    try:
        ts = eng.tenants["bad"]
        good_params = ts.incumbent.params
        ts.incumbent.params = _poisoned(good_params)
        for i in range(3):
            t = eng.submit("bad", *_req(stack, i))
            assert t.wait(30) and t.outcome == "error-nonfinite"
        assert ts.breaker.state == OPEN
        t = eng.submit("bad", *_req(stack))
        assert t.outcome == REJECT_BREAKER_OPEN
        assert _ok_roundtrip(eng, stack, "good").ok
        assert eng.tenants["good"].breaker.state == CLOSED
        ts.incumbent.params = good_params
        time.sleep(0.25)
        t = eng.submit("bad", *_req(stack))
        assert t.wait(30) and t.ok
        assert ts.breaker.state == CLOSED
        assert _ok_roundtrip(eng, stack, "bad").ok
        assert eng.stats()["tenants"]["bad"]["breaker_trips"] == 1
        assert eng.trace_count == 3
    finally:
        eng.close()


def test_poison_promotion_rolls_back_alone(stack, tmp_path):
    """tests/test_fleet.py:424: ``poison_reload`` on one tenant rejects the
    candidate there, its incumbent bit for bit as before, while the other
    tenant promotes the same candidate; no program added."""
    eng, reg = _fleet(
        stack, tmp_path / "svc", tenants=("poisoned", "healthy"),
        faults=FaultPlan.parse("poison_reload=1,fault_tenant=0"),
        canary_requests=0)
    rel = fleet.FleetReloader(eng)
    try:
        traces0 = eng.trace_count
        before = {tid: _ok_roundtrip(eng, stack, tid)
                  for tid in ("poisoned", "healthy")}
        for tid in ("poisoned", "healthy"):
            _promote(reg.tenant_root(tid), stack["ckpt2"], attempt=2)
        actions = rel.poll_all()
        # fault_tenant indexes the sorted ids: 'healthy' is 0
        assert actions == {"healthy": "rejected-smoke",
                           "poisoned": "canary-started"}
        after = _ok_roundtrip(eng, stack, "healthy")
        np.testing.assert_array_equal(np.asarray(after.pred),
                                      np.asarray(before["healthy"].pred))
        moved = _ok_roundtrip(eng, stack, "poisoned")
        assert not np.array_equal(np.asarray(moved.pred),
                                  np.asarray(before["poisoned"].pred))
        assert eng._views["poisoned"].incumbent_hash == \
            promote.candidate_hash(promote.promoted_path(
                reg.tenant_root("poisoned")))
        assert eng.trace_count == traces0
        rows = _rows(tmp_path / "svc", "reload_rollback", "reloads")
        assert len(rows) == 1 and rows[0]["tenant"] == "healthy"
    finally:
        eng.close()


def test_corrupt_tenant_slot_isolated_and_recovers(stack, tmp_path):
    """tests/test_fleet.py:476: a torn slot at startup leaves that tenant
    unavailable (typed 503 outcome), the other serving; a good
    re-promotion recovers it without a restart or a new program."""
    eng, reg = _fleet(
        stack, tmp_path / "svc", tenants=("broken", "fine"),
        faults=FaultPlan.parse("corrupt_tenant_slot=1,fault_tenant=0"),
        canary_requests=0)
    rel = fleet.FleetReloader(eng)
    try:
        traces0 = eng.trace_count
        assert not eng.tenants["broken"].available
        assert eng.submit("broken", *_req(stack)).outcome == \
            REJECT_TENANT_UNAVAILABLE
        assert _ok_roundtrip(eng, stack, "fine").ok
        _promote(reg.tenant_root("broken"), stack["ckpt2"], attempt=2)
        assert rel.poll_all()["broken"] == "canary-started"
        assert eng.tenants["broken"].available
        assert _ok_roundtrip(eng, stack, "broken").ok
        assert eng.trace_count == traces0
        un = _rows(tmp_path / "svc", "tenant_unavailable")
        assert un and un[0]["tenant"] == "broken"
    finally:
        eng.close()


def test_sigkill_mid_tenant_promotion_ledger_append_only(stack, tmp_path):
    """tests/test_fleet.py:511: a promoter killed on either side of its
    os.replace leaves the old or the new slot; the ledger's old bytes
    stay a prefix; the fleet starts on the complete new slot."""
    root = str(tmp_path / "svc")
    reg = registry.TenantRegistry.load(root)
    entry = reg.add("nyc")
    _promote(entry["root"], stack["ckpt"])
    slot = promote.promoted_path(entry["root"])
    h1, h2 = promote.candidate_hash(slot), promote.candidate_hash(
        stack["ckpt2"])
    lpath = promote.ledger_path(entry["root"])
    with open(lpath, "rb") as f:
        ledger_before = f.read()

    def run(inject):
        code = ("import os\n"
                "import mpgcn_tpu_torch.utils.atomic as atomic\n"
                "from mpgcn_tpu_torch.service.promote import "
                "promote_checkpoint\n"
                f"{inject}\n"
                f"promote_checkpoint({stack['ckpt2']!r}, {slot!r})\n"
                "os._exit(9)\n")
        p = subprocess.run([sys.executable, "-c", code], timeout=180,
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
        assert p.returncode == 9

    run("def die(src, dst):\n    os._exit(9)\natomic.os.replace = die")
    assert promote.candidate_hash(slot) == h1
    run("_real = os.replace\n"
        "def die(src, dst):\n    _real(src, dst)\n    os._exit(9)\n"
        "atomic.os.replace = die")
    assert promote.candidate_hash(slot) == h2
    with open(lpath, "rb") as f:
        assert f.read().startswith(ledger_before)
    eng, _ = _fleet(stack, root, reg=registry.TenantRegistry.load(root))
    try:
        assert eng.tenants["nyc"].available
        assert eng._views["nyc"].incumbent_hash == h2
        assert _ok_roundtrip(eng, stack, "nyc").ok
    finally:
        eng.close()


def _post(base, payload):
    req = urllib.request.Request(
        base + "/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_front_routes_tenants_and_status_codes(stack, tmp_path):
    """tests/test_fleet.py:668: 200, 404 unknown and ambiguous, 400 for a
    non-string tenant, 503 for an unavailable tenant, 500 then 429 for a
    failing tenant's breaker, the neighbour 200; /v1/stats and /metrics
    per tenant."""
    eng, reg = _fleet(stack, tmp_path / "svc", tenants=("nyc", "sf"),
                      breaker_threshold=2, breaker_cooldown_s=30.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve._make_handler(eng))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    x, key = _req(stack)
    body = {"x": np.asarray(x)[..., 0].tolist(), "key": key}
    try:
        code, r = _post(base, {**body, "tenant": "nyc"})
        assert code == 200 and r["ok"] and r["tenant"] == "nyc"
        code, r = _post(base, {**body, "tenant": "tokyo"})
        assert code == 404 and r["outcome"] == REJECT_UNKNOWN_TENANT
        assert _post(base, body)[0] == 404
        assert _post(base, {**body, "tenant": 7})[0] == 400
        eng.tenants["sf"].incumbent = None
        code, r = _post(base, {**body, "tenant": "sf"})
        assert code == 503 and r["outcome"] == REJECT_TENANT_UNAVAILABLE
        eng.tenants["sf"].incumbent = eng.tenants["nyc"].incumbent
        ts = eng.tenants["sf"]
        ts.incumbent = fleet._ParamSet(_poisoned(ts.incumbent.params),
                                       ts.incumbent.hash, ts.incumbent.seq)
        for _ in range(2):
            assert _post(base, {**body, "tenant": "sf"})[0] == 500
        code, r = _post(base, {**body, "tenant": "sf"})
        assert code == 429 and r["outcome"] == REJECT_BREAKER_OPEN
        code, r = _post(base, {**body, "tenant": "nyc"})
        assert code == 200 and r["ok"]
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert set(stats["tenants"]) == {"nyc", "sf"}
        assert stats["tenants"]["sf"]["breaker"] == "open"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            prom = r.read().decode()
        assert 'serve_requests_total{outcome="ok",tenant="nyc"}' in prom
        assert 'serve_breaker_state{tenant="sf"} 2' in prom
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.load(r)["incumbent"].startswith("nyc:")
    finally:
        httpd.shutdown()
        eng.close()


def test_stats_per_tenant_view(stack, tmp_path):
    """tests/test_fleet.py:729, read from the port's own records (its
    ``stats`` subcommand is not ported): per-tenant counts and latency in
    ``stats()``, ledger rows and span rows carrying the tenant."""
    from mpgcn_tpu_torch.obs.trace import spans_path

    eng, _ = _fleet(stack, tmp_path / "svc")
    try:
        for i in range(3):
            _ok_roundtrip(eng, stack, "nyc", i)
        _ok_roundtrip(eng, stack, "sf")
        eng.submit("tokyo", *_req(stack))
        s = eng.stats()
    finally:
        eng.drain(10)
        eng.close()
    assert s["tenants"]["nyc"]["outcomes"] == {"ok": 3}
    assert s["tenants"]["nyc"]["latency_ms"]["n"] == 3
    assert s["tenants"]["nyc"]["latency_ms"]["p50"] is not None
    assert s["tenants"]["sf"]["outcomes"] == {"ok": 1}
    assert s["resolved"] == 5 and s["traces"] == 3
    assert s["tenants"]["nyc"]["resident_bytes"] == sum(
        p.numel() * 4 for p in eng.model.parameters())
    rows = _rows(tmp_path / "svc", "request")
    per = {}
    for r in rows:
        per[r["tenant"]] = per.get(r["tenant"], 0) + 1
    assert per == {"nyc": 3, "sf": 1, None: 1}
    assert _rows(tmp_path / "svc")[-1]["event"] == "fleet_stop"
    spans = port_logging.read_events(spans_path(str(tmp_path / "svc")))
    assert {r.get("tenant") for r in spans
            if r.get("name") == "serve.request"} == {"nyc", "sf"}
    assert any(r.get("name") == "serve.model" and r.get("tenant") == "nyc"
               for r in spans)


def test_fleet_cli_edits_the_jax_registry(tmp_path, capsys):
    """tests/test_fleet.py:788 through ``python -m mpgcn_tpu_torch.cli
    fleet``, on the manifest the JAX command edits; the parser is the JAX
    one less ``--profile``."""
    from mpgcn_tpu_torch import cli

    def port(*argv):
        with pytest.raises(SystemExit) as e:
            cli.main(["fleet", *argv])
        return e.value.code

    root = str(tmp_path)
    assert port("add", "nyc", "-out", root) == 0
    assert port("add", "sf", "-out", root, "--quota", "4") == 0
    assert port("list", "-out", root) == 0
    out = capsys.readouterr().out
    assert "nyc" in out and '"quota": 4' in out
    assert jax_registry.main(["add", "la", "-out", root,
                              "--support-payload", "int8"]) == 0
    assert port("remove", "nyc", "-out", root) == 0
    assert jax_registry.TenantRegistry.load(root).ids() == ["la", "sf"]
    assert registry.TenantRegistry.load(root).tenants["la"][
        "support_payload"] == "int8"
    assert port("remove", "ghost", "-out", root) == 1
    assert port("add", "-out", root) == 2

    def flags(p):
        return {o for a in p._actions for o in a.option_strings}

    assert flags(jax_registry.build_parser()) - flags(
        registry.build_parser()) == {"--profile"}
    assert flags(registry.build_parser()) <= flags(
        jax_registry.build_parser())


def test_serve_parser_fleet_flags():
    """tests/test_fleet.py:803, less ``--mesh-rungs``; defaults as the
    JAX parser's."""
    ns = serve.build_parser().parse_args(
        ["-out", "/tmp/x", "--fleet", "--tenant-quota", "8",
         "--breaker-threshold", "2", "--breaker-cooldown", "1.5"])
    assert ns.fleet and ns.tenant_quota == 8
    assert ns.breaker_threshold == 2 and ns.breaker_cooldown == 1.5
    from mpgcn_tpu.service.serve import build_parser as jax_parser

    ref = jax_parser().parse_args(["-out", "/tmp/x"])
    ours = serve.build_parser().parse_args(["-out", "/tmp/x"])
    for f in ("fleet", "tenant_quota", "breaker_threshold",
              "breaker_cooldown"):
        assert getattr(ours, f) == getattr(ref, f), f


# --- one set of programs for every tenant --------------------------------------


@pytest.mark.parametrize("n_tenants", [1, 4])
def test_program_count_does_not_grow_with_tenants(stack, tmp_path,
                                                  n_tenants):
    """|buckets| x |horizons| programs (on the CPU the eager warm-up runs;
    on the card the captured graphs) with 1 tenant and with 4, unchanged
    by requests, a promotion, a rolled-back canary and a recovered
    tenant."""
    tids = [f"t{i}" for i in range(n_tenants)]
    eng, reg = _fleet(stack, tmp_path / "svc", tenants=tids,
                      horizons=(1,), canary_requests=2,
                      canary_fraction=1.0)
    rel = fleet.FleetReloader(eng)
    try:
        assert eng.trace_count == 3
        for i, tid in enumerate(tids):
            assert _ok_roundtrip(eng, stack, tid, i).ok
        _promote(reg.tenant_root(tids[0]), stack["ckpt2"], attempt=2)
        assert rel.poll_all()[tids[0]] == "canary-started"
        ts = eng.tenants[tids[0]]
        ts.canary.params = _poisoned(ts.canary.params)
        t = _ok_roundtrip(eng, stack, tids[0])  # served again, rolled back
        assert t.ok and not t.canary and ts.canary is None
        assert _rows(tmp_path / "svc", "reload_rollback", "reloads")
        for tid in tids:
            assert _ok_roundtrip(eng, stack, tid).ok
        assert eng.trace_count == 3 and eng.stats()["traces"] == 3
    finally:
        eng.close()


def test_entry_points_refuse_cpu_unless_asked(stack, tmp_path, monkeypatch):
    """FleetEngine, build_fleet and ``serve --fleet`` raise without CUDA
    unless the CPU is asked for, before they write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = registry.TenantRegistry.load(str(tmp_path / "reg"))
    reg.add("nyc")
    out = tmp_path / "out"
    fcfg = FleetConfig(output_dir=str(out))
    for call in (lambda: fleet.FleetEngine(stack["cfg"], stack["data"],
                                           fcfg, reg),
                 lambda: fleet.build_fleet(stack["cfg"], stack["data"],
                                           fcfg, str(tmp_path / "reg"))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        serve.main(["-out", str(out), "--fleet"])
    assert not out.exists()


# --- the command ------------------------------------------------------------------


def test_serve_fleet_command_over_http(stack, tmp_path):
    """``python -m mpgcn_tpu_torch.cli serve --fleet --device cpu`` serves
    two tenants (and one without a slot) over HTTP: 200, 404, 503, and
    429 for a second request while the first holds a quota of 1; SIGTERM
    drains and exits 0."""
    root = str(tmp_path / "svc")
    reg = registry.TenantRegistry.load(root)
    _promote(reg.add("nyc")["root"], stack["ckpt"])
    _promote(reg.add("sf", quota=1)["root"], stack["ckpt2"])
    reg.add("down")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("MPGCN_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve", "--fleet",
         "--device", "cpu", "-out", root, "-obs", str(OBS), "-sN", str(N),
         "-sT", "60", "-hidden", str(H), "-seed", str(SEED), "--buckets",
         "1,2", "--max-wait-ms", "1500", "--deadline-ms", "10000",
         "--reload-poll-secs", "0.2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        info_path = serve.http_info_path(root)
        t0 = time.time()
        while not os.path.exists(info_path):
            assert proc.poll() is None, proc.communicate()
            assert time.time() - t0 < 120, "the fleet never came up"
            time.sleep(0.1)
        with open(info_path) as f:
            base = "http://127.0.0.1:{port}".format(**json.load(f))
        x, key = _req(stack)
        body = {"x": np.asarray(x)[..., 0].tolist(), "key": key}
        codes = {}
        held = threading.Thread(target=lambda: codes.setdefault(
            "first", _post(base, {**body, "tenant": "sf"})))
        held.start()
        time.sleep(0.5)  # the first sf request waits in its 1.5 s window
        codes["second"] = _post(base, {**body, "tenant": "sf"})
        held.join(60)
        assert codes["first"][0] == 200 and codes["first"][1]["ok"]
        assert codes["second"][0] == 429
        assert codes["second"][1]["outcome"] == SHED_TENANT_QUOTA
        code, r = _post(base, {**body, "tenant": "nyc"})
        assert code == 200 and r["tenant"] == "nyc"
        assert _post(base, {**body, "tenant": "tokyo"})[0] == 404
        assert _post(base, {**body, "tenant": "down"})[0] == 503
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["fleet"] and stats["traces"] == 2
        assert stats["tenants"]["sf"]["quota"]["shed"] == 1
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    assert "drained (clean)" in stdout and "SIGTERM received" in stderr
    rows = _rows(root)
    assert [r["tenant"] for r in rows[:1]] == ["down"]  # no slot yet
    assert rows[1]["event"] == "fleet_start"
    assert rows[1]["available"] == ["nyc", "sf"]
    assert rows[-1]["event"] == "fleet_stop" and rows[-1]["drained"]
