"""The port's telemetry plane and serving helpers against the JAX
package's, with no model: the fault-spec grammar, scripted metric
operations rendered to Prometheus text and snapshots, the SLO engine's
reports under a fake clock, span stitching, JSONL rotation with torn
tails, the flight recorder, the device sampler on the CPU, the serving
load's checkpoint verification, the small serving helpers, the
ServeConfig, and the double-buffered feed's cases on stub batchers of
both packages."""

import math
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from mpgcn_tpu import config as jax_config
from mpgcn_tpu.obs import flight as jax_flight
from mpgcn_tpu.obs import metrics as jax_metrics
from mpgcn_tpu.obs import trace as jax_trace
from mpgcn_tpu.obs.perf import slo as jax_slo
from mpgcn_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from mpgcn_tpu.scenarios.dynamics import poison_request as jax_poison_request
from mpgcn_tpu.service import batcher as jax_batcher
from mpgcn_tpu.service.capture import capture_row_fields as jax_capture
from mpgcn_tpu.service.config import ServeConfig as JaxServeConfig
from mpgcn_tpu.service.daemon import window_split_ratio as jax_split
from mpgcn_tpu.service.ingest import day_filename as jax_day_filename
from mpgcn_tpu.service.ingest import parse_day_index as jax_parse_day
from mpgcn_tpu.service.promote import poison_checkpoint as jax_poison_ckpt
from mpgcn_tpu.train.checkpoint import (
    CheckpointCorruptError as JaxCorrupt,
    load_serving_params as jax_load_serving,
    save_checkpoint as jax_save_checkpoint,
)
from mpgcn_tpu.utils import logging as jax_logging
from mpgcn_tpu_torch import config as port_config
from mpgcn_tpu_torch.config import ServeConfig
from mpgcn_tpu_torch.obs import flight
from mpgcn_tpu_torch.obs import metrics
from mpgcn_tpu_torch.obs import trace
from mpgcn_tpu_torch.obs.device import DeviceSampler
from mpgcn_tpu_torch.obs.perf import slo
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.scenarios.dynamics import poison_request
from mpgcn_tpu_torch.service import batcher
from mpgcn_tpu_torch.service.capture import capture_row_fields
from mpgcn_tpu_torch.service.daemon import window_split_ratio
from mpgcn_tpu_torch.service.ingest import day_filename, parse_day_index
from mpgcn_tpu_torch.service.promote import poison_checkpoint
from mpgcn_tpu_torch.train.checkpoint import (
    CheckpointCorruptError,
    load_serving_params,
)
from mpgcn_tpu_torch.utils import logging as port_logging

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


# --- the fault plan -----------------------------------------------------------


FAULT_SPECS = [
    "", "flood_qps=200", "poison_reload=1", "slow_request=2,slow_secs=0.1",
    "poison_requests=3", "nan_step=3,sigterm_epoch=2", "io_errors=2",
    "fault_host=0,kill_host_epoch=2", "hang_epoch=1,hang_secs=0.5",
    "fault_tenant=0,corrupt_tenant_slot=1", "partition_replica=4,"
    "partition_secs=0.5", " flood_qps = 7 , slow_secs=2",
    # invalid: unknown key, no '=', bad value, below the floor, <= 0
    "bogus=1", "flood_qps", "flood_qps=x", "flood_qps=0", "slow_secs=0",
    "hang_secs=-1", "io_errors=-1", "straggle_secs=0", "nan_step=1.5",
]


def _plan_fields(plan):
    return {k: v for k, v in vars(plan).items() if not k.startswith("_")}


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_parses_as_jax_does(spec):
    try:
        ref = _plan_fields(JaxFaultPlan.parse(spec))
    except ValueError:
        with pytest.raises(ValueError):
            FaultPlan.parse(spec)
        return
    ours = FaultPlan.parse(spec)
    assert _plan_fields(ours) == ref
    assert ours.active == JaxFaultPlan.parse(spec).active


def test_serving_fault_hooks_fire_as_jax_does(monkeypatch):
    spec = "flood_qps=7,poison_reload=2,slow_request=2,slow_secs=0.01," \
           "poison_requests=2"
    ours, ref = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    for p in (ours, ref):
        assert [p.take_flood(), p.take_flood()] == [7, 0]
        assert [p.take_poison_reload(i) for i in (1, 2, 2)] == \
            [False, True, False]
        assert [p.maybe_slow_request(i) for i in (1, 2, 2)] == \
            [False, True, False]
        assert [p.take_poison_request(i) for i in (1, 2, 3)] == \
            [True, True, False]
    monkeypatch.setenv("MPGCN_FAULTS", "flood_qps=3")
    cfg = port_config.MPGCNConfig()
    assert FaultPlan.from_config(cfg).flood_qps == 3 == \
        JaxFaultPlan.from_config(jax_config.MPGCNConfig()).flood_qps
    assert FaultPlan.from_config(cfg.replace(faults="slow_request=1")) \
        .flood_qps is None
    monkeypatch.setenv("MPGCN_FAULTS", "nope=1")
    for plan_cls, c in ((FaultPlan, cfg),
                        (JaxFaultPlan, jax_config.MPGCNConfig())):
        with pytest.raises(ValueError, match="MPGCN_FAULTS"):
            plan_cls.from_config(c)
    with pytest.raises(ValueError):
        port_config.MPGCNConfig(faults="flood_qps=0")


# --- metrics -------------------------------------------------------------------


def _script(m, reg):
    """The same metric operations on either package's registry."""
    c = reg.counter("serve_requests", "resolved requests")
    c.inc()
    c.labels(outcome="ok").inc(5)
    c.labels(outcome="shed-queue-full").inc(2)
    c.labels(outcome='we"ird\\lab\nel').inc()
    reg.gauge("depth", "queue\ndepth").set(7)
    reg.gauge("pull").set_fn(lambda: 41 + 1)
    reg.gauge("nan_gauge").set(float("nan"))
    g = reg.gauge("slo_state")
    g.labels(slo="a").set(2)
    g.labels(slo="b").set(0)
    h = reg.histogram("lat", "latency", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 5.0, 50.0, 1e9):
        h.observe(v)
    ht = reg.histogram("lat_t", buckets=(10.0, 100.0))
    ht.labels(tenant="a").observe(3.0)
    ht.labels(tenant="b").observe(300.0)
    reg.histogram("empty_h")
    return reg


def test_metrics_render_and_snapshot_equal_jax():
    ours = _script(metrics, metrics.MetricsRegistry())
    ref = _script(jax_metrics, jax_metrics.MetricsRegistry())
    assert metrics.render_prometheus(ours) == \
        jax_metrics.render_prometheus(ref)
    a, b = ours.snapshot(), ref.snapshot()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), k
    # merged renders dedupe by family as the JAX encoder does
    other = metrics.MetricsRegistry()
    other.counter("serve_requests").inc(99)
    jother = jax_metrics.MetricsRegistry()
    jother.counter("serve_requests").inc(99)
    assert metrics.render_prometheus(ours, other) == \
        jax_metrics.render_prometheus(ref, jother)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert ours.histogram("lat").quantile(q) == \
            ref.histogram("lat").quantile(q)
    with pytest.raises(TypeError):
        ours.gauge("serve_requests")
    with pytest.raises(ValueError):
        ours.histogram("no_buckets", buckets=())


@pytest.mark.parametrize("counts,n,q", [
    ([0, 0, 0], 0, 0.5), ([1, 2, 0, 1], 4, 0.5), ([1, 2, 0, 1], 4, 0.99),
    ([0, 0, 0, 3], 3, 0.9), ([5, 0, 0, 0], 5, 1.0)])
def test_bucket_quantile_equals_jax(counts, n, q):
    b = (1.0, 10.0, 100.0)
    assert metrics.bucket_quantile(b, counts, n, q) == \
        jax_metrics.bucket_quantile(b, counts, n, q)


def test_program_build_counter():
    before = metrics.program_builds().series()
    metrics.count_program_build("cuda_graph")
    metrics.count_program_build("kernel_library")
    after = metrics.program_builds().series()
    for kind in metrics.PROGRAM_BUILD_KINDS:
        key = (("kind", kind),)
        assert after[key] == before.get(key, 0.0) + 1
    with pytest.raises(ValueError):
        metrics.count_program_build("xla")
    text = metrics.render_prometheus(metrics.default_registry())
    assert "# TYPE mpgcn_cuda_program_builds_total counter" in text


# --- the SLO engine ------------------------------------------------------------


def _slo_specs(kind_module):
    return [
        kind_module.SLOSpec(name="p99", kind="latency_p99",
                            metric="serve_request_latency_ms",
                            objective=100.0, windows_s=(60.0, 600.0),
                            burn_threshold=2.0, per_label="tenant"),
        kind_module.SLOSpec(name="shed", kind="bad_ratio",
                            metric="serve_requests", objective=0.05,
                            bad_prefixes=("shed-",),
                            windows_s=(60.0, 600.0), burn_threshold=2.0),
        kind_module.SLOSpec(name="retrace", kind="rate",
                            metric="compiles", objective=0.0,
                            windows_s=(60.0, 600.0), burn_threshold=1.0),
        kind_module.SLOSpec(name="floor", kind="gauge_min",
                            metric="steps", objective=2.0),
        kind_module.SLOSpec(name="absent", kind="rate",
                            metric="no_such_metric", objective=1.0),
    ]


def _slo_run(m, s, out_dir):
    """A scripted series: healthy, a latency burn on tenant b, a shed
    storm, one retrace after the baseline; reports after each tick."""
    reg = m.MetricsRegistry()
    h = reg.histogram("serve_request_latency_ms",
                      buckets=(10.0, 100.0, 1000.0))
    c = reg.counter("serve_requests")
    comp = reg.counter("compiles")
    g = reg.gauge("steps")
    t = [0.0]
    eng = s.SLOEngine(_slo_specs(s), [reg], clock=lambda: t[0],
                      min_tick_interval_s=0.0, output_dir=out_dir,
                      postmortem_after=2)
    comp.inc(7)
    g.set(5.0)
    reports = [eng.tick()]
    for minute in range(14):
        for _ in range(20):
            h.labels(tenant="a").observe(5.0)
            h.labels(tenant="b").observe(800.0 if minute > 3 else 5.0)
            h.observe(5.0)
        c.labels(outcome="ok").inc(8 if minute > 8 else 39)
        c.labels(outcome="shed-queue-full").inc(12 if minute > 8 else 1)
        if minute == 6:
            comp.inc()
            g.set(1.0)
        t[0] += 60
        reports.append(eng.tick())
    reports.append(eng.report(refresh=False))
    return reports, reg.snapshot(), eng._postmortems


def test_slo_reports_equal_jax(tmp_path):
    ours, ours_snap, ours_pm = _slo_run(metrics, slo, str(tmp_path / "a"))
    ref, ref_snap, ref_pm = _slo_run(jax_metrics, jax_slo,
                                     str(tmp_path / "b"))
    assert ours == ref
    assert ours_snap == ref_snap
    assert ours_pm == ref_pm > 0
    assert os.path.exists(flight.flight_path(str(tmp_path / "a")))
    states = {e["name"]: e["state"] for e in ours[-1]["slos"]}
    assert states["p99"] == "burning" and states["shed"] == "burning"
    assert ours[-1]["slos"][0]["tenants"]["a"]["state"] == "ok"


def test_default_slos_match_jax_but_the_retrace_metric():
    for plane in (None, "serve", "train"):
        ours = port_config.default_slos(plane)
        ref = jax_config.default_slos(plane)
        assert [s["name"] for s in ours] == [s["name"] for s in ref]
        for a, b in zip(ours, ref):
            if a["name"] == "retrace_rate":
                assert (a["metric"], b["metric"]) == \
                    ("cuda_program_builds", "jax_compiles")
                a = {k: v for k, v in a.items()
                     if k not in ("metric", "description")}
                b = {k: v for k, v in b.items()
                     if k not in ("metric", "description")}
            elif a["name"] == "train_steps_per_sec":
                a, b = dict(a, description=""), dict(b, description="")
            assert a == b


def test_slo_engine_never_raises():
    eng = slo.SLOEngine(_slo_specs(slo), [metrics.MetricsRegistry()],
                        min_tick_interval_s=0.0)
    eng._find = lambda name: 1 / 0
    rep = eng.tick()
    assert rep["slos"] == [] and "ZeroDivisionError" in rep["error"]


# --- spans and JSONL -----------------------------------------------------------


def _spans(t_mod, out):
    slog = t_mod.SpanLog(t_mod.spans_path(out))
    with slog.span("day", trace="t0", day=3):
        with slog.span("retrain") as mid:
            mid["attrs"]["promoted"] = True
            with slog.span("promote"):
                pass
    with pytest.raises(RuntimeError):
        with slog.span("doomed", trace="t0"):
            raise RuntimeError("boom")
    slog.emit_many([dict(name="serve.request", trace="t0", span="r1",
                         t0=5.0, dur_ms=3.0, outcome="ok"),
                    dict(name="serve.batcher", trace="t0", span="b1",
                         parent="r1", t0=5.0, dur_ms=1.0, batch=1),
                    dict(name="serve.model", trace="t0", parent="b1",
                         t0=5.001, dur_ms=2.0, bucket=1)])
    rows = t_mod.read_spans(t_mod.spans_path(out), trace="t0")
    # ids and clocks differ run to run: rename them by first appearance
    ids, canon = {}, []
    for r in sorted(rows, key=lambda r: r["name"]):
        ids.setdefault(r["span"], f"s{len(ids)}")
    for r in rows:
        r = dict(r)
        r["span"] = ids.get(r["span"])
        r["parent"] = ids.get(r["parent"], r["parent"])
        r["t0"] = 5.0 if r["name"].startswith("serve") else 0.0
        r["dur_ms"] = r["dur_ms"] if r["name"].startswith("serve") else 0
        r.pop("t")
        canon.append(r)
    roots = t_mod.stitch(canon)
    return canon, roots, t_mod.format_tree(roots)


def test_spans_stitch_and_format_equal_jax(tmp_path):
    ours = _spans(trace, str(tmp_path / "a"))
    ref = _spans(jax_trace, str(tmp_path / "b"))
    assert ours == ref
    assert sorted(r["name"] for r in ours[1]) == \
        ["day", "doomed", "serve.request"]
    assert "  retrain" in ours[2]
    orphan = [{"trace": "t", "span": "a", "parent": "gone", "name": "tail",
               "t0": 1.0}]
    assert trace.stitch(orphan) == jax_trace.stitch(orphan)
    assert trace.TRACE_HEADER == jax_trace.TRACE_HEADER
    trace.SpanLog(None).emit("x", trace.new_trace_id())


@pytest.mark.parametrize("tear", ["none", "live", "rotated", "both"])
def test_jsonl_rotation_and_torn_tails_read_as_jax(tmp_path, tear):
    got = {}
    for name, lg in (("port", port_logging), ("jax", jax_logging)):
        path = str(tmp_path / name / "led.jsonl")
        os.makedirs(os.path.dirname(path))
        log = lg.JsonlLogger(path, rotate_max_bytes=400)
        for i in range(12):
            log.log("row", i=i, pad="x" * 40)
        log.log_many([("row", {"i": 12}), ("other", {"i": 13})])
        assert os.path.exists(lg.rotated_path(path))
        if tear in ("rotated", "both"):
            with open(lg.rotated_path(path), "rb+") as f:
                f.seek(0, os.SEEK_END)
                f.truncate(f.tell() - 25)
        if tear in ("live", "both"):
            with open(path, "ab") as f:
                f.write(b'{"event": "row", "i": 99')
        got[name] = [
            [{k: v for k, v in r.items() if k != "t"}
             for r in lg.read_events(path, ev, rotated=rot)]
            for ev in ("row", None) for rot in (False, True)]
        got[name].append(sorted(os.listdir(os.path.dirname(path))))
    assert got["port"] == got["jax"]
    ids = [r["i"] for r in got["port"][1]]
    assert ids == sorted(ids)


def test_jsonl_rotation_concurrent_writers(tmp_path):
    path = str(tmp_path / "requests.jsonl")
    cap = 4096
    log = port_logging.JsonlLogger(path, rotate_max_bytes=cap)

    def hammer(k):
        for i in range(200):
            log.log("request", k=k, i=i, outcome="ok")

    threads = [threading.Thread(target=hammer, args=(k,))
               for k in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert os.path.getsize(port_logging.rotated_path(path)) > cap // 2
    assert os.path.getsize(path) <= cap


# --- flight recorder and device sampler ----------------------------------------


def test_flight_recorder_dump_matches_jax(tmp_path):
    dumps = {}
    for name, fl in (("port", flight), ("jax", jax_flight)):
        fr = fl.FlightRecorder(capacity=4)
        for i in range(10):
            fr.record("tick", {"i": i})
        fr.add_metrics_provider("unit", lambda: {"x": 1.0})
        fr.add_metrics_provider("bad", lambda: 1 / 0)
        path = str(tmp_path / name / "deep" / "flight_recorder.json")
        assert fr.dump(path, reason="unit-test") == path
        import json

        d = json.load(open(path))
        dumps[name] = {k: d[k] for k in ("reason", "n_events", "events")}
        dumps[name]["events"] = [e["i"] for e in d["events"]]
        dumps[name]["metrics"] = {k: d["metrics"][k] for k in ("unit",)}
        dumps[name]["bad"] = "ZeroDivisionError" in \
            d["metrics"]["bad"]["error"]
        dumps[name]["default"] = "default" in d["metrics"]
        assert fr.dump("/proc/nonexistent/f.json", reason="x") is None
        assert fl.dump_to_dir(None, reason="x") is None
    assert dumps["port"] == dumps["jax"]
    log = port_logging.JsonlLogger(str(tmp_path / "run.jsonl"))
    log.log("epoch", epoch=3, loss=0.5)
    teed = [e for e in flight.RECORDER._ring if e["kind"] == "log.epoch"
            and e.get("epoch") == 3]
    assert teed and teed[-1]["loss"] == 0.5


def test_device_sampler_reads_nothing_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = metrics.MetricsRegistry()
    ds = DeviceSampler(registry=reg, interval_s=5.0)
    assert ds.sample_once() == {"devices": {}}
    assert reg.counter("device_samples").value == 1
    assert reg.counter("device_sample_errors").value == 0
    assert 'device="' not in metrics.render_prometheus(reg)
    ds.start()
    ds.stop()
    with pytest.raises(ValueError):
        DeviceSampler(interval_s=0)


# --- the serving load's checkpoint checks ---------------------------------------


def _params():
    rng = np.random.default_rng(0)
    return {"branches": [{"fc": {"w": rng.normal(size=(3, 2))
                                 .astype(np.float32),
                                 "b": np.zeros(2, np.float32)},
                          "spatial": [{"W": np.arange(4, dtype=np.float32)}]
                          }]}


def _damage(path, how):
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if how == "leaf":
        payload["params"]["branches"][0]["fc"]["w"][0, 0] += 1.0
    elif how == "extra_leaf":
        payload["params"]["branches"][0]["fc"]["z"] = np.ones(1)
    elif how == "record":
        payload["integrity"] = "garbage"
    elif how == "manifest":
        del payload["manifest"]["mesh"]
    elif how == "manifest_format":
        payload["manifest"]["format"] = 99
    elif how == "torn":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:200])
        return
    with open(path, "wb") as f:
        pickle.dump(payload, f)


@pytest.mark.parametrize("how", ["none", "leaf", "extra_leaf", "record",
                                 "manifest", "manifest_format", "torn"])
def test_serving_load_verifies_as_jax_does(tmp_path, how):
    path = str(tmp_path / "c.pkl")
    jax_save_checkpoint(path, _params(), 1, extra={"num_branches": 1})
    if how != "none":
        _damage(path, how)
    try:
        ref = jax_load_serving(path, num_branches=1)
    except JaxCorrupt:
        with pytest.raises(CheckpointCorruptError):
            load_serving_params(path, num_branches=1)
        return
    ours = load_serving_params(path, num_branches=1)
    np.testing.assert_array_equal(
        ours["params"]["branches"][0]["fc"]["w"],
        ref["params"]["branches"][0]["fc"]["w"])
    with pytest.raises(ValueError, match="num_branches"):
        load_serving_params(path, num_branches=2)


def test_poisoned_checkpoint_is_well_formed_for_both_loaders(tmp_path):
    for poison in (poison_checkpoint, jax_poison_ckpt):
        path = str(tmp_path / f"{poison.__module__}.pkl")
        jax_save_checkpoint(path, _params(), 1, extra={"num_branches": 1})
        poison(path)
        for load in (load_serving_params, jax_load_serving):
            w = load(path, num_branches=1)["params"]["branches"][0]["fc"]
            assert np.isnan(w["w"]).all() and np.isnan(w["b"]).all()


# --- small serving helpers -------------------------------------------------------


def test_serving_helpers_equal_jax():
    for i in (0, 7, 12345):
        assert day_filename(i) == jax_day_filename(i)
    for name in ("day_00012.npy", "day_1.npy", "x.npy", "day_00012.npz"):
        assert parse_day_index(name) == jax_parse_day(name)
    for args in ((49, 7, 1, 3, 4), (30, 5, 1, 3, 2), (14, 5, 1, 1, 2)):
        assert window_split_ratio(*args) == jax_split(*args)
    with pytest.raises(ValueError):
        window_split_ratio(10, 7, 1, 3, 4)
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(5, 4, 4, 1))).astype(np.float32)
    assert capture_row_fields(x, 3) == jax_capture(x, 3)
    assert capture_row_fields(x[..., 0], None) == jax_capture(x, None) == {}
    for mode in ("nan", "structure", "negative"):
        for a in (x, x[..., 0]):
            np.testing.assert_array_equal(
                poison_request(a, mode=mode),
                jax_poison_request(a, mode=mode))
    assert batcher.SHED_OUTCOMES == jax_batcher.SHED_OUTCOMES


def test_serve_config_matches_jax(tmp_path):
    import dataclasses

    ours, ref = ServeConfig(), JaxServeConfig()
    for f in dataclasses.fields(ServeConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(ServeConfig)} == \
        {f.name for f in dataclasses.fields(JaxServeConfig)}
    for kw in ({"buckets": (4, 2)}, {"buckets": ()}, {"max_queue": 0},
               {"canary_fraction": 0.0}, {"canary_fraction": 1.5},
               {"reload_tolerance": -1}, {"deadline_ms": -1},
               {"canary_requests": -1}, {"reload_poll_secs": -1},
               {"ledger_max_bytes": -1}, {"horizons": (3, 1)}):
        with pytest.raises(ValueError):
            JaxServeConfig(output_dir=str(tmp_path), **kw)
        with pytest.raises(ValueError):
            ServeConfig(output_dir=str(tmp_path), **kw)


# --- the double-buffered feed (stub batchers of both packages) -----------------


PACKAGES = {"port": batcher, "jax": jax_batcher}


def _stub_batcher(mod, run_batch=None, double_buffer=True, stage_fn=None,
                  buckets=(1, 2, 4), max_queue=256, max_wait_ms=1.0):
    calls = []

    def default_run(x, keys, bucket, n_live):
        calls.append(np.asarray(keys)[:n_live].tolist())
        time.sleep(0.002)  # staging runs ahead of execution
        return np.asarray(keys, np.float32)[:, None], False

    b = mod.MicroBatcher(run_batch or default_run, buckets, max_queue,
                         max_wait_ms, double_buffer=double_buffer,
                         stage_fn=stage_fn)
    b.start()
    return b, calls


@pytest.mark.parametrize("pkg", PACKAGES)
def test_double_buffer_no_reorder_no_drops(pkg):
    mod = PACKAGES[pkg]
    b, calls = _stub_batcher(mod)
    tickets = [b.submit(mod.Ticket(np.zeros((2, 2)), i))
               for i in range(200)]
    for t in tickets:
        assert t.wait(30), "ticket never resolved"
    assert b.drain(timeout=30)
    assert all(t.outcome == mod.OK for t in tickets)
    for i, t in enumerate(tickets):
        assert float(np.asarray(t.pred)[0]) == float(i)
    flat = [k for batch in calls for k in batch]
    assert flat == sorted(flat) == list(range(200))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_double_buffer_drains_clean_mid_burst(pkg):
    mod = PACKAGES[pkg]
    b, _ = _stub_batcher(mod, max_wait_ms=5.0)
    tickets = [b.submit(mod.Ticket(np.zeros((2, 2)), i)) for i in range(64)]
    assert b.drain(timeout=30)
    for t in tickets:
        assert t.wait(5), "drain dropped a request"
    assert sum(t.ok for t in tickets) == 64


@pytest.mark.parametrize("pkg", PACKAGES)
def test_double_buffer_stop_resolves_everything(pkg):
    mod = PACKAGES[pkg]

    def slow_run(x, keys, bucket, n_live):
        time.sleep(0.05)
        return np.asarray(keys, np.float32)[:, None], False

    b, _ = _stub_batcher(mod, run_batch=slow_run)
    tickets = [b.submit(mod.Ticket(np.zeros((2, 2)), i)) for i in range(32)]
    time.sleep(0.02)
    b.stop()
    for t in tickets:
        assert t.wait(10), "stop() left a ticket unresolved"
        assert t.outcome in (mod.OK, mod.REJECT_DRAINING)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_double_buffer_staged_deadline_sheds_at_execute(pkg):
    mod = PACKAGES[pkg]

    def slow_run(x, keys, bucket, n_live):
        time.sleep(0.25)
        return np.asarray(keys, np.float32)[:, None], False

    b, _ = _stub_batcher(mod, run_batch=slow_run, buckets=(1, 2),
                         max_wait_ms=0.0)
    first = b.submit(mod.Ticket(np.zeros((2, 2)), 0))
    time.sleep(0.03)
    late = [b.submit(mod.Ticket(np.zeros((2, 2)), i, deadline_s=0.05))
            for i in range(1, 5)]
    assert first.wait(10) and first.outcome == mod.OK
    for t in late:
        assert t.wait(10)
    assert any(t.outcome == mod.SHED_DEADLINE for t in late)
    b.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_double_buffer_stage_fn_runs_on_stager(pkg):
    mod = PACKAGES[pkg]
    seen, threads = [], set()

    def run(x, keys, bucket, n_live):
        seen.append(bool(getattr(x, "_staged", False)))
        return np.asarray(keys, np.float32)[:, None], False

    class Tagged(np.ndarray):
        pass

    def stage(x, keys):
        threads.add(threading.current_thread().name)
        t = x.view(Tagged)
        t._staged = True
        return t, keys

    b, _ = _stub_batcher(mod, run_batch=run, stage_fn=stage)
    ts = [b.submit(mod.Ticket(np.zeros((2, 2)), i)) for i in range(8)]
    for t in ts:
        assert t.wait(10)
    b.stop()
    assert seen and all(seen)
    assert len(threads) == 1 and "stager" in threads.pop()


def test_double_buffer_uploads_only_once_the_handoff_is_free():
    """The port's stager uploads batch k+2 only after batch k finished,
    so a ring of two staging buffers is never refilled under a batch
    that reads it."""
    active, overlap, lock = set(), [], threading.Lock()
    ring = {"next": 0}

    def stage(x, keys):
        with lock:
            slot = ring["next"]
            ring["next"] = 1 - slot
            overlap.append(slot in active)
        return (x, slot), keys

    def run(x, keys, bucket, n_live):
        arr, slot = x
        with lock:
            active.add(slot)
        time.sleep(0.003)
        with lock:
            active.discard(slot)
        return np.asarray(keys, np.float32)[:, None], False

    b, _ = _stub_batcher(batcher, run_batch=run, stage_fn=stage,
                         buckets=(1,), max_wait_ms=0.0)
    ts = [b.submit(batcher.Ticket(np.zeros((2, 2)), i)) for i in range(60)]
    for t in ts:
        assert t.wait(30) and t.ok
    b.stop()
    assert len(overlap) == 60 and not any(overlap)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_a_failed_upload_is_a_typed_error_and_the_worker_lives(
        double_buffer):
    calls = {"n": 0}

    def stage(x, keys):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("upload failed")
        return x, keys

    b, _ = _stub_batcher(batcher, stage_fn=stage, buckets=(1,),
                         double_buffer=double_buffer, max_wait_ms=0.0)
    first = b.submit(batcher.Ticket(np.zeros((2, 2)), 0))
    assert first.wait(10) and first.outcome == batcher.ERROR_INTERNAL
    assert "upload failed" in first.error
    second = b.submit(batcher.Ticket(np.zeros((2, 2)), 1))
    assert second.wait(10) and second.ok
    b.stop()


def test_batcher_accepts_preds_alone_and_typed_tickets():
    b = batcher.MicroBatcher(lambda x, k, bucket, n: x[:, :1] * 0 + 1,
                             (1, 2), max_queue=4)
    t = b.submit(batcher.Ticket(np.zeros((3, 2)), 0))
    b.start()
    assert t.wait(10) and t.ok and t.canary is False
    assert t.queue_ms is not None and t.model_ms is not None
    assert t.batch_seq == 1
    b.stop()
    # the fleet's two wall fields included (service/fleet.py)
    assert set(batcher.Ticket.__slots__) == set(jax_batcher.Ticket.__slots__)
    assert math.isfinite(t.latency_ms)
