"""The port's operator surface against the JAX package's, on the CPU:

  (a) ``MetricsServer``: /metrics, /healthz and 404 as the JAX sidecar
      answers them, port 0, and ``stop()`` releasing the port;
  (b) ``StepTimer`` step for step against the JAX one on a fake clock;
      ``trace_if`` writes a trace holding the step annotations, and no
      annotation is made without a window;
  (c) the trainer's telemetry: after one epoch the default registry holds
      the JAX trainer's families, ``cuda_program_builds`` in place of
      ``jax_compiles`` / ``jax_compile_seconds``, with equal support
      gauges, and the epoch events carry the snapshot; ``-no-obs`` leaves
      neither the series nor ``metrics`` and the same losses;
  (d) the kernel-library cache: flag > env > default, first directory
      wins, the libraries' paths under it, hits and misses with the build
      stubbed, an unusable directory refused;
  (e) ``stats`` and ``slo`` on one serve directory (a port ServeEngine,
      its HTTP front live, a train log and a fleet registry beside it)
      equal to the JAX commands' output; the ``--trace`` tree equal;
  (f) the train CLI's operator flags equal to the JAX ones, and every JAX
      subcommand dispatched but ``perf`` and ``lint``.

Size: N=8, hidden 8, T=60, one epoch.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mpgcn_tpu.obs.metrics as jax_metrics
from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.loader import load_dataset as jax_load_dataset
from mpgcn_tpu.obs import stats as jax_stats
from mpgcn_tpu.obs.perf import slo_cli as jax_slo
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu.utils import profiling as jax_profiling
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import load_dataset
from mpgcn_tpu_torch.native import build, host
from mpgcn_tpu_torch.obs import metrics, stats
from mpgcn_tpu_torch.obs.perf import compile_cache, slo_cli
from mpgcn_tpu_torch.service import serve
from mpgcn_tpu_torch.service.registry import TenantRegistry
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils import profiling
from mpgcn_tpu_torch.utils.logging import JsonlLogger, read_events

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H = 8, 8
KW = dict(data="synthetic", synthetic_N=N, synthetic_T=60, hidden_dim=H,
          num_epochs=1, pred_len=1)


@pytest.fixture
def fresh_registries(monkeypatch):
    """Empty default registries in both packages for the test."""
    monkeypatch.setattr(metrics, "_DEFAULT", None)
    monkeypatch.setattr(jax_metrics, "_DEFAULT", None)


@pytest.fixture
def fresh_cache(monkeypatch):
    """The kernel-library cache as a new process finds it."""
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", None)
    monkeypatch.setattr(compile_cache, "_COUNTERS", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)


# --- (a) the sidecar ------------------------------------------------------------


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, ""


def test_metrics_server_answers_as_jax():
    got = {}
    for pkg, mod in (("port", metrics), ("jax", jax_metrics)):
        reg = mod.MetricsRegistry()
        reg.counter("sidecar_hits").inc(4)
        reg.gauge("sidecar_depth").labels(q="a").set(2.5)
        srv = mod.MetricsServer([reg], port=0).start()
        try:
            assert srv.port > 0
            base = f"http://{srv.host}:{srv.port}"
            got[pkg] = [_fetch(base + p) for p in
                        ("/metrics", "/healthz", "/nope")]
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    page = got["port"][0]
    assert page[0] == 200 and "version=0.0.4" in page[1]
    assert "mpgcn_sidecar_hits_total 4" in page[2]
    assert json.loads(got["port"][1][2]) == {"status": "ok"}
    assert got["port"][2][0] == 404


def test_metrics_server_stop_releases_the_port():
    reg = metrics.MetricsRegistry()
    first = metrics.MetricsServer([reg], port=0).start()
    port = first.port
    first.stop()
    first.stop()  # a second stop is a no-op
    again = metrics.MetricsServer([reg], port=port).start()
    try:
        assert again.port == port
        assert _fetch(f"http://127.0.0.1:{port}/healthz")[0] == 200
    finally:
        again.stop()


# --- (b) timers and the profiler window -----------------------------------------


@pytest.mark.parametrize("warmup,ticks", [
    (1, [(10.0, 4), (12.0, 4)]), (2, [(1.0, 1), (1.5, 1), (2.5, 3)]),
    (0, [(2.0, 4), (3.0, 1)]), (3, [(5.0, 10), (6.0, 10), (6.5, 0)])])
def test_step_timer_matches_jax(monkeypatch, warmup, ticks):
    now = [0.0]
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
    timers = (profiling.StepTimer(warmup), jax_profiling.StepTimer(warmup))
    for t, n in ticks:
        now[0] = t
        for tm in timers:
            tm.tick(n)
        now[0] = t + 0.25
        a, b = timers
        assert (a.measured_steps, a.steps_per_sec) == \
            (b.measured_steps, b.steps_per_sec)
    for mod in (profiling, jax_profiling):
        with pytest.raises(ValueError):
            mod.StepTimer(warmup_steps=-1)


def _tiny_trainer(out, **kw):
    cfg = MPGCNConfig(output_dir=str(out), **{**KW, **kw})
    data, di = load_dataset(cfg)
    cfg = cfg.replace(num_nodes=data["OD"].shape[1])
    return ModelTrainer(cfg, data, device="cpu", data_container=di)


def test_trace_window_holds_the_step_annotations(tmp_path):
    tr = _tiny_trainer(tmp_path / "out", native_host="off")
    batches = list(tr.pipeline.batches("train", pad_to_full=True))[:3]
    assert not profiling._TRACE_ACTIVE
    assert isinstance(profiling.step_annotation(1),
                      contextlib.nullcontext)
    assert isinstance(profiling.kernel_annotation("x"),
                      contextlib.nullcontext)
    with profiling.trace_if(str(tmp_path / "trace"), "cpu") as prof:
        assert prof is not None and profiling._TRACE_ACTIVE
        step0 = tr.global_step
        for b in batches:
            tr.train_step(b)
        tr.eval_step(batches[0])
    assert not profiling._TRACE_ACTIVE
    tr.train_step(batches[0])  # outside the window: nothing recorded
    with profiling.trace_if(None) as none:
        assert none is None and not profiling._TRACE_ACTIVE
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    notes = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and re.match(r"(train|eval)_step#", e["name"]))
    assert notes == sorted([f"train_step#{step0 + i}" for i in range(3)]
                           + ["eval_step#1"])
    assert any(e.get("cat") == "cpu_op" for e in events)


# --- (c) the trainer's telemetry ---------------------------------------------------


def _families(reg) -> set:
    return {m.name for m in reg.metrics()}


#: the JAX compile hook's families and the port's counterpart
JAX_ONLY = {"mpgcn_jax_compiles", "mpgcn_jax_compile_seconds"}
PORT_ONLY = {"mpgcn_cuda_program_builds"}
SUPPORT_GAUGES = ("graph_support_nnz", "graph_support_density",
                  "bdgcn_sparse_active", "graph_support_pad_width",
                  "graph_support_resident_bytes", "train_loss_scale",
                  "quant_max_abs_error")


def _both_trainers(tmp_path, **kw):
    jcfg = JaxConfig(output_dir=str(tmp_path / "jax"), **{**KW, **kw})
    jdata, jdi = jax_load_dataset(jcfg)
    jt = JaxTrainer(jcfg.replace(num_nodes=N), jdata, data_container=jdi)
    jt.train(modes=("train", "validate"))
    pt = _tiny_trainer(tmp_path / "port", **kw)
    pt.train()
    return [read_events(str(tmp_path / pkg / "MPGCN_train_log.jsonl"),
                        "epoch") for pkg in ("port", "jax")]


def _snapshot_key_family(key: str) -> str:
    return re.sub(r"(_total|_count|_sum|_p50|_p99)?(\{.*\})?$", "", key)


def test_trainer_registry_families_match_jax(tmp_path, fresh_registries,
                                             fresh_cache):
    ours_ev, ref_ev = _both_trainers(tmp_path)
    ours = metrics.default_registry()
    ref = jax_metrics.default_registry()
    assert _families(ours) - PORT_ONLY == _families(ref) - JAX_ONLY
    assert PORT_ONLY <= _families(ours) and JAX_ONLY <= _families(ref)
    for name in SUPPORT_GAUGES:
        assert ours.gauge(name).value == ref.gauge(name).value, name
    assert ours.gauge("train_steps_per_sec").value > 0
    assert ours.histogram("train_epoch_seconds").count == 1
    for a, b in zip(ours_ev, ref_ev):
        fa = {_snapshot_key_family(k) for k in a["metrics"]}
        fb = {_snapshot_key_family(k) for k in b["metrics"]}
        assert fa - PORT_ONLY == fb - JAX_ONLY
        for name in SUPPORT_GAUGES:
            assert a["metrics"]["mpgcn_" + name] == \
                b["metrics"]["mpgcn_" + name], name


def test_no_obs_leaves_no_series_and_the_same_losses(tmp_path,
                                                     fresh_registries,
                                                     fresh_cache):
    with_obs = _tiny_trainer(tmp_path / "obs")
    with_obs.train()
    obs_ev = read_events(str(tmp_path / "obs" / "MPGCN_train_log.jsonl"),
                         "epoch")
    metrics._DEFAULT = None
    jax_metrics._DEFAULT = None
    port_ev, jax_ev = _both_trainers(tmp_path, obs_metrics=False)
    for reg in (metrics.default_registry(),
                jax_metrics.default_registry()):
        assert not {f for f in _families(reg)
                    if re.match(r"mpgcn_(train_|graph_|slo_|quant_|bdgcn_"
                                r"|cuda_program|jax_comp)", f)}
    assert all("metrics" not in e for e in port_ev + jax_ev)
    assert all("metrics" in e for e in obs_ev)
    assert [(e["train_loss"], e["validate_loss"]) for e in port_ev] == \
        [(e["train_loss"], e["validate_loss"]) for e in obs_ev]


# --- (d) the kernel-library cache ----------------------------------------------------


def test_cache_dir_order_and_first_wins(tmp_path, monkeypatch, fresh_cache,
                                        fresh_registries):
    a, b, env = (str(tmp_path / d) for d in ("a", "b", "env"))
    assert compile_cache.resolve_dir() == compile_cache.DEFAULT_DIR
    assert build.BUILD_DIR == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR == os.path.join(
        ROOT, "mpgcn_tpu_torch", "native", "_build")
    monkeypatch.setenv(compile_cache.ENV_VAR, env)
    assert compile_cache.resolve_dir() == env
    assert compile_cache.resolve_dir(a) == a  # the flag beats the env
    assert compile_cache.library_dir() == env  # nothing enabled yet
    assert compile_cache.enable(a) == a
    assert compile_cache.enable(b) == a  # the first directory wins
    assert compile_cache.enabled_dir() == compile_cache.library_dir() == a
    assert build._lib_path("lstm_infer").startswith(a + os.sep)
    assert host.BUILD_DIR is None and host.lib_path().startswith(a + os.sep)
    fams = _families(metrics.default_registry())
    assert {"mpgcn_kernel_cache_hits", "mpgcn_kernel_cache_misses",
            "mpgcn_kernel_cache_dir_bytes",
            "mpgcn_kernel_cache_entries"} <= fams


def test_default_dir_registers_no_series(fresh_cache, fresh_registries):
    assert compile_cache.enable() == compile_cache.DEFAULT_DIR
    assert not {f for f in _families(metrics.default_registry())
                if "kernel_cache" in f}
    assert compile_cache.cache_stats() == {
        "hits": 0, "misses": 0, "dir": compile_cache.DEFAULT_DIR}


def test_trainer_enables_its_config_dir(tmp_path, fresh_cache,
                                        fresh_registries):
    d = str(tmp_path / "kc")
    _tiny_trainer(tmp_path / "out", compile_cache_dir=d, native_host="off")
    assert compile_cache.enabled_dir() == d and os.path.isdir(d)


def test_hits_and_misses_with_the_build_stubbed(tmp_path, monkeypatch,
                                                fresh_cache,
                                                fresh_registries):
    """A fake nvcc writes the library; the first process builds it (a
    miss and a kernel_library build), a second finds it (a hit)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    d = compile_cache.enable(str(tmp_path / "kc"))
    for process in range(2):
        monkeypatch.setattr(build, "_libs", {})
        monkeypatch.setattr(build, "_built", set())
        for name in ("lstm_infer", "bdgcn_pair_fwd", "lstm_infer"):
            lib = build.load(name)
            assert lib[1].startswith(d + os.sep) and os.path.exists(lib[1])
    reg = metrics.default_registry()
    assert compile_cache.cache_stats() == {"hits": 2, "misses": 2, "dir": d}
    assert reg.counter("cuda_program_builds").labels(
        kind="kernel_library").value == 2
    assert reg.gauge("kernel_cache_entries").value == 2
    assert reg.gauge("kernel_cache_dir_bytes").value == 8


def test_unusable_cache_dir_raises(tmp_path, fresh_cache, fresh_registries):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(RuntimeError, match="cannot be used"):
        compile_cache.enable(str(blocker / "sub"))
    assert compile_cache.enabled_dir() is None
    # the command refuses before it loads any data
    with pytest.raises(RuntimeError, match="cannot be used"):
        cli.main(["-GPU", "cpu", "-data", "synthetic", "-compile-cache",
                  str(blocker / "sub"), "-out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


# --- (e) stats and slo ------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_root(tmp_path_factory):
    """A port ServeEngine's root (requests, rejections, spans) behind its
    live HTTP front, with a train log and a one-tenant fleet registry."""
    root = str(tmp_path_factory.mktemp("torch_ops_serve"))
    cfg = MPGCNConfig(mode="test", synthetic_N=N, synthetic_T=60,
                      hidden_dim=H, obs_len=7, pred_len=1, data="synthetic",
                      native_host="off", output_dir=root)
    data, _ = load_dataset(cfg)
    eng = serve.ServeEngine(cfg.replace(num_nodes=N), data,
                            ServeConfig(output_dir=root, buckets=(1, 2)),
                            device="cpu", allow_fresh=True)
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve._make_handler(eng))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    with open(serve.http_info_path(root), "w") as f:
        json.dump({"host": "127.0.0.1", "port": httpd.server_address[1],
                   "pid": os.getpid()}, f)
    rng = np.random.default_rng(0)
    for i in range(6):
        t = eng.submit(rng.random((7, N, N)).astype(np.float32), i % 7,
                       trace=f"tr{i}")
        assert t.wait(60) and t.outcome == "ok"
    bad = eng.submit(np.full((7, N, N), np.nan, np.float32), 0, trace="bad")
    assert bad.wait(60) and bad.outcome != "ok"
    eng.drain(timeout=60)
    # a train log beside the ledgers, and a fleet registry
    _tiny_trainer(root, native_host="off").train()
    TenantRegistry.load(root).add("acme", scenario="taxi-midtown",
                                  modality="taxi", city="midtown",
                                  horizon=1)
    yield root, eng
    httpd.shutdown()
    httpd.server_close()
    eng.close()


def _wait_spans(root, n):
    import time

    for _ in range(500):
        rows = read_events(os.path.join(root, "obs", "spans.jsonl"), "span")
        if len({r["trace"] for r in rows}) >= n:
            return
        time.sleep(0.02)


def test_stats_summary_equals_jax(serve_root):
    root, _ = serve_root
    _wait_spans(root, 7)
    ours, ref = stats.summarize(root), jax_stats.summarize(root)
    live_o, live_r = ours.pop("live"), ref.pop("live")
    assert ours == ref
    assert set(live_o) == set(live_r) and live_o["resolved"] == 7
    assert {"requests", "spans", "train", "federation"} <= set(ours)
    assert ours["requests"]["n"] == 7
    assert ours["train"][0]["sparse_gauges"]


def _out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_stats_and_slo_commands_offline_equal_jax(serve_root, monkeypatch):
    root, _ = serve_root
    _wait_spans(root, 7)
    for mod in (stats, jax_stats, slo_cli, jax_slo):
        monkeypatch.setattr(mod, "_scrape_live", lambda *a, **k: None)
    for argv in ([], ["--json"]):
        assert _out(stats.main, ["-out", root] + argv) == \
            _out(jax_stats.main, ["-out", root] + argv)
        assert _out(slo_cli.main, ["-out", root] + argv) == \
            _out(jax_slo.main, ["-out", root] + argv)
    assert slo_cli.evaluate_ledger(root) == jax_slo.evaluate_ledger(root)
    rc, text = _out(slo_cli.main, ["-out", root, "--json"])
    rep = json.loads(text)
    assert rep["source"] == "ledger" and rep["rows"] == 7
    assert [s["name"] for s in rep["slos"]] == ["serve_latency_p99",
                                                "serve_shed_ratio"]


def test_slo_live_equals_jax(serve_root):
    root, _ = serve_root
    runs = [json.loads(_out(m, ["-out", root, "--json"])[1])
            for m in (slo_cli.main, jax_slo.main)]
    for r in runs:
        assert r["source"] == "live"
    assert [(s["name"], s["state"]) for s in runs[0]["slos"]] == \
        [(s["name"], s["state"]) for s in runs[1]["slos"]]
    assert set(runs[0]) == set(runs[1])


def test_slo_ledger_with_tenants_equals_jax(tmp_path):
    """The offline evaluation over a fleet ledger: per-tenant burns."""
    rng = np.random.default_rng(3)
    log = JsonlLogger(os.path.join(tmp_path, "serve", "requests.jsonl"))
    outcomes = ["ok"] * 8 + ["shed-queue-full", "error-internal",
                             "rejected-invalid"]
    for i in range(300):
        log.log("request", tenant=["a", "b", None][i % 3],
                outcome=outcomes[rng.integers(len(outcomes))],
                latency_ms=float(rng.gamma(2.0, 80.0)))
    assert slo_cli.evaluate_ledger(str(tmp_path)) == \
        jax_slo.evaluate_ledger(str(tmp_path))
    assert stats.summarize(str(tmp_path)) == \
        jax_stats.summarize(str(tmp_path))


def test_stats_trace_tree_equals_jax(serve_root):
    root, _ = serve_root
    _wait_spans(root, 7)
    for argv in (["--trace", "tr3", "--json"], ["--trace", "tr3"],
                 ["--trace", "missing"]):
        assert _out(stats.main, ["-out", root] + argv) == \
            _out(jax_stats.main, ["-out", root] + argv)
    tree = json.loads(_out(stats.main, ["-out", root, "--trace", "tr3",
                                        "--json"])[1])
    names = []
    node = tree[0]
    while node:
        names.append(node["name"])
        node = node["children"][0] if node["children"] else None
    assert names == ["serve.request", "serve.batcher", "serve.model"]


# --- (f) the command line -------------------------------------------------------


OPS_FLAGS = ["-trace", "-no-obs", "-compile-cache", "-metrics-port"]


@pytest.mark.parametrize("flag", OPS_FLAGS)
def test_operator_flags_match_jax(flag):
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "const", "required", "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert type(ours) is type(ref)


def _subcommands(path) -> set:
    with open(path) as f:
        return set(re.findall(r'argv\[0\] == "(\w+)"', f.read()))


def test_every_jax_subcommand_but_three_is_dispatched():
    ours = _subcommands(os.path.join(ROOT, "mpgcn_tpu_torch", "cli.py"))
    ref = _subcommands(os.path.join(ROOT, "mpgcn_tpu", "cli.py"))
    assert ref - ours == {"perf", "lint"}
    assert ours <= ref and len(ours) == 9


@pytest.mark.parametrize("sub", ["serve", "fleet", "router", "daemon",
                                 "supervise", "stats", "slo", "scenario",
                                 "tune"])
def test_subcommand_dispatches(sub, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith("usage:")


def test_read_surfaces_import_no_torch(tmp_path):
    code = ("import sys, contextlib, io\n"
            "from mpgcn_tpu_torch import cli\n"
            "for argv in (['stats', '-out', sys.argv[1]],\n"
            "             ['slo', '-out', sys.argv[1]],\n"
            "             ['scenario', 'list'],\n"
            "             ['scenario', 'gen', '-profile', 'metro-loop',\n"
            "              '-out', sys.argv[1] + '/spool', '--days', '2']):\n"
            "    try:\n"
            "        with contextlib.redirect_stdout(io.StringIO()):\n"
            "            cli.main(argv)\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (argv, e.code)\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.stdout.split() == ["False", "False"], out.stderr[-2000:]


def test_cli_session_with_sidecar_and_trace(tmp_path, fresh_cache,
                                            fresh_registries, capsys):
    """The train command with -trace, -metrics-port 0 and -compile-cache:
    the sidecar's address printed, the trace written with the steps'
    annotations, the library directory enabled; -no-obs runs the same
    epoch to the same loss without the snapshot."""
    argv = ["-GPU", "cpu", "-data", "synthetic", "-sN", str(N), "-sT", "60",
            "-hidden", str(H), "-epoch", "1", "-native", "off"]
    cli.main(argv + ["-out", str(tmp_path / "a"), "-metrics-port", "0",
                     "-trace", str(tmp_path / "t"), "-compile-cache",
                     str(tmp_path / "kc")])
    out = capsys.readouterr().out
    assert re.search(r"\[obs\] /metrics on http://127\.0\.0\.1:\d+/metrics",
                     out)
    assert compile_cache.enabled_dir() == str(tmp_path / "kc")
    (trace,) = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / trace) as f:
        notes = {e["name"].split("#")[0] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"train_step", "eval_step"} <= notes
    cli.main(argv + ["-out", str(tmp_path / "b"), "-no-obs"])
    a, b = (read_events(str(tmp_path / d / "MPGCN_train_log.jsonl"), "epoch")
            for d in ("a", "b"))
    assert "metrics" in a[0] and "metrics" not in b[0]
    assert (a[0]["train_loss"], a[0]["validate_loss"]) == \
        (b[0]["train_loss"], b[0]["validate_loss"])
