"""The port's HTTP front and serve command against the JAX package's: the
same bodies through both fronts give the same status codes and outcome
fields, the trace header is echoed, /metrics carries the serving
families; the serve parser has the JAX serve flags less the named ones
plus ``--device``; and ``python -m mpgcn_tpu_torch.cli serve --device
cpu`` serves, sheds a flood with typed outcomes, and drains on SIGTERM
with exit 0 and a postmortem.

Size: N=8, hidden 8, T=60, buckets (1, 2, 4), horizon 1."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.service import promote as jax_promote
from mpgcn_tpu.service import serve as jax_serve
from mpgcn_tpu.service.config import ServeConfig as JaxServeConfig
from mpgcn_tpu.train import ModelTrainer
from mpgcn_tpu.train.checkpoint import save_checkpoint
from mpgcn_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.obs.trace import TRACE_HEADER
from mpgcn_tpu_torch.service import promote, serve
from mpgcn_tpu_torch.service.batcher import OK, SHED_OUTCOMES
from mpgcn_tpu_torch.utils.logging import JsonlLogger, read_events

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, OBS = 8, 8, 7
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, obs_len=OBS,
          pred_len=1, batch_size=4, seed=0)


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """Both engines from one JAX-written checkpoint promoted into each
    one's slot, each behind its own HTTP front on 127.0.0.1."""
    out = tmp_path_factory.mktemp("torch_http")
    cfg = MPGCNConfig(**KW)
    data = synthetic_dataset(cfg)
    jcfg = JaxConfig(mode="test", data="synthetic", **KW).replace(
        num_nodes=N)
    ckpt = str(out / "MPGCN_od.pkl")
    save_checkpoint(ckpt, ModelTrainer(jcfg, data).params, 0,
                    extra={"num_branches": 2,
                           "branch_sources": ["static", "dynamic"]})
    made = {}
    for name, mod, prom, log, scls, c, kw in (
            ("port", serve, promote, JsonlLogger, ServeConfig, cfg,
             {"device": "cpu"}),
            ("jax", jax_serve, jax_promote, JaxJsonlLogger, JaxServeConfig,
             jcfg, {})):
        svc = str(out / name)
        slot = prom.promoted_path(svc)
        prom.promote_checkpoint(ckpt, slot)
        path = prom.ledger_path(svc)
        log(path).log("gate", attempt=1, promoted=True,
                      candidate_hash=prom.candidate_hash(slot))
        eng = mod.ServeEngine(c, data, scls(output_dir=svc,
                                            buckets=(1, 2, 4)), **kw)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

        httpd = _Server(("127.0.0.1", 0), mod._make_handler(eng))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        made[name] = (eng, httpd, f"http://127.0.0.1:"
                                  f"{httpd.server_address[1]}", svc)
    from mpgcn_tpu_torch.data.pipeline import DataPipeline

    md = DataPipeline(cfg, data, "cpu").modes["test"]
    yield made, np.array(md.x), np.asarray(md.keys)
    for eng, httpd, _, _ in made.values():
        httpd.shutdown()
        httpd.server_close()
        eng.close()


def _call(base, path, body=None, headers=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _bodies(x, key):
    xs = x[..., 0].tolist()
    nan_x = np.array(x[..., 0])
    nan_x[0, 0, 0] = np.nan
    return {
        "ok": {"x": xs, "key": key},
        "ok_4d": {"x": x.tolist(), "key": key, "deadline_ms": "30000"},
        "ok_day_slot": {"x": xs, "key": key, "day_slot": 3,
                        "deadline_ms": 30000},
        "nan_window": {"x": nan_x.tolist(), "key": key},
        "negative": {"x": (-np.abs(x[..., 0])).tolist(), "key": key},
        "wrong_shape": {"x": xs[:-1], "key": key},
        "bad_key": {"x": xs, "key": 9},
        "no_x": {"key": key},
        "tenant": {"x": xs, "key": key, "tenant": "acme"},
        "tenant_not_str": {"x": xs, "key": key, "tenant": 3},
        "horizon_bool": {"x": xs, "key": key, "horizon": True},
        "horizon_unserved": {"x": xs, "key": key, "horizon": 5},
        "horizon_float": {"x": xs, "key": key, "horizon": 1.5},
        "day_slot_negative": {"x": xs, "key": key, "day_slot": -1},
        "deadline_words": {"x": xs, "key": key, "deadline_ms": "soon"},
        "deadline_nan": {"x": xs, "key": key, "deadline_ms": float("nan")},
        "deadline_negative": {"x": xs, "key": key, "deadline_ms": -5.0},
    }


def _shape(status, body):
    """What must agree across the fronts: the status, the payload's keys
    and its typed fields (not latencies, traces or numbers)."""
    p = json.loads(body)
    return (status, sorted(p), p.get("ok"), p.get("outcome"),
            p.get("bucket"), p.get("canary"), p.get("horizon"),
            p.get("tenant"))


def test_predict_bodies_answer_as_the_jax_front(fronts):
    made, x, keys = fronts
    for name, body in _bodies(x[0], int(keys[0])).items():
        got = {}
        for pkg, (_, _, base, _) in made.items():
            status, _, raw = _call(base, "/v1/predict", body)
            got[pkg] = _shape(status, raw)
            if pkg == "port" and got[pkg][0] == 200:
                pred = np.asarray(json.loads(raw)["pred"])
        assert got["port"] == got["jax"], name
        if name.startswith("ok"):
            assert got["port"][0] == 200 and got["port"][3] == OK
            assert pred.shape == (1, N, N, 1)
    for pkg, (_, _, base, _) in made.items():
        # not JSON, an unknown path, an unknown GET
        assert _call(base, "/v1/predict", raw=b"{nope")[0] == 400, pkg
        assert _call(base, "/v2/predict", {"x": 1})[0] == 404, pkg
        assert _call(base, "/nope")[0] == 404, pkg


def test_oversized_body_is_a_typed_413(fronts):
    made, _, _ = fronts
    got = {}
    for pkg, (_, httpd, _, _) in made.items():
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=30)
        conn.putrequest("POST", "/v1/predict")
        conn.putheader("Content-Length", str((64 << 20) + 1))
        conn.endheaders()
        resp = conn.getresponse()
        got[pkg] = (resp.status, json.loads(resp.read())["outcome"])
        conn.close()
    assert got["port"] == got["jax"] == (413, "rejected-invalid")


def _span_chain(svc: str, trace: str, n: int = 3,
                deadline_s: float = 10.0) -> list:
    """The sorted span names of ``trace`` once ``n`` of them are in the
    span log: a ticket resolves (and the answer leaves) before its
    resolve hook appends the chain, in either package, so the test waits
    for the rows under a deadline instead of reading once."""
    path = os.path.join(svc, "obs", "spans.jsonl")
    end = time.monotonic() + deadline_s
    while True:
        rows = read_events(path, "span") if os.path.exists(path) else []
        chain = sorted(r["name"] for r in rows if r["trace"] == trace)
        if len(chain) >= n or time.monotonic() > end:
            return chain
        time.sleep(0.02)


def test_trace_header_echoed_and_healthz(fronts):
    made, x, keys = fronts
    got = {}
    for pkg, (eng, _, base, svc) in made.items():
        status, headers, raw = _call(
            base, "/v1/predict", {"x": x[1, ..., 0].tolist(),
                                  "key": int(keys[1])},
            headers={TRACE_HEADER: f"cafe{pkg}"})
        p = json.loads(raw)
        assert headers[TRACE_HEADER] == p["trace"] == f"cafe{pkg}"
        status_h, _, health = _call(base, "/healthz")
        h = json.loads(health)
        assert h["incumbent"] == eng.incumbent_hash
        chain = _span_chain(svc, f"cafe{pkg}")
        got[pkg] = (status, status_h, h["status"], h["canary"], chain)
    assert got["port"] == got["jax"]
    assert got["port"][-1] == ["serve.batcher", "serve.model",
                               "serve.request"]


def test_metrics_and_stats_surfaces(fronts):
    made, x, keys = fronts
    for pkg, (_, _, base, _) in made.items():
        _call(base, "/v1/predict", {"x": x[2, ..., 0].tolist(),
                                    "key": int(keys[2])})
    texts, stats = {}, {}
    for pkg, (_, _, base, _) in made.items():
        status, headers, raw = _call(base, "/metrics")
        assert status == 200 and "version=0.0.4" in headers["Content-Type"]
        texts[pkg] = raw.decode()
        stats[pkg] = json.loads(_call(base, "/v1/stats")[2])
    for text in texts.values():
        assert "mpgcn_serve_traces 3" in text
        assert 'mpgcn_serve_requests_total{outcome="ok"}' in text
        for fam in ("mpgcn_slo_state", "mpgcn_slo_burn_rate",
                    "mpgcn_serve_request_latency_ms_bucket",
                    "mpgcn_serve_reloads_total", "mpgcn_serve_batches"):
            assert fam in text, fam

    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}

    # the engines' own registries carry the same families; the process
    # default differs (the JAX engine's trainer registers train series)
    ours, ref = (families(serve.render_prometheus(made[p][0].registry))
                 for p in ("port", "jax"))
    assert ours == ref
    assert "mpgcn_cuda_program_builds_total" in families(texts["port"])
    assert set(stats["jax"]) <= set(stats["port"])
    assert stats["port"]["traces"] == stats["jax"]["traces"] == 3
    assert [s["name"] for s in stats["port"]["slo"]["slos"]] == \
        [s["name"] for s in stats["jax"]["slo"]["slos"]]


# --- the command --------------------------------------------------------------


MISSING = {"--mesh-rungs"}


def _flags(parser):
    return {o for a in parser._actions for o in a.option_strings}


def test_serve_parser_has_the_jax_flags_but_the_named_ones():
    ours, ref = _flags(serve.build_parser()), _flags(
        jax_serve.build_parser())
    assert ref - ours == MISSING
    assert ours - ref == {"--device"}
    for flag in sorted(ref & ours - {"-h", "--help", "--bdgcn-impl"}):
        a, b = (next(x for x in p._actions if flag in x.option_strings)
                for p in (serve.build_parser(), jax_serve.build_parser()))
        for attr in ("dest", "default", "choices", "nargs", "type"):
            assert getattr(a, attr) == getattr(b, attr), (flag, attr)
    ns = serve.build_parser().parse_args(
        ["-out", "/tmp/x", "--buckets", "1,2", "--max-queue", "4",
         "--canary-requests", "3", "-faults", "flood_qps=5", "-resume"])
    assert ns.device == "cuda" and ns.max_queue == 4


def test_serve_command_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        serve.main(["-out", str(tmp_path), "--allow-fresh-init"])
    assert not os.path.exists(serve.http_info_path(str(tmp_path)))


def test_serve_command_drains_on_sigterm(tmp_path):
    out = str(tmp_path / "svc")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("MPGCN_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve", "--device",
         "cpu", "-out", out, "--allow-fresh-init", "-sN", str(N), "-sT",
         "60", "-hidden", str(H), "--buckets", "1,2,4", "--max-queue", "8",
         "-faults", "flood_qps=60", "--reload-poll-secs", "0.2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        info_path = serve.http_info_path(out)
        t0 = time.time()
        while not os.path.exists(info_path):
            assert proc.poll() is None, proc.communicate()
            assert time.time() - t0 < 120, "the server never came up"
            time.sleep(0.1)
        with open(info_path) as f:
            info = json.load(f)
        base = f"http://{info['host']}:{info['port']}"
        x = np.ones((OBS, N, N), np.float32)
        outcomes = []
        for i in range(6):
            status, _, raw = _call(base, "/v1/predict",
                                   {"x": x.tolist(), "key": i % 7})
            outcomes.append((status, json.loads(raw)["outcome"]))
        assert all(o == OK or o in SHED_OUTCOMES for _, o in outcomes)
        assert (200, OK) in outcomes
        text = _call(base, "/metrics")[2].decode()
        assert "mpgcn_serve_requests_total" in text
        assert "mpgcn_slo_state" in text
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    assert "drained (clean)" in stdout
    assert "SIGTERM received" in stderr
    assert os.path.exists(os.path.join(out, "serve",
                                       "flight_recorder.json"))
    rows = read_events(serve.requests_ledger_path(out))
    assert rows[0]["event"] == "serve_start"
    assert rows[-1]["event"] == "serve_stop" and rows[-1]["drained"]
    flood = [r for r in rows if r["event"] == "request"]
    assert len(flood) >= 60
    assert {r["outcome"] for r in flood} <= {OK} | set(SHED_OUTCOMES)
