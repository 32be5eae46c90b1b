"""The port's self-tuning dispatch (mpgcn_tpu_torch/tune/) against the JAX
package's (mpgcn_tpu/tune/), on the CPU:

  (a) the table: the nine constants' names, defaults and kinds, and
      ``coerce`` accepting and rejecting the same values;
  (b) the resolution order explicit > tuned > default and its one-time
      log, as tests/test_tune.py pins them for the JAX registry;
  (c) the forgiving reader: corrupt, cross-platform and bad-value files
      behave alike, and the port's ``torch-*`` profiles and the JAX
      profiles never cross-apply;
  (d) the planner: ``coalesce``, ``pad_waste``, ``plan_buckets`` and
      ``replay_compare`` equal to the JAX planner's on seeded traces
      (Poisson arrivals with mixed horizons, bursts, a serve ledger);
      ``tune buckets --write`` plans the same set; ``tune show`` and
      ``tune buckets`` import neither torch nor JAX;
  (e) the dispatch sites: with no profile a 2-epoch train is bit-equal
      to one with every knob pinned; a profile moves ``-bdgcn auto`` and
      ``-od-storage auto`` where it moves the JAX trainer (the port
      takes 'ell' where the JAX code takes 'csr'), an explicit flag
      wins; serve's buckets and horizons follow a profile, its flags
      win;
  (f) the epoch harnesses on the CPU, and ``tune run`` refusing without
      a card unless ``--device cpu``.

Size: N <= 47, hidden 8, one or two epochs.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu.tune import cli as jax_tune_cli
from mpgcn_tpu.tune import planner as jax_planner
from mpgcn_tpu.tune import registry as jax_R
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import apply_density, load_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.service import serve
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.tune import cli as tune_cli
from mpgcn_tpu_torch.tune import measure, planner
from mpgcn_tpu_torch.tune import registry as R
from mpgcn_tpu_torch.utils.logging import read_events

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's six constants it reads, on the CPU and the card
PORT_READ = ("sparse_density_threshold", "sparse_min_nodes",
             "epoch_scan_max_mb", "stream_chunk_mb", "serve_buckets",
             "serve_horizons")


@pytest.fixture()
def tuned_dir(tmp_path, monkeypatch):
    """One isolated profile directory for both packages, and both
    registries' caches and one-time state cleared."""
    d = tmp_path / "tuned"
    monkeypatch.setenv("MPGCN_TUNED_DIR", str(d))
    R._reset_cache()
    jax_R._reset_cache()
    yield str(d)
    R._reset_cache()
    jax_R._reset_cache()


# --- (a) the table ---------------------------------------------------------


def test_table_matches_jax():
    ours = [(c.name, c.default, c.kind, c.harness) for c in R.CONSTANTS]
    ref = [(c.name, c.default, c.kind, c.harness) for c in jax_R.CONSTANTS]
    assert ours == ref and len(ours) == 9
    assert R.CONFIG_KNOBS == jax_R.CONFIG_KNOBS
    assert R.PROFILE_VERSION == jax_R.PROFILE_VERSION
    for c in R.CONSTANTS:
        want = ("cpu", "cuda") if c.name in PORT_READ else ("tpu",)
        assert c.platforms == want, c.name


def test_defaults_equal_the_owning_fields():
    cfg = MPGCNConfig()
    for name in R.CONFIG_KNOBS:
        assert getattr(cfg, name) == R.guessed_default(name), name
    fields = ServeConfig.__dataclass_fields__
    assert fields["buckets"].default == R.guessed_default("serve_buckets")
    assert fields["horizons"].default == R.guessed_default("serve_horizons")
    assert cfg.explicit_knobs == ()


COERCE_CASES = [
    ("sparse_density_threshold", 0.03),
    ("sparse_density_threshold", "0.5"),
    ("sparse_density_threshold", 1),
    ("sparse_density_threshold", float("nan")),
    ("sparse_density_threshold", "NaN"),
    ("sparse_density_threshold", float("inf")),
    ("sparse_density_threshold", None),
    ("sparse_min_nodes", 128),
    ("sparse_min_nodes", 128.0),
    ("sparse_min_nodes", 128.5),
    ("sparse_min_nodes", True),
    ("sparse_min_nodes", "128"),
    ("epoch_scan_max_mb", -3),
    ("stream_chunk_mb", 0),
    ("serve_buckets", (1, 3, 7)),
    ("serve_buckets", [2, 4]),
    ("serve_buckets", (4, 2, 1)),
    ("serve_buckets", (1, 1, 2)),
    ("serve_buckets", (0, 1)),
    ("serve_buckets", ()),
    ("serve_buckets", 4),
    ("serve_horizons", (1, 7)),
    ("serve_horizons", ("1", "3")),
    ("pallas_vmem_tile_budget", 2 ** 23),
]


def _coerced(spec, value):
    try:
        return "ok", spec.coerce(value)
    except (TypeError, ValueError) as e:
        return "raises", type(e).__name__


@pytest.mark.parametrize("name,value", COERCE_CASES,
                         ids=[f"{n}-{v!r}" for n, v in COERCE_CASES])
def test_coerce_accepts_and_rejects_as_jax(name, value):
    ours = _coerced(R.REGISTRY[name], value)
    ref = _coerced(jax_R.REGISTRY[name], value)
    assert ours == ref


def test_platform_names():
    assert R.current_platform("cuda") == "torch-cuda"
    assert R.current_platform("CPU") == "torch-cpu"
    assert R.current_platform("torch-cuda") == "torch-cuda"
    with pytest.raises(ValueError):
        R.current_platform("tpu")
    assert R.device_platform(torch.device("cpu")) == "torch-cpu"
    assert R.device_platform("cuda:1") == "torch-cuda"
    # torch is imported here and sees no card
    assert R.current_platform() == "torch-cpu"
    assert os.path.basename(R.profile_path("cuda")) == "torch-cuda.json"


# --- (b) the resolution order ----------------------------------------------


def _order_scenario(reg, plat):
    """tests/test_tune.py's resolution-order steps on one registry:
    (results, log lines with the directory cut)."""
    name = "sparse_density_threshold"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = [reg.resolve(name, platform=plat),
               reg.resolve(name, platform=plat)]
        reg.save_profile({name: 0.03}, platform=plat)
        res += [reg.resolve(name, platform=plat),
                reg.resolve(name, explicit=0.4, platform=plat),
                reg.resolve(name, platform=plat)]
    lines = [ln.split(" (")[0] + " (" + ln.split(" (")[1].split(" ")[0]
             for ln in out.getvalue().splitlines()]
    return res, lines


def test_resolution_order_and_one_time_log(tuned_dir):
    ours = _order_scenario(R, "cpu")
    ref = _order_scenario(jax_R, "cpu")
    assert ours == ref
    assert ours[0] == [(0.25, "default"), (0.25, "default"),
                       (0.03, "tuned"), (0.4, "explicit"), (0.03, "tuned")]
    assert ours[1] == ["[tune] sparse_density_threshold = 0.25 (guessed",
                       "[tune] sparse_density_threshold = 0.03 (tuned",
                       "[tune] sparse_density_threshold = 0.4 (explicit"]


@pytest.mark.parametrize("kw,want", [
    ({}, 0.03),
    ({"sparse_density_threshold": 0.4}, 0.4),
    ({"explicit_knobs": ("sparse_density_threshold",)}, 0.25),
])
def test_resolve_knob_explicitness(tuned_dir, kw, want):
    R.save_profile({"sparse_density_threshold": 0.03}, platform="cpu")
    jax_R.save_profile({"sparse_density_threshold": 0.03}, platform="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        ours = R.resolve_knob(MPGCNConfig(**kw), "sparse_density_threshold",
                              platform="cpu")
        ref = jax_R.resolve_knob(JaxConfig(**kw), "sparse_density_threshold",
                                 platform="cpu")
    assert ours == ref == want


def test_explicit_knobs_validated_and_round_trip():
    with pytest.raises(ValueError, match="explicit_knobs"):
        MPGCNConfig(explicit_knobs=("not_a_knob",))
    with pytest.raises(ValueError, match="explicit_knobs"):
        MPGCNConfig(explicit_knobs=("serve_buckets",))
    knobs = ("sparse_min_nodes", "stream_chunk_mb")
    ours = MPGCNConfig(explicit_knobs=list(knobs))
    assert ours.explicit_knobs == knobs
    back = JaxConfig.from_dict(dataclasses.asdict(ours))
    assert back.explicit_knobs == knobs
    again = MPGCNConfig.from_dict(dataclasses.asdict(back))
    assert again.explicit_knobs == knobs


def test_cli_records_passed_tunable_flags():
    """A tunable flag passed at its default value is explicit; one not
    passed is not (mpgcn_tpu/cli.py:452-461)."""
    def explicit(argv):
        args = cli.build_parser().parse_args(argv).__dict__
        return cli.config_from_args(args).explicit_knobs

    assert explicit([]) == ()
    assert explicit(["-sparse-threshold", "0.25",
                     "-stream-chunk-mb", "0"]) == (
        "sparse_density_threshold", "stream_chunk_mb")
    assert explicit(["-sparse-min-nodes", "256"]) == ("sparse_min_nodes",)


# --- (c) the forgiving reader ----------------------------------------------


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _read_case(reg, case):
    """One broken-profile case on one registry: (results, warnings)."""
    path = reg.profile_path("cpu")
    if case == "corrupt":
        _write(path, "{not json")
    elif case == "malformed":
        _write(path, json.dumps({"version": 1, "platform": "x"}))
    elif case == "cross_platform":
        _write(path, json.dumps({"version": 1, "platform": "tpu",
                                 "constants": {"sparse_density_threshold":
                                               {"value": 0.01}}}))
    else:
        reg.save_profile({"sparse_min_nodes": 128}, platform="cpu")
        with open(path) as f:
            doc = json.load(f)
        doc["constants"]["sparse_density_threshold"] = {"value": "NaN"}
        doc["constants"]["made_up_constant"] = {"value": 3}
        _write(path, json.dumps(doc))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        res = [reg.resolve("sparse_min_nodes", platform="cpu"),
               reg.resolve("sparse_density_threshold", platform="cpu")]
    warn = sorted(k for k in ("corrupt tuned profile", "malformed tuned",
                              "never cross-apply", "bad value",
                              "unknown constant") if k in err.getvalue())
    return res, warn, err.getvalue().count("[tune] WARNING")


@pytest.mark.parametrize("case", ["corrupt", "malformed", "cross_platform",
                                  "bad_values"])
def test_forgiving_reader_as_jax(tuned_dir, case):
    assert _read_case(R, case) == _read_case(jax_R, case)


def test_strict_writer_as_jax(tuned_dir):
    for reg in (R, jax_R):
        with pytest.raises(KeyError):
            reg.save_profile({"made_up_constant": 3}, platform="cpu")
        with pytest.raises(ValueError):
            reg.save_profile({"serve_buckets": (4, 2, 1)}, platform="cpu")


def test_profiles_never_cross_apply(tuned_dir):
    """A JAX cpu.json beside the port's torch-cpu.json: each program reads
    its own; the other's copied under its name is refused."""
    jax_R.save_profile({"sparse_min_nodes": 64}, platform="cpu")
    R.save_profile({"sparse_min_nodes": 100}, platform="cpu")
    assert sorted(os.listdir(tuned_dir)) == ["cpu.json", "torch-cpu.json"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert R.resolve("sparse_min_nodes", platform="cpu") == (100, "tuned")
        assert jax_R.resolve("sparse_min_nodes", platform="cpu") \
            == (64, "tuned")
    with open(os.path.join(tuned_dir, "cpu.json")) as f:
        jax_doc = f.read()
    with open(os.path.join(tuned_dir, "torch-cpu.json")) as f:
        port_doc = f.read()
    assert json.loads(port_doc)["platform"] == "torch-cpu"
    # swapped: each file now records the other program's platform
    _write(os.path.join(tuned_dir, "torch-cpu.json"), jax_doc)
    _write(os.path.join(tuned_dir, "cpu.json"), port_doc)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert R.resolve("sparse_min_nodes", platform="cpu") \
            == (256, "default")
        assert jax_R.resolve("sparse_min_nodes", platform="cpu") \
            == (256, "default")
    assert err.getvalue().count("never cross-apply") == 2


# --- (d) the planner -------------------------------------------------------


def _trace(kind: str, seed: int) -> list:
    """Seeded (t, horizon) arrivals: Poisson with mixed horizons, or
    Poisson with bursts."""
    rng = np.random.default_rng(seed)
    n = 400
    t = np.cumsum(rng.exponential(0.004, n))
    if kind == "bursts":
        at = rng.choice(n, 12, replace=False)
        extra = np.concatenate([t[i] + rng.uniform(0, 0.003, rng.integers(
            3, 14)) for i in at])
        t = np.sort(np.concatenate([t, extra]))
        h = np.full(len(t), 7)
    else:
        h = rng.choice([1, 3, 7], len(t), p=[0.2, 0.3, 0.5])
    return [(float(a), int(b)) for a, b in zip(np.round(t, 6), h)]


def _ledger(path, seed: int) -> None:
    """A serve request ledger in the port's row format (service/serve.py
    ``_resolve``): serve_start, requests, shed ones among them, a
    malformed line, a reload row, serve_stop."""
    rng = np.random.default_rng(seed)
    rows = [{"event": "serve_start", "t": 0.0, "buckets": [1, 2, 4, 8],
             "horizons": [7]}]
    t = 0.0
    for i in range(300):
        t += float(rng.exponential(0.003))
        rows.append({"event": "request", "t": round(t, 3),
                     "outcome": "ok" if i % 17 else "shed-queue-full",
                     "latency_ms": 2.5, "bucket": 4, "canary": False,
                     "horizon": 7 if i % 5 else None, "trace": f"{i:08x}"})
    rows.append({"event": "reload", "t": t})
    rows.append({"event": "serve_stop", "t": t + 1, "drained": True})
    with open(path, "w") as f:
        for i, r in enumerate(rows):
            f.write(json.dumps(r) + "\n")
            if i == 40:
                f.write("{half a row\n")


TRACES = [("poisson", 0), ("poisson", 1), ("bursts", 2), ("bursts", 3)]


@pytest.mark.parametrize("kind,seed", TRACES)
def test_planner_equals_jax_on_seeded_traces(kind, seed):
    arr = _trace(kind, seed)
    for wait in (0.002, 0.005):
        for cap in (4, 8, 1 << 30):
            assert planner.coalesce(arr, wait, cap) \
                == jax_planner.coalesce(arr, wait, cap)
        sizes = [n for n, _ in planner.coalesce(arr, wait, 1 << 30)]
        for k in (1, 2, 3, 4):
            plan = planner.plan_buckets(sizes, k)
            assert plan == jax_planner.plan_buckets(sizes, k)
            assert planner.pad_waste(sizes, plan) \
                == jax_planner.pad_waste(sizes, plan)
        for default in ((1, 2, 4, 8), (1, 8)):
            for budget in (None, 3, 6):
                assert planner.replay_compare(arr, default, budget, wait) \
                    == jax_planner.replay_compare(arr, default, budget, wait)


def test_planner_reads_the_serve_ledger_as_jax(tmp_path):
    path = str(tmp_path / "requests.jsonl")
    _ledger(path, 4)
    arr = planner.load_requests(path)
    assert arr == jax_planner.load_requests(path) and len(arr) == 300
    assert {h for _, h in arr} == {0, 7}
    assert planner.replay_compare(arr, (1, 2, 4, 8)) \
        == jax_planner.replay_compare(arr, (1, 2, 4, 8))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 20), min_size=1, max_size=60),
       st.integers(1, 5))
def test_plan_buckets_equals_jax(sizes, k):
    plan = planner.plan_buckets(sizes, k)
    assert plan == jax_planner.plan_buckets(sizes, k)
    assert plan[-1] == max(sizes) and len(plan) <= k
    assert planner.pad_waste(sizes, plan) == jax_planner.pad_waste(sizes,
                                                                    plan)


def test_tune_buckets_write_plans_the_jax_set(tuned_dir, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    with open(path, "w") as f:
        for t, h in _trace("poisson", 5):
            f.write(json.dumps({"t": t, "horizon": h}) + "\n")
    argv = ["buckets", "--trace", path, "--platform", "cpu", "--write",
            "--max-compiles", "6"]
    outs = []
    for main in (tune_cli.main, jax_tune_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        outs.append(json.loads(buf.getvalue().split("\n[tune] wrote")[0]))
    assert outs[0] == outs[1]
    ours, ref = R.load_profile("cpu"), jax_R.load_profile("cpu")
    assert ours["platform"] == "torch-cpu" and ref["platform"] == "cpu"
    assert ours["constants"] == ref["constants"]
    assert ours["constants"]["serve_horizons"] == (1, 3, 7)
    assert "bucket_planner" in ours["provenance"]
    with contextlib.redirect_stdout(io.StringIO()):
        got = ours["constants"]["serve_buckets"]
        assert R.tuned_or_default("serve_buckets", platform="cpu") == got
        assert R.tuned_or_default("serve_buckets", explicit=(1, 2),
                                  platform="cpu") == (1, 2)


def test_tune_show_lists_nine_rows(tuned_dir, capsys):
    assert tune_cli.main(["show", "--platform", "cuda"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines()
            if ln.split(" ")[0] in R.REGISTRY]
    assert len(rows) == 9
    assert "torch-cuda.json" in out and "guessed defaults active" in out


def test_show_and_buckets_import_neither_torch_nor_jax(tmp_path):
    trace = str(tmp_path / "trace.jsonl")
    with open(trace, "w") as f:
        for t, h in _trace("bursts", 6):
            f.write(json.dumps({"t": t, "horizon": h}) + "\n")
    code = ("import sys, contextlib, io\n"
            "from mpgcn_tpu_torch import cli\n"
            "for argv in (['tune', 'show'],\n"
            "             ['tune', 'show', '--platform', 'cuda'],\n"
            "             ['tune', 'buckets', '--trace', sys.argv[1],\n"
            "              '--write', '--tuned-dir', sys.argv[2]],\n"
            "             ['tune', 'show', '--tuned-dir', sys.argv[2]]):\n"
            "    try:\n"
            "        with contextlib.redirect_stdout(io.StringIO()):\n"
            "            cli.main(argv)\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (argv, e.code)\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, trace,
                          str(tmp_path / "tuned")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.stdout.split() == ["False", "False"], out.stderr[-2000:]
    # without torch the default platform is the CPU's
    assert os.listdir(tmp_path / "tuned") == ["torch-cpu.json"]


# --- (e) the dispatch sites ------------------------------------------------


def test_no_profile_train_is_bitwise_the_pinned_one(tmp_path):
    """With no profile, every knob resolves to its config value: a
    2-epoch train at N=47 is bit-equal to one with every knob pinned."""
    assert not os.path.isdir(os.environ["MPGCN_TUNED_DIR"])

    def run(tag, **kw):
        cfg = MPGCNConfig(
            mode="train", data="synthetic", synthetic_N=47, synthetic_T=40,
            pred_len=1, hidden_dim=8, num_epochs=2, seed=0,
            native_host="off", output_dir=str(tmp_path / tag), **kw)
        data, di = load_dataset(cfg)
        t = ModelTrainer(cfg.replace(num_nodes=47), data, device="cpu",
                         data_container=di)
        assert t.bdgcn_impl == "kernel"
        assert t._epoch_exec("train") == "scan"
        assert t.pipeline.od_storage == "dense"
        assert t._chunk_budget_mb() == 512.0
        hist = t.train()
        return hist, [p.detach().clone() for p in t.model.parameters()]

    resolved = run("resolved")
    pinned = run("pinned", explicit_knobs=R.CONFIG_KNOBS)
    assert resolved[0]["train"] == pinned[0]["train"]
    for a, b in zip(resolved[1], pinned[1]):
        assert torch.equal(a, b)


def _banded(N=24, density=0.4):
    cfg = MPGCNConfig(data="synthetic", synthetic_N=N, synthetic_T=40,
                      hidden_dim=8, pred_len=1, native_host="off")
    data, _ = load_dataset(cfg)
    apply_density(data, density)
    return cfg.replace(num_nodes=N), data


@pytest.fixture(scope="module")
def banded():
    return _banded()


def _port_side(cfg, data):
    with contextlib.redirect_stdout(io.StringIO()):
        p = DataPipeline(cfg, data, "cpu")
    return p.bdgcn_impl, p.od_storage, p.support_density


def _jax_side(cfg_kw, data, out):
    jc = JaxConfig(data="synthetic", synthetic_N=24, synthetic_T=40,
                   hidden_dim=8, pred_len=1, num_nodes=24,
                   output_dir=out, **cfg_kw)
    with contextlib.redirect_stdout(io.StringIO()):
        jt = JaxTrainer(jc, data)
    return jt._bdgcn_impl, jt.pipeline.od_storage, jt._support_density


@pytest.mark.parametrize("threshold,sparse", [(0.5, True), (0.3, False)])
def test_profile_moves_auto_where_it_moves_jax(tuned_dir, banded, tmp_path,
                                               threshold, sparse):
    cfg, data = banded
    values = {"sparse_min_nodes": 16, "sparse_density_threshold": threshold}
    R.save_profile(values, platform="cpu")
    jax_R.save_profile(values, platform="cpu")
    impl, storage, density = _port_side(cfg, data)
    j_impl, j_storage, j_density = _jax_side({}, data, str(tmp_path))
    assert math.isclose(density, j_density, rel_tol=1e-6)
    assert 0.3 < density < 0.5
    assert (impl, storage) == (("ell", "sparse") if sparse
                               else ("kernel", "dense"))
    assert (j_impl, j_storage) == (("csr", "sparse") if sparse
                                   else ("einsum", "dense"))


def test_explicit_flag_beats_the_profile(tuned_dir, banded, tmp_path):
    cfg, data = banded
    values = {"sparse_min_nodes": 16, "sparse_density_threshold": 0.5}
    R.save_profile(values, platform="cpu")
    jax_R.save_profile(values, platform="cpu")
    args = cli.build_parser().parse_args(
        ["-sparse-threshold", "0.25", "-sN", "24", "-sT", "40", "-hidden",
         "8"]).__dict__
    flagged = cli.config_from_args(args).replace(
        pred_len=1, num_nodes=24, data="synthetic", native_host="off")
    assert flagged.explicit_knobs == ("sparse_density_threshold",)
    assert _port_side(flagged, data)[:2] == ("kernel", "dense")
    assert _jax_side({"explicit_knobs": ("sparse_density_threshold",)},
                     data, str(tmp_path))[:2] == ("einsum", "dense")
    # the profile still moves the knob the flag left alone: at 0.5 the
    # port's resolution above takes the sparse side without the flag
    assert _port_side(cfg, data)[:2] == ("ell", "sparse")


def test_profile_moves_the_epoch_executor(tuned_dir):
    cfg = MPGCNConfig(data="synthetic", synthetic_N=8, synthetic_T=60,
                      hidden_dim=8, pred_len=1, native_host="off")
    data, _ = load_dataset(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        t = ModelTrainer(cfg.replace(num_nodes=8), data, device="cpu")
    mb = t._mode_bytes("train")
    R.save_profile({"epoch_scan_max_mb": mb / 2, "stream_chunk_mb": mb / 4},
                   platform="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t._epoch_exec("train") == "stream"
        assert t._chunk_budget_mb() == mb / 4
        line = t._exec_line({"train": "stream"})
    assert f"(epoch_scan_max_mb={mb / 2}, chunk budget {mb / 4} MB)" in line
    assert "(tuned profile" in buf.getvalue()
    pinned = dataclasses.replace(t.cfg, explicit_knobs=R.CONFIG_KNOBS)
    t.cfg = pinned
    with contextlib.redirect_stdout(io.StringIO()):
        assert t._epoch_exec("train") == "scan"
        assert t._chunk_budget_mb() == 512.0


SERVE_ARGV = ["--device", "cpu", "--allow-fresh-init", "-sN", "8", "-sT",
              "60", "-hidden", "8", "--serve-secs", "0.2"]


def _serve_start(out, extra):
    with contextlib.redirect_stdout(io.StringIO()):
        assert serve.main(["-out", out, *SERVE_ARGV, *extra]) == 0
    return next(r for r in read_events(serve.requests_ledger_path(out))
                if r["event"] == "serve_start")


@pytest.mark.parametrize("extra,buckets,horizons", [
    ([], [1, 3], [1, 2]),
    (["--buckets", "2,4"], [2, 4], [1, 2]),
    (["--horizons", ""], [1, 3], [1]),  # -pred's default only
], ids=["profile", "buckets-flag", "empty-horizons-flag"])
def test_serve_takes_the_profile_and_its_flags_win(tuned_dir, tmp_path,
                                                   extra, buckets, horizons):
    R.save_profile({"serve_buckets": (1, 3), "serve_horizons": (1, 2)},
                   platform="cpu")
    start = _serve_start(str(tmp_path / "svc"), extra)
    assert start["buckets"] == buckets
    assert start["horizons"] == horizons


# --- (f) the harnesses ------------------------------------------------------


def test_epoch_harnesses_on_the_cpu():
    grid = (0.05, 0.25)
    out = measure.measure_stream_chunk(chunks_mb=grid, epochs=1, reps=1,
                                       device="cpu")
    assert out["value"] in grid
    assert [sorted(p) for p in out["curve"]] == [
        ["chunk_mb", "steps_per_sec"]] * 2
    assert all(p["steps_per_sec"] > 0 for p in out["curve"])
    out = measure.measure_scan_stream_crossover(epochs=1, reps=1,
                                                device="cpu")
    assert [p["path"] for p in out["curve"]] == ["scan", "stream"]
    assert sorted(out) == ["curve", "footprint_mb", "value"]
    # the guessed budget confirmed, or one below this shape's footprint
    assert out["value"] == 512.0 or out["value"] <= out["footprint_mb"]


def test_skipped_harness_writes_nothing(tuned_dir, capsys):
    rc = tune_cli.main(["run", "--device", "cpu", "--harnesses",
                        "lstm_bwd_crossover"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[tune] lstm_bwd_crossover: SKIPPED" in out
    assert "no profile written" in out
    assert not os.path.exists(tuned_dir)
    assert tune_cli.main(["run", "--device", "cpu", "--harnesses",
                          "nope"]) == 2


def test_tune_run_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        cli.main(["tune", "run", "--harnesses", "stream_chunk"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        measure.run_harnesses(["stream_chunk"])
