"""The port's continual-learning daemon and its pieces (service/daemon.py,
ingest.py, drift.py, capture.py, config.py ``DaemonConfig``; the retry
hook, the pipeline's gather cover and ``ModelTrainer.warm_start``)
against the JAX package's, on the CPU, on seeded numpy inputs:

  (a) ``DayProfile`` / ``RobustProfile`` state and the ``classify_day`` /
      ``validate_day`` verdicts over normal, shock, structure-poison,
      invalid, held and regime-shift days (drawn with hypothesis);
  (b) ``DriftDetector`` step for step on drawn operation sequences;
  (c) ``TrafficCapture`` over one rotating ledger: the same emitted days,
      bit-equal day files and the same watermark state through rotation,
      a torn tail, late and malformed rows and a relaunch;
  (d) ``read_with_retry`` with ``io_errors``, the npz loader's reads, and
      a stream-staging gather that names its day file;
  (e) ``warm_start``: the checkpoint's weights, zero moments, fresh
      counters, the state tensors in place, as the JAX ``warm_start``;
  (f) ``DaemonConfig`` refusals with the JAX messages; the parsers equal
      but for the flags of paths the port lacks;
  (g) the in-process daemon on the JAX test's spool (tests/test_daemon.py
      ``_daemon_args``: N=6, hidden 8, 2 epochs, lr 1e-2), each scratch
      retrain from the JAX init: the same ingest and quarantine rows,
      retrain attempts, reasons and windows, gate verdicts, and losses to
      rtol 1e-4; the bad_day, poison_eval and --no-gate scenarios and
      the move / state-save reconcile as in JAX.
"""

import dataclasses
import json
import math
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mpgcn_tpu.scenarios.profiles as jax_profiles
from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.loader import DataInput as JaxDataInput
from mpgcn_tpu.data.loader import synthetic_od as jax_synthetic_od
from mpgcn_tpu.nn.mpgcn import init_mpgcn
from mpgcn_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from mpgcn_tpu.resilience.retry import read_with_retry as jax_read_with_retry
from mpgcn_tpu.scenarios.dynamics import regime_shift_od
from mpgcn_tpu.service import capture as jax_capture
from mpgcn_tpu.service import daemon as jax_daemon
from mpgcn_tpu.service import drift as jax_drift
from mpgcn_tpu.service import ingest as jax_ingest
from mpgcn_tpu.service.config import DaemonConfig as JaxDaemonConfig
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu_torch.config import DaemonConfig, MPGCNConfig
from mpgcn_tpu_torch.data import loader
from mpgcn_tpu_torch.data.loader import DataInput, synthetic_od
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.scenarios.dynamics import (
    event_shock,
    poison_day,
    write_od_spool,
)
from mpgcn_tpu_torch.service import capture, daemon, drift, ingest
from mpgcn_tpu_torch.service.daemon import ContinualDaemon
from mpgcn_tpu_torch.service.promote import candidate_hash, promoted_path
from mpgcn_tpu_torch.train.checkpoint import load_checkpoint
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax
from mpgcn_tpu_torch.utils.logging import JsonlLogger, read_events
from mpgcn_tpu_torch.utils.retry import read_with_retry

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N = 6
#: the daemon runs' losses: the same f32 arithmetic in another order
LOSS_RTOL = 1e-4


# --- (a) the day gate ---------------------------------------------------------


def _profiles(maxlen=64):
    return (jax_ingest.RobustProfile(maxlen=maxlen),
            ingest.RobustProfile(maxlen=maxlen),
            jax_ingest.DayProfile(), ingest.DayProfile())


def _same_profiles(jr, pr, jd, pd):
    assert pr.state() == jr.state()
    assert pd.state() == jd.state()
    if jr.pattern is None:
        assert pr.pattern is None
    else:
        assert np.array_equal(pr.pattern, jr.pattern)


def _judge(days, n, profiles, **kw):
    """Each day through both packages' classify_day and validate_day;
    accepted days are folded into both profiles. Returns the kinds."""
    jr, pr, jd, pd = profiles
    kinds = []
    for day in days:
        vj = jax_ingest.classify_day(day, n, jr, **kw)
        vp = ingest.classify_day(day, n, pr, **kw)
        assert vp == vj
        assert (ingest.validate_day(day, n, pd)
                == jax_ingest.validate_day(day, n, jd))
        kinds.append(vj["kind"])
        if vj["ok"]:
            lt = math.log1p(vj["total_flow"])
            for prof in (jr, pr):
                prof.observe(lt, day)
            for prof in (jd, pd):
                prof.observe(lt)
        _same_profiles(*profiles)
    return kinds


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(3, 8),
       history=st.integers(0, 9), scale=st.floats(20.0, 80.0),
       case=st.sampled_from(["shock", "poison", "nan", "negative",
                             "empty", "shape", "normal"]))
def test_day_gate_matches_jax(seed, n, history, scale, case):
    """Held (a spike before the pattern arms), shock, structure poison,
    invalid and normal days: the same verdicts and profile states."""
    od = synthetic_od(history + 2, n, seed=seed)
    assert np.array_equal(od, jax_synthetic_od(history + 2, n, seed=seed))
    rng = np.random.default_rng(seed)
    last = od[-1]
    bad = {"shock": last * scale,
           "poison": poison_day(last, rng, mode="structure", scale=scale),
           "nan": poison_day(last, rng, mode="nan"),
           "negative": poison_day(last, rng, mode="negative"),
           "empty": np.zeros_like(last),
           "shape": np.ones((n, n + 1)),
           "normal": last}[case]
    profiles = _profiles(maxlen=8)
    kinds = _judge(list(od[:-1]) + [bad], n, profiles, min_history=3)
    if case == "shock" and history + 1 < 3:
        assert kinds[-1] in (ingest.KIND_NORMAL, ingest.KIND_HELD)
    # the state round trip
    jr, pr = profiles[:2]
    back = ingest.RobustProfile.from_state(json.loads(json.dumps(
        pr.state())))
    assert back.state() == jax_ingest.RobustProfile.from_state(
        json.loads(json.dumps(jr.state()))).state()


def test_held_day_reclassified_and_regime_shift_as_jax():
    """A shock before the pattern arms is held, then an event shock once
    it arms (the JAX golden), and a regime shift's days stay normal."""
    od = synthetic_od(20, N, seed=5)
    profiles = _profiles()
    for d in od[:8]:  # totals only: the pattern never arms
        lt = math.log1p(float(d.sum()))
        for prof in profiles[:2]:
            prof.observe(lt)
    shock = od[8] * 40.0
    assert _judge([shock], N, profiles) == [ingest.KIND_HELD]
    # the held day is not folded in; fresh days re-arm the pattern
    assert _judge(list(od[9:20]), N, profiles) == [ingest.KIND_NORMAL] * 11
    assert _judge([shock], N, profiles) == [ingest.KIND_SHOCK]

    pr = jax_profiles.get_profile("taxi-midtown").replace(num_nodes=12)
    shifted = regime_shift_od(pr, days=28, shift_day=14,
                              to_modality="metro")
    kinds = _judge(list(shifted), 12, _profiles())
    assert set(kinds) == {ingest.KIND_NORMAL}


def test_event_shock_and_spool_match_jax(tmp_path):
    from mpgcn_tpu.scenarios.dynamics import event_shock as jax_shock
    from mpgcn_tpu.scenarios.dynamics import write_od_spool as jax_spool

    od = synthetic_od(5, N, seed=1)
    assert np.array_equal(event_shock(od, 3, 40.0), jax_shock(od, 3, 40.0))
    adj = loader.synthetic_adjacency(N, 0)
    a = write_od_spool(od, str(tmp_path / "p"), adjacency=adj, start_day=7)
    b = jax_spool(od, str(tmp_path / "j"), adjacency=adj, start_day=7)
    assert [os.path.basename(p) for p in a] == [
        os.path.basename(p) for p in b]
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


# --- (b) drift ----------------------------------------------------------------


_OP = st.one_of(
    st.tuples(st.just("eval"), st.sampled_from(
        [0.5, 1.0, 1.05, 1.3, 2.0, float("nan"), float("inf")])),
    st.tuples(st.just("counters"), st.tuples(st.integers(0, 4),
                                             st.integers(0, 5))),
    st.tuples(st.just("reset"), st.none()),
    st.tuples(st.just("reload"), st.none()))


@settings(max_examples=40, deadline=None)
@given(window=st.integers(1, 4), threshold=st.floats(0.05, 0.5),
       skip=st.integers(0, 2), spike=st.integers(0, 3),
       ops=st.lists(_OP, max_size=30))
def test_drift_detector_matches_jax_step_for_step(window, threshold, skip,
                                                  spike, ops):
    kw = dict(skip_budget=skip, spike_budget=spike)
    dj = jax_drift.DriftDetector(window, threshold, **kw)
    dp = drift.DriftDetector(window, threshold, **kw)
    for op, arg in ops:
        for d in (dj, dp):
            if op == "eval":
                d.observe_eval(arg)
            elif op == "counters":
                d.observe_counters(skipped=arg[0], spikes=arg[1])
            elif op == "reset":
                d.reset()
        if op == "reload":
            dp = drift.DriftDetector(window, threshold, **kw)
            dp.load_state(json.loads(json.dumps(dj.state())))
        assert dp.check() == dj.check()
        assert json.dumps(dp.state()) == json.dumps(dj.state())


@pytest.mark.parametrize("args", [(0, 0.2), (3, 0.0), (2, -1.0)])
def test_drift_detector_refusals_match_jax(args):
    with pytest.raises(ValueError) as ej:
        jax_drift.DriftDetector(*args)
    with pytest.raises(ValueError) as ep:
        drift.DriftDetector(*args)
    assert str(ep.value) == str(ej.value)


# --- (c) traffic capture ------------------------------------------------------


def _row(day, val, n=4, tenant=None, outcome="ok", flows=True):
    rec = {"outcome": outcome, "day_slot": day}
    if flows:
        rec["flows"] = np.full((n, n), float(val),
                               dtype=np.float32).tolist()
    if tenant is not None:
        rec["tenant"] = tenant
    return rec


def test_capture_matches_jax_through_rotation_and_relaunch(tmp_path):
    """One ledger, rotating every ~5 rows, read by both packages'
    captures polled at the same points (at most one rotation between two
    polls, so nothing is lost): the same emitted days and watermark
    state after every poll, bit-equal day files."""
    led = str(tmp_path / "requests.jsonl")
    log = JsonlLogger(led, rotate_max_bytes=1000)

    def caps():
        return (jax_capture.TrafficCapture(
                    led, str(tmp_path / "js"), str(tmp_path / "jst"),
                    tenant="a", num_nodes=4),
                capture.TrafficCapture(
                    led, str(tmp_path / "ps"), str(tmp_path / "pst"),
                    tenant="a", num_nodes=4))

    cj, cp = caps()
    sj, sp = jax_capture.default_capture_state(), \
        capture.default_capture_state()
    assert sp == sj
    emitted = []

    def poll(flush=False):
        ej = (cj.flush if flush else cj.poll)(sj)
        ep = (cp.flush if flush else cp.poll)(sp)
        assert ep == ej and sp == sj
        assert cp.lag_days(sp) == cj.lag_days(sj)
        emitted.extend(ep)

    for day in range(8):
        for k in range(3):
            log.log("request", **_row(day, day * 10 + k, tenant="a"))
            if k != 1:
                poll()
        log.log("request", **_row(day, -1.0, tenant="b"))  # filtered
        poll()
        log.log("request", **_row(day, 3.0, tenant="a",
                                  outcome="rejected-invalid"))
    bad = _row(8, 4.0, tenant="a")
    bad["flows"] = [[1.0, 2.0]]  # not square: malformed
    log.log("request", **bad)
    with open(led, "a") as f:  # a torn tail, completed a poll later
        tail = json.dumps({"event": "request", **_row(8, 77.0, tenant="a")})
        f.write(tail[:25])
    poll()
    with open(led, "a") as f:
        f.write(tail[25:] + "\n")
    poll()
    # relaunch: the watermark through json into fresh captures
    sj, sp = json.loads(json.dumps(sj)), json.loads(json.dumps(sp))
    cj, cp = caps()
    poll()
    log.log("request", **_row(2, 5.0, tenant="a"))  # late: already out
    log.log("request", **_row(9, 9.0, tenant="a"))
    poll()
    poll(flush=True)
    assert sorted(emitted) == list(range(10))
    assert sp["late"] == 1 and sp["malformed"] == 1 and sp["gaps"] == 0
    for name in sorted(os.listdir(tmp_path / "js")):
        assert (tmp_path / "ps" / name).read_bytes() == \
            (tmp_path / "js" / name).read_bytes(), name


def test_capture_row_fields_round_trip_bit_equal():
    x = np.random.default_rng(3).normal(5, 2, (5, N, N)).astype(np.float32)
    rec = json.loads(json.dumps(capture.capture_row_fields(x[..., None], 7)))
    assert rec == json.loads(json.dumps(
        jax_capture.capture_row_fields(x, 7)))
    assert np.array_equal(np.asarray(rec["flows"], np.float32), x[-1])


# --- (d) retries --------------------------------------------------------------


@pytest.mark.parametrize("io_errors,attempts", [(2, 3), (3, 3), (0, 1)])
def test_read_with_retry_io_errors_match_jax(io_errors, attempts, capsys):
    spec = f"io_errors={io_errors}" if io_errors else ""
    out = {}
    for name, fn, plan in (
            ("jax", jax_read_with_retry, JaxFaultPlan.parse(spec)),
            ("port", read_with_retry, FaultPlan.parse(spec))):
        try:
            got = fn(lambda: "data", "/spool/day_00003.npy",
                     attempts=attempts, faults=plan, _sleep=lambda s: None)
        except IOError as e:
            got = f"raised {type(e).__name__}: {e}"
        out[name] = (got, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert ("raised" in out["port"][0]) == (io_errors >= attempts)


def test_npz_loader_reads_retry_as_jax(tmp_path, capsys):
    import scipy.sparse as ss

    n = loader.REFERENCE_N  # the npz holds the reference's 47 zones
    od = synthetic_od(40, n, seed=0)
    ss.save_npz(str(tmp_path / loader.NPZ_NAME),
                ss.csr_matrix(od.reshape(40, n * n)))
    np.save(str(tmp_path / loader.ADJ_NAME),
            loader.synthetic_adjacency(n, 0))
    kw = dict(input_dir=str(tmp_path), data="npz", faults="io_errors=2",
              io_retry_delay_s=0.0)
    jd = JaxDataInput(JaxConfig(**kw)).load_data()
    jout = capsys.readouterr().out
    pd = DataInput(MPGCNConfig(**kw)).load_data()
    pout = capsys.readouterr().out
    assert pout == jout and loader.NPZ_NAME in pout and "retry" in pout
    assert np.array_equal(pd["OD"], np.asarray(jd["OD"]))


def test_stream_gather_retries_and_names_day_file(tmp_path, capsys):
    """The JAX test (tests/test_daemon.py
    ``test_stream_chunk_gather_retry_names_day_file``) on the port: an
    injected failure on the staging thread retries, the log names the
    backing day file, the chunks equal the clean ones."""
    cfg = MPGCNConfig(output_dir=str(tmp_path), synthetic_T=40,
                      synthetic_N=N, obs_len=5, pred_len=1, batch_size=4,
                      hidden_dim=8, io_retry_delay_s=0.0)
    data = loader.synthetic_dataset(cfg)
    clean = DataPipeline(cfg, data, "cpu")
    pipe = DataPipeline(
        cfg, data, "cpu", gather_faults=FaultPlan.parse("io_errors=1"),
        gather_provenance=lambda mode, sel: (
            f"accepted/day_{int(sel[0]):05d}.npy "
            f"(+{len(sel) - 1} more windows)"))
    n = len(pipe.modes["train"])
    S = -(-n // cfg.batch_size)
    idx = np.concatenate([np.arange(n), np.full(S * cfg.batch_size - n,
                                                n - 1)])
    idx = idx.reshape(S, cfg.batch_size).astype(np.int32)
    sizes = np.full(S, cfg.batch_size, np.int32)
    got = list(pipe.stream_chunks("train", idx, sizes, 3))
    want = list(clean.epoch_chunks("train", idx, sizes, 3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.x, w.x) and np.array_equal(g.y, w.y)
    out = capsys.readouterr().out
    assert "accepted/day_00000.npy" in out and "retry" in out


# --- (e) warm start -----------------------------------------------------------


def _tiny_kw(out, **kw):
    return {**dict(mode="train", data="synthetic", output_dir=str(out),
                   obs_len=5, pred_len=1, batch_size=4, hidden_dim=8,
                   learn_rate=1e-2, num_epochs=1, io_retry_delay_s=0.0,
                   synthetic_T=40, synthetic_N=N), **kw}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warm_start_matches_jax(tmp_path, dtype):
    """A checkpoint with Adam's moments (one trained epoch) warm-starts a
    trainer of another seed: the weights are the checkpoint's, as the
    JAX warm_start loads them; the moments are zero, the counters and
    the loss scaler fresh; every state tensor stays where it was (the
    captured steps hold their addresses)."""
    cfg = MPGCNConfig(**_tiny_kw(tmp_path / "a", dtype=dtype))
    data = loader.synthetic_dataset(cfg)
    a = ModelTrainer(cfg, data, device="cpu")
    a.train()
    ckpt = os.path.join(cfg.output_dir, "MPGCN_od.pkl")
    assert a.optimizer.count > 0

    b = ModelTrainer(cfg.replace(output_dir=str(tmp_path / "b"), seed=7),
                     data, device="cpu")
    ptrs = b._state_ptrs()
    before = {k: v.clone() for k, v in b.model.state_dict().items()}
    b.warm_start(ckpt)
    assert b._state_ptrs() == ptrs
    jb = JaxTrainer(JaxConfig(**_tiny_kw(tmp_path / "j", dtype=dtype,
                                         seed=7, native_host="off")),
                    data)
    jb.warm_start(ckpt)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jb.params))
    got = b.model.state_dict()
    assert any(not torch.equal(before[k], got[k]) for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    opt = b.optimizer
    assert opt.count == 0 and int(opt.step_t) == 0
    for p in opt.all_params():
        st_ = opt.state[p]
        assert not st_["exp_avg"].any() and not st_["exp_avg_sq"].any()
        assert float(st_["step"]) == 0.0
    jmu = [np.asarray(x) for x in jax.tree_util.tree_leaves(jb.opt_state)
           if hasattr(x, "shape") and np.ndim(x) > 0]
    assert all(not m.any() for m in jmu)
    if dtype == "bfloat16":
        from mpgcn_tpu.quant.scaling import loss_scale_stats

        assert opt.scaler.stats()["scale"] == loss_scale_stats(
            jb.opt_state)["scale"] == cfg.loss_scale_init
        assert opt.scaler.stats()["skipped_steps"] == 0


# --- (f) config and parser ----------------------------------------------------


BAD_DAEMON = [dict(window_days=0), dict(drift_threshold=0.0),
              dict(promote_tolerance=-1.0), dict(retrain_init="hot"),
              dict(holdout_days=30, val_days=30, window_days=20),
              dict(poll_secs=-1.0), dict(profile_zmax=0.0),
              dict(robust_window=1), dict(shock_coherence=0.0),
              dict(shock_support_max=1.5), dict(idle_exits=-1),
              dict(spool_dir="")]


@pytest.mark.parametrize("bad", BAD_DAEMON, ids=lambda b: next(iter(b)))
def test_daemon_config_refusals_match_jax(bad):
    kw = {"spool_dir": "/spool", **bad}
    with pytest.raises(ValueError) as ej:
        JaxDaemonConfig(**kw)
    with pytest.raises(ValueError) as ep:
        DaemonConfig(**kw)
    assert str(ep.value) == str(ej.value)


def test_daemon_config_fields_match_jax():
    ours, ref = DaemonConfig(spool_dir="/s"), JaxDaemonConfig(spool_dir="/s")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.replace(window_days=19)) == \
        dataclasses.asdict(ref.replace(window_days=19))


#: the JAX daemon flags the port does not have: none (the port adds
#: --device)
MISSING_FLAGS = set()


def _flags(parser):
    return {o: a for a in parser._actions for o in a.option_strings}


def test_daemon_parser_matches_jax():
    ours = _flags(daemon.build_parser())
    ref = _flags(jax_daemon.build_parser())
    assert set(ref) - set(ours) == MISSING_FLAGS
    assert set(ours) - set(ref) == {"--device"}
    for flag in set(ours) & set(ref):
        for attr in ("dest", "default", "type", "choices", "nargs",
                     "required"):
            assert getattr(ours[flag], attr) == getattr(ref[flag], attr), \
                (flag, attr)
    ns = daemon.build_parser().parse_args(["-spool", "/s", "-resume"])
    assert ns.spool_dir == "/s" and ns.gate and ns.resume
    assert ns.device == "cuda"


def test_window_split_ratio_matches_jax():
    for args in ((30, 5, 1, 3, 4), (55, 5, 1, 3, 8), (40, 7, 1, 6, 8)):
        assert daemon.window_split_ratio(*args) == \
            jax_daemon.window_split_ratio(*args)
    with pytest.raises(ValueError):
        daemon.window_split_ratio(12, 5, 1, 3, 4)


# --- (g) the daemon -----------------------------------------------------------


def _write_days(spool, t0, t1, seed=0, corrupt=()):
    """tests/test_daemon.py ``_write_days``."""
    os.makedirs(spool, exist_ok=True)
    od = synthetic_od(t1, N, seed=seed)
    for t in range(t0, t1):
        day = od[t].copy()
        if t in corrupt:
            day[0] = np.nan
        np.save(os.path.join(spool, f"day_{t:05d}.npy"), day)
    return od


def _daemon_args(spool, out, **kw):
    """tests/test_daemon.py ``_daemon_args``."""
    base = dict(window_days=30, holdout_days=4, val_days=3,
                retrain_cadence=3, ingest_batch=28, idle_exits=2,
                poll_secs=0.05, obs=5, batch=4, hidden=8, epoch=2,
                lr="1e-2")
    base.update(kw)
    args = ["-spool", spool, "-out", out]
    for flag, key in (("--window-days", "window_days"),
                      ("--holdout-days", "holdout_days"),
                      ("--val-days", "val_days"),
                      ("--retrain-cadence", "retrain_cadence"),
                      ("--ingest-batch", "ingest_batch"),
                      ("--idle-exits", "idle_exits"),
                      ("--poll-secs", "poll_secs"),
                      ("-obs", "obs"), ("-batch", "batch"),
                      ("-hidden", "hidden"), ("-epoch", "epoch"),
                      ("-lr", "lr")):
        args += [flag, str(base[key])]
    if base.get("faults"):
        args += ["-faults", base["faults"]]
    if base.get("no_gate"):
        args += ["--no-gate"]
    return args


@pytest.fixture
def jax_init(monkeypatch):
    """Every trainer of the port's daemon starts from the JAX init of its
    config (a warm start then loads the incumbent over it)."""
    made = ContinualDaemon._trainer

    def _trainer(self, cfg, data, pipeline):
        tr = made(self, cfg, data, pipeline)
        tree = init_mpgcn(
            jax.random.PRNGKey(cfg.seed), M=cfg.num_branches,
            K=cfg.support_K, input_dim=cfg.input_dim,
            lstm_hidden_dim=cfg.hidden_dim,
            lstm_num_layers=cfg.lstm_num_layers,
            gcn_hidden_dim=cfg.hidden_dim,
            gcn_num_layers=cfg.gcn_num_layers, use_bias=cfg.use_bias)
        tr.model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree)))
        return tr

    monkeypatch.setattr(ContinualDaemon, "_trainer", _trainer)


def _strip(rows, drop=("t", "trace", "span", "file", "candidate_hash",
                       "metrics", "slot", "kept")):
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def _close(a, b, keys):
    for k in keys:
        if a[k] is None or b[k] is None:
            assert a[k] == b[k], k
        else:
            assert math.isclose(a[k], b[k], rel_tol=LOSS_RTOL), \
                (k, a[k], b[k])


@pytest.mark.daemon
def test_daemon_matches_jax_on_the_jax_spool(tmp_path, jax_init):
    """34 days with day 20 corrupt, 28 ingested in the first cycle: the
    JAX daemon and the port's (each scratch retrain from the JAX init)
    quarantine the same day with the same verdict, start the same
    retrains for the same reasons over the same windows, and gate them
    alike, losses to rtol 1e-4."""
    runs = {}
    for name, main, extra in (("jax", jax_daemon.main, []),
                              ("port", daemon.main, ["--device", "cpu"])):
        spool, out = str(tmp_path / name / "spool"), \
            str(tmp_path / name / "svc")
        _write_days(spool, 0, 34, corrupt={20})
        assert main(extra + _daemon_args(spool, out)) == 0
        runs[name] = out
    j, p = runs["jax"], runs["port"]
    for rel, event in (("quarantine/verdicts.jsonl", "quarantine"),
                       ("daemon_log.jsonl", "day_accepted"),
                       ("daemon_log.jsonl", "day_quarantined"),
                       ("daemon_log.jsonl", "retrain_start")):
        assert _strip(read_events(os.path.join(p, rel), event)) == \
            _strip(read_events(os.path.join(j, rel), event)), event
    gj = read_events(os.path.join(j, "promoted", "promotions.jsonl"), "gate")
    gp = read_events(os.path.join(p, "promoted", "promotions.jsonl"), "gate")
    assert [(g["attempt"], g["promoted"], g["verdict"], g["warm_start"],
             g["window_days"]) for g in gp] == [
        (g["attempt"], g["promoted"], g["verdict"], g["warm_start"],
         g["window_days"]) for g in gj]
    assert len(gp) == 2
    for a, b in zip(gp, gj):
        _close(a, b, ("cand_loss", "cand_rmse", "inc_loss", "inc_rmse"))
    sj = json.load(open(os.path.join(j, "daemon_state.json")))
    sp = json.load(open(os.path.join(p, "daemon_state.json")))
    for key in ("ingested", "accepted", "quarantined", "retrain_attempts",
                "retrains_done", "accepted_at_last_retrain",
                "accepted_at_last_failure", "num_nodes", "profile",
                "robust_profile", "held", "capture", "drift"):
        if key == "drift":
            assert len(sp[key]["evals"]) == len(sj[key]["evals"])
            continue
        assert sp[key] == sj[key], key
    # the promoted slot: loadable by both packages, finite
    ckpt = load_checkpoint(promoted_path(p))
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree_util.tree_leaves(ckpt["params"]))

    # the offline gap (the JAX flagship's check, tests/test_daemon.py:
    # the final promoted RMSE against an uninterrupted 6-epoch run from
    # scratch on the same clean window): recorded for both packages, held
    # against no bound, since the JAX daemon misses its own 10% here
    gaps = {}
    for name, out in runs.items():
        ids = json.load(open(os.path.join(out, "daemon_state.json")))[
            "accepted"][-30:]
        raw = np.stack([np.load(os.path.join(out, "accepted",
                                             f"day_{i:05d}.npy"))
                        for i in ids])
        kw = _tiny_kw(tmp_path / name / "offline", num_epochs=6,
                      split_ratio=daemon.window_split_ratio(
                          len(ids), 5, 1, 3, 4), num_nodes=N)
        for key in ("synthetic_T", "synthetic_N"):
            kw.pop(key)
        if name == "jax":
            from mpgcn_tpu.data.loader import preprocess_od as jax_prep
            from mpgcn_tpu.service.promote import evaluate_params as jax_eval

            cfg = JaxConfig(**kw)
            tr = JaxTrainer(cfg, jax_prep(raw, loader.synthetic_adjacency(
                N, 0), cfg))
            tr.train(("train", "validate"))
            tr.load_trained()
            off = jax_eval(tr, "test")
        else:
            from mpgcn_tpu_torch.service.promote import evaluate_params

            cfg = MPGCNConfig(**kw)
            tr = ModelTrainer(cfg, loader.preprocess_od(
                raw, loader.synthetic_adjacency(N, 0), cfg), device="cpu")
            tr.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
                np.asarray, init_mpgcn(
                    jax.random.PRNGKey(0), M=2, K=cfg.support_K,
                    input_dim=1, lstm_hidden_dim=8, lstm_num_layers=1,
                    gcn_hidden_dim=8, gcn_num_layers=3, use_bias=True))))
            tr.train()
            tr.load_trained()
            off = evaluate_params(tr, "test")
        final = [g for g in (gj if name == "jax" else gp)
                 if g["promoted"]][-1]["cand_rmse"]
        gaps[name] = abs(final - off["rmse"]) / off["rmse"]
        assert math.isfinite(gaps[name])
    print(f"[offline gap] daemon final RMSE against a 6-epoch offline run: "
          f"port {gaps['port']:.1%}, JAX {gaps['jax']:.1%}")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)
            if np.asarray(x).dtype.kind == "f"]


@pytest.mark.daemon
@pytest.mark.parametrize("scenario", ["bad_day", "poison_eval", "no_gate"])
def test_daemon_fault_scenarios_as_jax(tmp_path, scenario):
    """tests/test_daemon.py's three chaos scenarios, their assertions on
    the port: a fault-poisoned ingest day is quarantined beside the
    corrupt one; a poisoned candidate is rejected and the incumbent stays
    attempt 1's; without the gate the same poison is promoted."""
    spool, out = str(tmp_path / "spool"), str(tmp_path / "svc")
    kw = {"bad_day": dict(faults="bad_day=5"),
          "poison_eval": dict(faults="poison_eval=2"),
          "no_gate": dict(faults="poison_eval=2", no_gate=True)}[scenario]
    _write_days(spool, 0, 34, corrupt={20} if scenario == "bad_day" else ())
    assert daemon.main(["--device", "cpu"] + _daemon_args(spool, out,
                                                          **kw)) == 0
    gates = read_events(os.path.join(out, "promoted", "promotions.jsonl"),
                        "gate")
    byatt = {g["attempt"]: g for g in gates}
    state = json.load(open(os.path.join(out, "daemon_state.json")))
    if scenario == "bad_day":
        rows = read_events(os.path.join(out, "quarantine", "verdicts.jsonl"))
        assert sorted(r["day"] for r in rows) == [4, 20]
        assert any(r.get("injected_fault") == "bad_day" for r in rows)
        assert 20 not in state["accepted"] and 4 not in state["accepted"]
        promoted = [g for g in gates if g["promoted"]]
        assert len(promoted) >= 2
        for g in promoted:
            assert math.isfinite(g["cand_loss"])
            if g["inc_loss"] is not None:
                assert g["cand_loss"] <= g["inc_loss"] * (1 + g["tolerance"])
        ckpt = load_checkpoint(promoted_path(out))
        assert all(np.isfinite(x).all() for x in _leaves(ckpt["params"]))
    elif scenario == "poison_eval":
        assert byatt[1]["promoted"] and not byatt[2]["promoted"]
        assert byatt[2]["verdict"] == "candidate-eval-non-finite"
        assert candidate_hash(promoted_path(out)) == \
            byatt[1]["candidate_hash"]
        kept = os.path.join(out, "rejected", "MPGCN_candidate_a2.pkl")
        with open(kept, "rb") as f:
            assert any(np.isnan(x).any()
                       for x in _leaves(pickle.load(f)["params"]))
        assert state["accepted_at_last_failure"] == len(state["accepted"])
    else:
        assert byatt[2]["promoted"] and byatt[2]["verdict"] == \
            "gate-disabled"
        with open(promoted_path(out), "rb") as f:
            assert any(np.isnan(x).any()
                       for x in _leaves(pickle.load(f)["params"]))


def test_reconcile_matches_jax(tmp_path):
    """tests/test_daemon.py's reconcile scenario in both packages: days
    moved into accepted/ and quarantine/ after the last state save are
    folded back in, persisted, and an unreadable accepted file degrades
    to quarantine; the lists, counts and profiles agree."""
    states = {}
    for name, Daemon, Cfg, TCfg, extra in (
            ("jax", jax_daemon.ContinualDaemon, JaxDaemonConfig, JaxConfig,
             {}),
            ("port", ContinualDaemon, DaemonConfig, MPGCNConfig,
             {"device": "cpu"})):
        spool, out = str(tmp_path / name / "spool"), \
            str(tmp_path / name / "svc")
        _write_days(spool, 0, 3)
        dcfg = Cfg(spool_dir=spool, output_dir=out)
        tcfg = TCfg(**_tiny_kw(os.path.join(out, "retrain")))
        d = Daemon(dcfg, tcfg, **extra)
        assert d._ingest() == 3 and d.accepted == [0, 1, 2]
        _write_days(spool, 3, 5)
        os.replace(os.path.join(spool, "day_00003.npy"),
                   os.path.join(out, "accepted", "day_00003.npy"))
        os.replace(os.path.join(spool, "day_00004.npy"),
                   os.path.join(out, "quarantine", "day_00004.npy"))
        d2 = Daemon(dcfg, tcfg, **extra)
        d3 = Daemon(dcfg, tcfg, **extra)
        with open(os.path.join(out, "accepted", "day_00009.npy"),
                  "wb") as f:
            f.write(b"torn")
        d4 = Daemon(dcfg, tcfg, **extra)
        states[name] = [(x.accepted, x.quarantined, x.ingested,
                         x.profile.state(), x.rprofile.state())
                        for x in (d, d2, d3, d4)]
        assert d2.accepted == [0, 1, 2, 3] and d2.quarantined == [4]
        assert d3.ingested == d2.ingested
        assert 9 in d4.quarantined and 9 not in d4.accepted
    assert states["port"] == states["jax"]
