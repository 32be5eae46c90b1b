"""The port's supervisor (resilience/supervisor.py), the supervised daemon
and the trainer's fault arms on the command line, against the JAX
package's, on the CPU:

  (a) ``RESUMABLE_EXITS``, ``_output_dir`` and ``_wait`` (the generation
      timeout, the forwarded signal and the second signal's kill) as the
      JAX supervisor's; ``--procs 2`` refused, naming the multi-device
      slice; ``supervise --help`` loads neither torch nor numpy;
  (b) ``supervise --procs 1 -- daemon --device cpu ... -faults
      kill_retrain=2`` as a subprocess on the JAX flagship's spool
      (tests/test_daemon.py): the supervisor sees -9 and then [0], a
      poller integrity-loads the promoted slot throughout, day 20 is
      quarantined, attempt 2 never reaches the gate, and the final gate
      row equals that of an uninterrupted in-process run on the same
      spool (same values, bit for bit: the port's CPU runs are
      deterministic at one thread count, which the subprocess is given);
  (c) the daemon without ``--device cpu`` on a box without a card
      refuses to start;
  (d) the train command's ``-faults`` arms (nan_step, sigterm_epoch,
      ckpt_trunc and its resume, io_errors, hang_epoch -> exit 113) give
      the JAX trainer's events.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.resilience import supervisor as jax_supervisor
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.data import loader
from mpgcn_tpu_torch.data.loader import synthetic_od
from mpgcn_tpu_torch.resilience import supervisor
from mpgcn_tpu_torch.service import daemon
from mpgcn_tpu_torch.service.promote import promoted_path
from mpgcn_tpu_torch.train.checkpoint import load_checkpoint
from mpgcn_tpu_torch.utils.logging import read_events

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", **extra)
    env.pop("MPGCN_FAULTS", None)
    return env


# --- (a) the supervisor -------------------------------------------------------


def test_resumable_exits_and_output_dir_match_jax():
    assert supervisor.RESUMABLE_EXITS == jax_supervisor.RESUMABLE_EXITS \
        == {113, 114, 115}
    for args in (["daemon", "-spool", "s", "-out", "o"],
                 ["--output_dir", "x", "-epoch", "2"], ["-out"], []):
        assert supervisor._output_dir(args) == \
            jax_supervisor._output_dir(args)


def _sleeper(ignore_term=False):
    code = ("import signal, time\n"
            + ("signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
               if ignore_term else "")
            + "time.sleep(60)\n")
    return subprocess.Popen([sys.executable, "-c", code])


@pytest.mark.parametrize("mod", [supervisor, jax_supervisor],
                         ids=["port", "jax"])
def test_wait_timeout_and_second_signal(mod):
    """A generation past its timeout is killed and reported as timed out;
    a first stop signal is forwarded (a child that ignores it lives on),
    a second one kills it."""
    t0 = time.monotonic()
    rcs, timed_out = mod._wait([_sleeper()], 0.5,
                               {"sig": None, "count": 0})
    assert timed_out and rcs == [-signal.SIGKILL]
    assert time.monotonic() - t0 < 20
    flag = {"sig": signal.SIGTERM, "count": 1}
    p = _sleeper(ignore_term=True)
    time.sleep(0.5)  # the child has installed its SIG_IGN

    def second():
        time.sleep(1.5)
        assert p.poll() is None  # the forwarded SIGTERM was ignored
        flag["count"] = 2

    th = threading.Thread(target=second)
    th.start()
    rcs, timed_out = mod._wait([p], 0.0, flag)
    th.join()
    assert rcs == [-signal.SIGKILL] and not timed_out
    flag = {"sig": signal.SIGTERM, "count": 1}
    rcs, _ = mod._wait([_sleeper()], 0.0, flag)
    assert rcs == [-signal.SIGTERM]


def test_more_than_one_process_refused(capsys):
    with pytest.raises(SystemExit) as e:
        supervisor.main(["--procs", "2", "--", "-epoch", "1"])
    assert e.value.code == 2
    assert "multi-device" in capsys.readouterr().err
    # the JAX supervisor's flags but --devices-per-proc (an XLA
    # virtual-device count, for the multi-device slice)
    flags = {o for a in supervisor.build_parser()._actions
             for o in a.option_strings}
    assert flags == {"-h", "--help", "--procs", "--max-restarts",
                     "--gen-timeout"}
    with pytest.raises(SystemExit):
        supervisor.main(["--devices-per-proc", "1", "--", "-epoch", "1"])


def test_supervise_help_loads_no_torch_or_numpy():
    code = ("import sys\n"
            "from mpgcn_tpu_torch import cli\n"
            "try:\n"
            "    cli.main(['supervise', '--help'])\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- (b) the supervised daemon ------------------------------------------------


def _write_days(spool, t1, corrupt=()):
    os.makedirs(spool, exist_ok=True)
    od = synthetic_od(t1, N, seed=0)
    for t in range(t1):
        day = od[t].copy()
        if t in corrupt:
            day[0] = np.nan
        np.save(os.path.join(spool, f"day_{t:05d}.npy"), day)


def _daemon_args(spool, out, faults=""):
    """tests/test_daemon.py ``_daemon_args``, 4 epochs a retrain (the
    kill lands after the first epoch of attempt 2)."""
    args = ["daemon", "--device", "cpu", "-spool", spool, "-out", out,
            "--window-days", "30", "--holdout-days", "4", "--val-days",
            "3", "--retrain-cadence", "3", "--ingest-batch", "28",
            "--idle-exits", "2", "--poll-secs", "0.05", "-obs", "5",
            "-batch", "4", "-hidden", "8", "-epoch", "4", "-lr", "1e-2"]
    return args + (["-faults", faults] if faults else [])


#: the gate row's fields that describe the decision (attempt, trace,
#: span, time and the file's hash, whose bytes hold a timestamp, do not)
GATE_VALUES = ("promoted", "verdict", "cand_loss", "cand_rmse", "inc_loss",
               "inc_rmse", "tolerance", "warm_start", "window_days")


@pytest.mark.daemon
def test_supervised_daemon_survives_kill_mid_retrain(tmp_path):
    spool, out = str(tmp_path / "spool"), str(tmp_path / "svc")
    _write_days(spool, 34, corrupt={20})
    slot = promoted_path(out)
    failures, loads, stop = [], [0], threading.Event()

    def poll():
        while not stop.is_set():
            if os.path.exists(slot):
                try:
                    load_checkpoint(slot)
                    loads[0] += 1
                except Exception as e:  # a torn promote fails the test
                    failures.append(repr(e))
            time.sleep(0.03)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    threads = str(torch.get_num_threads())
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "mpgcn_tpu_torch.cli", "supervise",
             "--procs", "1", "--max-restarts", "3", "--"]
            + _daemon_args(spool, out, "kill_retrain=2"),
            env=_env(OMP_NUM_THREADS=threads), cwd=ROOT,
            capture_output=True, text=True, timeout=400)
    finally:
        stop.set()
        th.join(timeout=5)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert failures == [], f"promoted slot torn mid-run: {failures[:3]}"
    assert loads[0] > 0
    gens = read_events(os.path.join(out, "supervisor",
                                    "supervisor_log.jsonl"),
                       "generation_end")
    assert [g["rcs"] for g in gens] == [[-9], [0]]
    rows = read_events(os.path.join(out, "quarantine", "verdicts.jsonl"))
    assert [r["day"] for r in rows] == [20]
    state = json.load(open(os.path.join(out, "daemon_state.json")))
    assert 20 not in state["accepted"] and state["retrain_attempts"] == 3
    gates = read_events(os.path.join(out, "promoted", "promotions.jsonl"),
                        "gate")
    assert [g["attempt"] for g in gates] == [1, 3]
    for g in gates:
        if g["promoted"] and g["inc_loss"] is not None:
            assert g["cand_loss"] <= g["inc_loss"] * (1 + g["tolerance"])
    starts = read_events(os.path.join(out, "daemon_log.jsonl"),
                         "retrain_start")
    assert [s["attempt"] for s in starts] == [1, 2, 3]

    # an uninterrupted run in this process, same spool and flags: its
    # last gate row is the relaunched attempt's, value for value
    spool2, out2 = str(tmp_path / "spool2"), str(tmp_path / "svc2")
    _write_days(spool2, 34, corrupt={20})
    assert daemon.main(_daemon_args(spool2, out2)[1:]) == 0
    ref = read_events(os.path.join(out2, "promoted", "promotions.jsonl"),
                      "gate")
    assert [g["attempt"] for g in ref] == [1, 2]
    for got, want in zip(gates, ref):
        assert {k: got[k] for k in GATE_VALUES} == \
            {k: want[k] for k in GATE_VALUES}


# --- (c) the card refusal -----------------------------------------------------


def test_daemon_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the daemon would run on it")
    with pytest.raises(SystemExit) as e:
        daemon.main(["-spool", str(tmp_path / "s"), "-out",
                     str(tmp_path / "o")])
    assert "daemon:" in str(e.value) and "cuda" in str(e.value).lower()
    assert not os.path.exists(tmp_path / "o")


# --- (d) the trainer's fault arms on the command line -------------------------


SMALL = ["-data", "synthetic", "-sN", "8", "-sT", "60", "-hidden", "8",
         "-epoch", "3"]


def _run(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        assert not e.code, e.code


def _names(out):
    return [e["event"] for e in read_events(
        os.path.join(out, "MPGCN_train_log.jsonl"))]


def _npz_tree(path):
    import scipy.sparse as ss

    n = loader.REFERENCE_N
    od = synthetic_od(30, n, seed=0)
    os.makedirs(path, exist_ok=True)
    ss.save_npz(os.path.join(path, loader.NPZ_NAME),
                ss.csr_matrix(od.reshape(30, n * n)))
    np.save(os.path.join(path, loader.ADJ_NAME),
            loader.synthetic_adjacency(n, 0))


@pytest.mark.parametrize("arm", ["nan_step", "sigterm_epoch", "ckpt_trunc",
                                 "io_errors"])
def test_train_fault_arms_give_jax_events(tmp_path, arm, capsys):
    argv = {"nan_step": SMALL + ["-faults", "nan_step=3"],
            "sigterm_epoch": SMALL + ["-faults", "sigterm_epoch=2"],
            "ckpt_trunc": SMALL + ["-faults", "ckpt_trunc=2"],
            # N=47 (the npz's), hidden 4: the packages' inits differ, and
            # seed 1 is one whose first draw both find dead (one reseed)
            "io_errors": ["-data", "npz", "-in", str(tmp_path / "npz"),
                          "-hidden", "4", "-epoch", "1", "-split", "6",
                          "2", "2", "-seed", "1",
                          "-faults", "io_errors=2"]}[arm]
    if arm == "io_errors":
        _npz_tree(str(tmp_path / "npz"))
    got = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["-GPU", "cpu"])):
        out = str(tmp_path / name)
        _run(main, extra + argv + ["-out", out])
        printed = capsys.readouterr().out
        got[name] = [_names(out)]
        if arm == "ckpt_trunc":
            assert "FAULT INJECTED: truncated checkpoint" in printed
            # the torn file is the second written; resume past it
            _run(main, extra + SMALL[:-1] + ["4", "-resume", "-out", out])
            capsys.readouterr()
            got[name].append(_names(out))
        if arm == "io_errors":
            assert printed.count("WARNING: read of") == 2 \
                and loader.NPZ_NAME in printed
    assert got["port"] == got["jax"]
    if arm == "sigterm_epoch":
        assert got["port"][0][-1] == "preempted"


def test_hang_epoch_exits_113_as_jax(tmp_path):
    """hang_epoch=2 with -watchdog 10: the armed watchdog fires in the
    hung epoch, writes its event and the emergency checkpoint, and the
    process exits 113, as the JAX trainer's does. Each child runs on this
    xdist worker's share of the cores (OMP_NUM_THREADS), as the
    in-process tests do: with every core's thread in every worker's child
    at once, a loaded host's first epoch could outrun the deadline."""
    got = {}
    threads = str(torch.get_num_threads())
    for name, mod, extra in (("jax", "mpgcn_tpu.cli", []),
                             ("port", "mpgcn_tpu_torch.cli",
                              ["-GPU", "cpu"])):
        out = str(tmp_path / name)
        proc = subprocess.run(
            [sys.executable, "-m", mod] + extra + SMALL
            + ["-watchdog", "10", "-faults", "hang_epoch=2,hang_secs=120",
               "-out", out], env=_env(OMP_NUM_THREADS=threads), cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 113, proc.stdout[-2000:] + \
            proc.stderr[-2000:]
        assert os.path.exists(os.path.join(out, "MPGCN_od_emergency.pkl"))
        got[name] = _names(out)
    assert got["port"] == got["jax"]
    assert got["port"][-1] == "watchdog_timeout"
