"""The port's resume, preemption and checkpoint fallbacks against the JAX
package's, on the CPU (mirrors tests/test_trainer.py:254-340, 487-560 and
tests/test_resilience.py:195-310): the rolling ``_last`` checkpoint with
Adam's state, the shuffle replayed, SIGTERM / SIGINT at an epoch's end,
the last -> best -> scratch chain over torn files, and checkpoints
crossing packages.

Tolerances: the port resumed against the port straight, bit for bit
(epoch losses, weights, Adam's state, the step counter); the port and the
JAX trainer each resuming one JAX ``_last`` checkpoint, weights rtol 1e-5
/ atol 1e-6 after one more epoch.
"""

import os
import pickle
import shutil
import signal

import numpy as np
import pytest
import torch

from mpgcn_tpu.train.checkpoint import load_checkpoint as jax_load
from mpgcn_tpu_torch.utils.convert import read_checkpoint
from tests.torch_heal_common import (
    data_for,
    event_names,
    events,
    jax_params,
    jax_trainer,
    opt_snapshot,
    port_params,
    port_trainer,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
CHAIN = dict(clip_norm=1.0, lr_schedule="cosine", decay_rate=1e-4)


@pytest.fixture(scope="module")
def data():
    return data_for()


@pytest.fixture(scope="module")
def init(data, tmp_path_factory):
    """The JAX init at INIT_SEED, as a params tree."""
    return jax_trainer(tmp_path_factory.mktemp("init"), data).params


def _signal_at_epoch(tr, sig, epoch: int) -> None:
    """Send ``sig`` to this process as the trainer starts epoch
    ``epoch``'s train mode (the handler lets the epoch finish)."""
    calls, run = [0], tr._run_epoch

    def wrapped(mode, exec_path, rng):
        if mode == "train":
            calls[0] += 1
            if calls[0] == epoch:
                os.kill(os.getpid(), sig)
        return run(mode, exec_path, rng)

    tr._run_epoch = wrapped


def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _rewrite(path, **extra):
    ckpt = read_checkpoint(path)
    ckpt["extra"].update(extra)
    for k in [k for k, v in extra.items() if v is None]:
        ckpt["extra"].pop(k)
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


@pytest.mark.parametrize("cut,scan,chain", [
    ("SIGTERM", True, True), ("SIGINT", False, False),
    ("stop", True, False)])
def test_resume_equals_straight_bitwise(tmp_path, data, init, cut, scan,
                                        chain):
    """tests/test_resilience.py:195 and :220, tests/test_trainer.py:254,
    :317 and :531: a run cut after epoch 2 (a signal during it, or a run
    of 2 epochs) and resumed to 4 equals 4 straight epochs bit for bit,
    the shuffle replayed; the cut run saved its rolling checkpoint and
    logged ``preempted``; the signal handlers are restored."""
    kw = dict(shuffle=True, epoch_scan=scan, num_epochs=4,
              **(CHAIN if chain else {}))
    straight = port_trainer(tmp_path / "straight", data, init=init, **kw)
    hs = straight.train()
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    cut_kw = dict(kw, num_epochs=2) if cut == "stop" else kw
    first = port_trainer(tmp_path / "cut", data, init=init, **cut_kw)
    if cut != "stop":
        _signal_at_epoch(first, getattr(signal, cut), 2)
    h1 = first.train()
    assert {s: signal.getsignal(s) for s in prev} == prev
    assert len(h1["train"]) == len(h1["validate"]) == 2
    assert os.path.exists(tmp_path / "cut" / "MPGCN_od_last.pkl")
    assert ("preempted" in event_names(tmp_path / "cut")) == (cut != "stop")
    resumed = port_trainer(tmp_path / "cut", data, **kw)
    h2 = resumed.train(resume=True)
    for mode in ("train", "validate"):
        assert h1[mode] + h2[mode] == hs[mode], mode
    for (k, a), b in zip(port_params(straight).items(),
                         port_params(resumed).values()):
        assert torch.equal(a, b), k
    for a, b in zip(opt_snapshot(straight), opt_snapshot(resumed)):
        assert torch.equal(a, b)
    assert resumed.global_step == straight.global_step
    assert events(tmp_path / "cut", "train_start")[-1]["resume"] is True


def test_double_sigint_aborts_immediately(tmp_path, data, init):
    """tests/test_resilience.py:247: a second Ctrl-C aborts at once."""
    tr = port_trainer(tmp_path, data, init=init, num_epochs=4,
                      epoch_scan=False)
    prev = signal.getsignal(signal.SIGINT)
    step, calls = tr.train_step, [0]

    def twice(batch):
        calls[0] += 1
        if calls[0] == 1:
            os.kill(os.getpid(), signal.SIGINT)
            os.kill(os.getpid(), signal.SIGINT)
        return step(batch)

    tr.train_step = twice
    with pytest.raises(KeyboardInterrupt):
        tr.train()
    assert signal.getsignal(signal.SIGINT) is prev


@pytest.mark.parametrize("torn", ["last", "both"])
def test_torn_checkpoints_fall_back(tmp_path, data, init, torn, capsys):
    """tests/test_resilience.py:281 and :298: a torn rolling checkpoint
    falls back to the best one; with both torn the run trains from
    scratch; each torn file read is logged as ``ckpt_corrupt``."""
    port_trainer(tmp_path, data, init=init, num_epochs=2).train()
    _truncate(tmp_path / "MPGCN_od_last.pkl")
    if torn == "both":
        _truncate(tmp_path / "MPGCN_od.pkl")
    capsys.readouterr()
    h = port_trainer(tmp_path, data, init=init, num_epochs=3).train(
        resume=True)
    out = capsys.readouterr().out
    assert "corrupt" in out and np.isfinite(h["train"]).all()
    corrupt = events(tmp_path, "ckpt_corrupt")
    if torn == "last":
        assert "Resuming from epoch 2" in out and len(h["train"]) == 1
        assert len(corrupt) == 1
    else:
        assert "no checkpoint" in out and "scratch" in out
        assert len(h["train"]) == 3 and len(corrupt) == 2


def test_resume_without_checkpoint_warns_and_trains(tmp_path, data, init,
                                                    capsys):
    """tests/test_trainer.py:282."""
    h = port_trainer(tmp_path, data, init=init, num_epochs=1).train(
        resume=True)
    assert "no checkpoint" in capsys.readouterr().out
    assert len(h["train"]) == 1


@pytest.mark.parametrize("case", ["patience", "no-best-val"])
def test_resume_reads_the_early_stop_state(tmp_path, data, init, case):
    """tests/test_trainer.py:487: the rolling checkpoint's patience and
    best loss carry over (one patience left, an unbeatable best: one more
    epoch); :510: a best-only checkpoint without best_val gets it from a
    validation pass, never inf."""
    port_trainer(tmp_path, data, init=init, num_epochs=2).train()
    last = tmp_path / "MPGCN_od_last.pkl"
    if case == "patience":
        _rewrite(last, patience_count=1, best_val=0.0)
        h = port_trainer(tmp_path, data, num_epochs=50).train(resume=True)
        assert len(h["train"]) == 1
        assert event_names(tmp_path)[-1] == "early_stop"
    else:
        _rewrite(tmp_path / "MPGCN_od.pkl", best_val=None)
        os.remove(last)
        tr = port_trainer(tmp_path, data, num_epochs=3)
        h = tr.train(resume=True)
        assert len(h["train"]) == 1 and np.isfinite(h["validate"]).all()
        ckpt = read_checkpoint(tmp_path / "MPGCN_od.pkl")
        assert np.isfinite(ckpt["extra"]["best_val"])


@pytest.mark.parametrize("case", ["adam", "chain", "other-chain"])
def test_port_resumes_a_jax_last_checkpoint(tmp_path, data, case, capsys):
    """A JAX run's rolling checkpoint (params, optax state, early-stop
    state) resumed by the port and by the JAX trainer: after one more
    epoch the weights agree, and the port took Adam's moments and count
    from the optax state. Saved under another chain than the resuming
    run's (``other-chain``: saved with -lrs cosine), both warn, restore
    the params only and start a fresh optimizer."""
    save_kw = CHAIN if case != "adam" else {}
    run_kw = CHAIN if case == "chain" else {}
    src = tmp_path / "src"
    jax_trainer(src, data, num_epochs=2, **save_kw).train()
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    saved = jax_load(str(src / "MPGCN_od_last.pkl"))
    capsys.readouterr()
    jt = jax_trainer(tmp_path / "jax", data, num_epochs=3, **run_kw)
    hj = jt.train(resume=True)
    warned_j = "different structure" in capsys.readouterr().out
    pt = port_trainer(tmp_path / "port", data, num_epochs=3, **run_kw)
    hp = pt.train(resume=True)
    warned_p = "different structure" in capsys.readouterr().out
    assert warned_j == warned_p == (case == "other-chain")
    assert len(hj["train"]) == len(hp["train"]) == 1
    final = jax_params(jt)
    for k, v in port_params(pt).items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k,
                                   **PARAM_TOL)
    S = pt.pipeline.num_batches("train")
    count = 0 if case == "other-chain" else 2 * S
    assert int(pt.optimizer.step_t) == count + S
    assert pt.global_step == saved["extra"]["global_step"] + S


def test_jax_reads_a_port_checkpoint(tmp_path, data, init):
    """The JAX trainer loads a port ``_last`` checkpoint: the params as
    they are, and a fresh optimizer (the port's state rides under its own
    key), as for a best-only file; its resume continues from epoch 2."""
    pt = port_trainer(tmp_path / "port", data, init=init, num_epochs=2)
    pt.train()
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jt = jax_trainer(tmp_path / "jax", data, num_epochs=3)
    fresh = jt.opt_state
    ckpt = jt.load_trained(str(tmp_path / "jax" / "MPGCN_od_last.pkl"))
    assert "opt_state" not in ckpt and "opt_state_torch" in ckpt
    assert jt.opt_state is fresh and int(jt.opt_state[0].count) == 0
    live = port_params(pt)
    for k, v in jax_params(jt).items():
        assert torch.equal(v, live[k]), k
    h = jt.train(resume=True)
    assert len(h["train"]) == 1 and np.isfinite(h["train"]).all()


def _damage_leaf(path, section):
    """Change one leaf of ``section`` after the file's records were
    written (a bit flip that still unpickles), keeping the records."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    if section == "params":
        fc = ckpt["params"]["branches"][0]["fc"]
        fc["b"] = np.array(fc["b"]) + np.float32(1.0)
    elif section == "opt_state":  # the JAX ScaleByAdamState's mu
        mu = ckpt["opt_state"][0].mu["branches"][0]["fc"]
        mu["b"] = np.array(mu["b"]) + np.float32(1.0)
    else:  # the port's Adam moments
        mu = ckpt["opt_state_torch"]["mu"]["branches"][0]["fc"]
        mu["b"] = np.array(mu["b"]) + np.float32(1.0)
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


@pytest.mark.parametrize("writer,section", [
    ("port", "params"), ("jax", "params"), ("jax", "opt_state"),
    ("port", "opt_state_torch")])
def test_damaged_leaf_falls_back_to_best(tmp_path, data, init, writer,
                                         section, capsys):
    """A rolling checkpoint whose leaf changed after its integrity record
    was written: the port's ``-resume`` logs ``ckpt_corrupt`` and resumes
    from the best checkpoint, as the JAX trainer does on the same files
    (the port's own optimizer record is the port's: the JAX trainer reads
    params only from a port file and resumes from it)."""
    src = tmp_path / "src"
    if writer == "port":
        port_trainer(src, data, init=init, num_epochs=2).train()
    else:
        jax_trainer(src, data, num_epochs=2).train()
    assert "integrity" in read_checkpoint(src / "MPGCN_od_last.pkl")
    _damage_leaf(src / "MPGCN_od_last.pkl", section)
    for side in ("jax", "port"):
        shutil.copytree(src, tmp_path / side)
    capsys.readouterr()
    hp = port_trainer(tmp_path / "port", data, num_epochs=3).train(
        resume=True)
    out = capsys.readouterr().out
    assert "integrity checksum mismatch" in out
    assert "Resuming from epoch" in out and len(hp["train"]) == 1
    assert [e["path"] for e in events(tmp_path / "port", "ckpt_corrupt")
            ] == [str(tmp_path / "port" / "MPGCN_od_last.pkl")]
    hj = jax_trainer(tmp_path / "jax", data, num_epochs=3).train(
        resume=True)
    out = capsys.readouterr().out
    jax_fell_back = bool(events(tmp_path / "jax", "ckpt_corrupt"))
    assert jax_fell_back == (section != "opt_state_torch")
    assert ("Resuming from epoch" in out) == jax_fell_back
    assert len(hj["train"]) == 1


def test_the_loaders_verify_each_others_records(tmp_path, data, init):
    """The JAX ``load_checkpoint`` verifies an intact port checkpoint (its
    manifest and ``params`` record; no ``opt_state`` section) and raises
    ``CheckpointCorruptError`` on one whose ``params`` leaf changed; the
    port's loader raises on a JAX file damaged the same way."""
    from mpgcn_tpu.train.checkpoint import \
        CheckpointCorruptError as JaxCorrupt
    from mpgcn_tpu_torch.train.checkpoint import (
        OPT_INTEGRITY_KEY,
        CheckpointCorruptError,
        load_checkpoint,
    )

    port_trainer(tmp_path / "port", data, init=init, num_epochs=1).train()
    path = tmp_path / "port" / "MPGCN_od_last.pkl"
    ckpt = jax_load(str(path))
    assert ckpt["manifest"]["format"] == 1 and ckpt["manifest"]["mesh"] is None
    assert set(ckpt["integrity"]["leaves"]) == {
        k for k in ckpt["integrity"]["leaves"] if k.startswith("params[")}
    assert all(k.startswith("opt_state_torch[")
               for k in ckpt[OPT_INTEGRITY_KEY]["leaves"])
    assert load_checkpoint(str(path))["epoch"] == 1
    _damage_leaf(path, "params")
    with pytest.raises(JaxCorrupt, match="integrity"):
        jax_load(str(path))
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        load_checkpoint(str(path))
    jax_trainer(tmp_path / "jax", data, num_epochs=1).train()
    jpath = tmp_path / "jax" / "MPGCN_od_last.pkl"
    assert load_checkpoint(str(jpath))["epoch"] == 1
    _damage_leaf(jpath, "params")
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        load_checkpoint(str(jpath))
