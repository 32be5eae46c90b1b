"""The port's dead-init probe against the JAX trainer's, on the CPU (mirrors
tests/test_trainer.py:642-860): each scenario runs in both packages from
the same dead draw (every branch's FC head forced negative, so the
forward is identically zero and every gradient exactly zero), and the
verdicts (what raises and with which message, how many epochs train,
whether the warning prints), the sticky ``dead_init`` flag in the rolling
checkpoint and the run log's event names must agree. Weights are not
compared after a reseed: the port draws its own init."""

import os
import pickle

import pytest
import torch

from mpgcn_tpu.train.trainer import DeadInitError as JaxDeadInitError
from mpgcn_tpu_torch.train.trainer import DeadInitError
from mpgcn_tpu_torch.utils.convert import read_checkpoint
from tests.torch_heal_common import (
    data_for,
    event_names,
    force_dead_head,
    jax_trainer,
    port_trainer,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PHRASES = ("flagged dead_init", "no parameter changed",
           "loss-gradient global norm")


@pytest.fixture(scope="module")
def data():
    return data_for()


@pytest.fixture(scope="module")
def dead(data, tmp_path_factory):
    """The dead draw: the JAX init at INIT_SEED with its heads forced."""
    jt = jax_trainer(tmp_path_factory.mktemp("dead"), data)
    force_dead_head(jt)
    return jt.params


def _trainer(side, out, data, dead, kill, kw):
    if side == "jax":
        t = jax_trainer(out, data, **kw)
        if kill:
            force_dead_head(t)
        return t
    return port_trainer(out, data, init=dead if kill else None, **kw)


def _run(side, out, data, dead, capsys, kill=True, resume=False, **kw):
    """One train() call: what it raised (class, phrase), the epochs it
    trained, whether it printed the warning, and the flag in the rolling
    checkpoint after it."""
    t = _trainer(side, out, data, dead, kill, kw)
    capsys.readouterr()
    raised, epochs = None, None
    try:
        epochs = len(t.train(resume=resume)["train"])
    except (DeadInitError, JaxDeadInitError) as e:
        assert isinstance(e, RuntimeError)
        raised = (type(e).__name__,
                  next(p for p in PHRASES if p in str(e)))
    out_text = capsys.readouterr().out
    last = os.path.join(str(out), "MPGCN_od_last.pkl")
    flag = (read_checkpoint(last).get("extra", {}).get("dead_init")
            if os.path.exists(last) else None)
    return dict(raised=raised, epochs=epochs, flag=flag,
                warned="WARNING: dead initialization" in out_text,
                epoch1="Epoch 1," in out_text)


def _strip_flag(out):
    path = os.path.join(str(out), "MPGCN_od_last.pkl")
    with open(path, "rb") as f:
        ckpt = pickle.load(f)  # a JAX one holds optax classes
    ckpt["extra"].pop("dead_init", None)
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


#: scenario -> its train() calls in order, each (trainer kwargs, resume,
#: the dead draw forced), and the verdicts the port must share with JAX
SCENARIOS = {
    # :642 -- warn flags it and trains on; a live init does not warn
    "warn": [(dict(num_epochs=1, on_dead_init="warn"), False, True)],
    "healthy": [(dict(num_epochs=1, on_dead_init="warn"), False, False)],
    # :666
    "error": [(dict(num_epochs=5, on_dead_init="error"), False, True)],
    # :675 -- a dead run resumed after epoch 1 is found again
    "resume-after-epoch-1": [
        (dict(num_epochs=1, on_dead_init="warn"), False, True),
        (dict(num_epochs=3, on_dead_init="error"), True, False)],
    # :688 -- decay runs probe one batch's gradient before epoch 1
    "decay-probe": [(dict(num_epochs=3, decay_rate=1e-4,
                          on_dead_init="error"), False, True)],
    # :807 -- the flag sticks in every rolling save and a resume raises
    "sticky-flag": [
        (dict(num_epochs=3, on_dead_init="warn"), False, True),
        (dict(num_epochs=5, on_dead_init="error"), True, False)],
    # :826 -- error mode saves the flag before raising
    "error-double-resume": [
        (dict(num_epochs=6, on_dead_init="error"), False, True),
        (dict(num_epochs=6, on_dead_init="error"), True, False),
        (dict(num_epochs=6, on_dead_init="error"), True, False)],
    # :839 -- without the flag, the first resumed epoch probes again
    "rearm-without-flag": [
        (dict(num_epochs=3, on_dead_init="warn"), False, True),
        "strip",
        (dict(num_epochs=6, on_dead_init="error"), True, False)],
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_dead_init_verdicts_match_jax(tmp_path, data, dead, capsys,
                                      scenario):
    got = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        got[side] = []
        for call in SCENARIOS[scenario]:
            if call == "strip":
                _strip_flag(out)
                continue
            kw, resume, kill = call
            got[side].append(_run(side, out, data, dead, capsys, kill=kill,
                                  resume=resume, **kw))
        got[side].append(event_names(out))
    assert got["port"] == got["jax"], got
    first = got["port"][0]
    if scenario == "healthy":
        assert first["raised"] is None and not first["warned"]
    else:
        assert first["raised"] or first["warned"]
        assert "dead_init" in got["port"][-1]
    if scenario == "decay-probe":
        assert not first["epoch1"]


@pytest.mark.parametrize("exhaust", [False, True])
def test_dead_init_retry_reseeds(tmp_path, data, dead, capsys, exhaust):
    """:775 -- retry reseeds from seed + 100003 and trains the whole budget
    on the live draw; :789 -- when every draw is dead, it gives up after
    dead_init_retries reseeds with the error. The port reseeds its own
    init, so only the verdicts are compared."""
    got = {}
    for side in ("jax", "port"):
        t = _trainer(side, tmp_path / side, data, dead, True,
                     dict(num_epochs=2, on_dead_init="retry",
                          dead_init_retries=2))
        seeds, reseed = [], t._reseed
        if exhaust:
            def reseed_and_kill(seed, t=t, reseed=reseed, seeds=seeds):
                seeds.append(seed)
                reseed(seed)
                force_dead_head(t)

            t._reseed = reseed_and_kill
        capsys.readouterr()
        try:
            res = len(t.train()["train"])
        except (DeadInitError, JaxDeadInitError) as e:
            res = type(e).__name__
        out = capsys.readouterr().out
        got[side] = dict(res=res, seed=t.cfg.seed, seeds=seeds,
                         retried="retrying with seed" in out,
                         detected=t._dead_init_detected,
                         events=event_names(tmp_path / side))
    assert got["port"] == got["jax"], got
    if exhaust:
        assert got["port"]["res"] == "DeadInitError"
        assert got["port"]["seeds"] == [10 + 100003, 10 + 2 * 100003]
    else:
        assert got["port"]["res"] == 2 and got["port"]["seed"] == 100013
        assert not got["port"]["detected"]
