"""The port's step sentinels, bad-epoch rollback, run log, hang watchdog
and the self-healing CLI flags against the JAX package's, on the CPU
(mirrors tests/test_resilience.py:64-180, 409-460).

NaN data: the tests write NaN input windows into both trainers' training
split (tests/torch_heal_common.py ``poison``), where the JAX tests inject
them with a fault plan (not ported); the window stays poisoned in every
epoch and every retry.

Tolerances: epoch losses rtol 1e-5; weights rtol 1e-5 / atol 1e-6 after
the run (f32 Adam at lr 1e-4, other summation orders); the port with
sentinels on against off, and a skipped step's state, bit for bit.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.resilience import HangWatchdog as JaxWatchdog
from mpgcn_tpu.utils.logging import RunLogger as JaxRunLogger
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.resilience.sentinels import (
    StepGuard,
    all_finite,
    mark_loss,
    skip_if_bad,
)
from mpgcn_tpu_torch.resilience.watchdog import (
    WATCHDOG_EXIT_CODE,
    HangWatchdog,
)
from mpgcn_tpu_torch.train.checkpoint import (
    checkpoint_payload,
    load_checkpoint,
)
from mpgcn_tpu_torch.utils.logging import RunLogger, read_events
from tests.torch_heal_common import (
    data_for,
    event_names,
    events,
    finite_jax,
    finite_port,
    jax_params,
    opt_snapshot,
    pair,
    poison,
    port_params,
    port_trainer,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data():
    return data_for()


# --- the sentinel's pieces --------------------------------------------------


def test_all_finite_is_exact_where_a_norm_overflows():
    """Finite values above ~1.8e19 overflow a plain norm to Inf; the
    verdict stays True on them, and False on one NaN or Inf anywhere."""
    big = torch.full((4,), 3e38)
    assert bool(all_finite([big, torch.ones(3)]))
    assert not torch.isfinite(torch.linalg.vector_norm(big))
    for bad in (float("nan"), float("inf"), -float("inf")):
        t = torch.ones(5)
        t[3] = bad
        assert not bool(all_finite([torch.ones(2), t]))
    ok = torch.tensor(True)
    new, old = [torch.arange(3.0)], [torch.full((3,), float("nan"))]
    assert torch.equal(skip_if_bad(ok, new, old)[0], new[0])
    assert skip_if_bad(~ok, new, old)[0].isnan().all()
    loss = torch.tensor(1.25)
    assert torch.equal(mark_loss(ok, loss), loss)
    assert mark_loss(~ok, loss).isnan()


def test_step_guard_keeps_or_restores_bit_for_bit():
    a = torch.randn(3, 4, dtype=torch.float32)
    b = torch.randn(5)
    c = torch.zeros((1,), dtype=torch.long)
    guard = StepGuard([a, b, c])
    before = [t.clone() for t in (a, b, c)]
    guard.save()
    a.mul_(1.5)
    c += 1
    after = [t.clone() for t in (a, b, c)]
    assert bool(guard.keep_if_finite(torch.tensor(0.5)))
    assert all(torch.equal(x, y) for x, y in zip((a, b, c), after))
    guard.save()
    b[2] = float("nan")
    c += 1
    assert not bool(guard.keep_if_finite(torch.tensor(0.5)))
    assert all(torch.equal(x, y) for x, y in zip((a, b, c), after))
    guard.save()
    a.add_(1.0)
    assert not bool(guard.keep_if_finite(torch.tensor(float("inf"))))
    assert all(torch.equal(x, y) for x, y in zip((a, b, c), after))
    assert not any(torch.equal(x, y) for x, y in zip(before[:1], after[:1]))


# --- sentinels in the trainer ----------------------------------------------


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_sentinels_clean_run_bitwise_identical(tmp_path, data, epoch_scan):
    """tests/test_resilience.py:64: sentinels on equal sentinels off bit for
    bit: epoch losses, weights, Adam's state and the step counter."""
    jt, _ = pair(tmp_path, data)
    runs = {}
    for on in (True, False):
        tr = port_trainer(tmp_path / f"s{on}", data, init=jt,
                          step_sentinels=on, epoch_scan=epoch_scan,
                          num_epochs=3)
        runs[on] = (tr, tr.train())
    (ton, hon), (toff, hoff) = runs[True], runs[False]
    assert hon == hoff
    for (k, a), b in zip(port_params(ton).items(), port_params(toff).values()):
        assert torch.equal(a, b), k
    for a, b in zip(opt_snapshot(ton), opt_snapshot(toff)):
        assert torch.equal(a, b)
    assert int(ton.optimizer.step_t) == 3 * ton.pipeline.num_batches("train")


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_nan_step_skipped_within_budget_matches_jax(tmp_path, data,
                                                    epoch_scan):
    """tests/test_resilience.py:84: NaN inputs at train step 2; the
    sentinel skips that step in both packages, the skip lands in the
    epoch's log, and the weights after the epoch match the JAX trainer's.
    One epoch: past it the two trajectories part at a clean step (epoch
    2, step 1: branch 0's gradients differ by ~0.5%, its head's by 1e-6,
    both packages having skipped the same steps), the mark of a ReLU
    input within an ulp of 0 that the summation orders resolve apart."""
    kw = dict(num_epochs=1, skip_budget=2, epoch_scan=epoch_scan)
    jt, pt = pair(tmp_path, data, **kw)
    poison(jt, 2)
    poison(pt, 2)
    step_losses = []
    if not epoch_scan:
        step = pt.train_step
        pt.train_step = lambda b: step_losses.append(step(b)) or \
            step_losses[-1]
    hj, hp = jt.train(), pt.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(hp[mode], hj[mode], **LOSS_TOL)
    assert np.isfinite(hp["train"]).all() and finite_port(pt)
    skips = [[e["skipped_steps"] for e in events(tmp_path / side, "epoch")]
             for side in ("jax", "port")]
    assert skips[0] == skips[1] == [1]
    assert event_names(tmp_path / "port") == event_names(tmp_path / "jax")
    final = jax_params(jt)
    for k, v in port_params(pt).items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k,
                                   **PARAM_TOL)
    # the loss stream marks the skipped step, and only it
    losses = (pt._epochs["train"].losses.numpy() if epoch_scan
              else np.array(step_losses[-pt.pipeline.num_batches("train"):]))
    assert np.isnan(losses[2]) and np.isfinite(np.delete(losses, 2)).all()
    # a skip does not advance the device step counter; the host mirror
    # counts every step
    S = pt.pipeline.num_batches("train")
    assert int(pt.optimizer.step_t) == S - 1 and pt.optimizer.count == S
    # within the budget the run goes on: the window skips in every epoch
    more = port_trainer(tmp_path / "more", data, init=jt,
                        **{**kw, "num_epochs": 3})
    poison(more, 2)
    h = more.train()
    assert len(h["train"]) == 3 and np.isfinite(h["train"]).all()
    assert [e["skipped_steps"] for e in events(tmp_path / "more",
                                               "epoch")] == [1, 1, 1]
    assert finite_port(more) and int(more.optimizer.step_t) == 3 * (S - 1)


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_skipped_step_leaves_the_state_bitwise(tmp_path, data, epoch_scan):
    """The weights, Adam's moments and steps, the rate and the step counter
    after a poisoned step equal those before it, bit for bit; the next
    clean step trains on."""
    pt = port_trainer(tmp_path, data, epoch_scan=epoch_scan)
    poison(pt, 1)
    before = after = None
    if epoch_scan:
        ep = pt._epoch_state("train")
        idx, sizes = pt._epoch_index("train", False, None)
        pt.optimizer.reserve(len(sizes))
        ep.load(idx, sizes)
        for i in range(3):
            if i == 1:
                before = port_params(pt), opt_snapshot(pt)
            pt._train_body(ep)
            if i == 1:
                after = port_params(pt), opt_snapshot(pt)
        losses = ep.losses[:3].numpy()
    else:
        batches = list(pt.pipeline.batches("train", pad_to_full=True))[:3]
        losses = []
        for i, b in enumerate(batches):
            if i == 1:
                before = port_params(pt), opt_snapshot(pt)
            losses.append(pt.train_step(b))
            if i == 1:
                after = port_params(pt), opt_snapshot(pt)
        losses = np.array(losses)
    assert np.isnan(losses[1]) and np.isfinite(losses[[0, 2]]).all()
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k
    for a, b in zip(before[1], after[1]):
        assert torch.equal(a, b)
    assert int(pt.optimizer.step_t) == 2
    assert finite_port(pt)


@pytest.mark.parametrize("case", ["exploding-lr", "exploding-lr-retries",
                                  "nan-window-rollback"])
def test_bad_epochs_roll_back_as_jax_does(tmp_path, data, case, capsys):
    """tests/test_resilience.py:101, :121 and :148: a bad epoch (past the
    skip budget) is quarantined to a postmortem checkpoint, the last good
    one restored, and the run stops or retries at a backed-off rate; the
    events come out in the JAX trainer's order, the weights stay finite,
    the rate shrinks as JAX's does."""
    kw = {"exploding-lr": dict(num_epochs=5, learn_rate=1e12),
          "exploding-lr-retries": dict(num_epochs=4, learn_rate=1e12,
                                       rollback_retries=2,
                                       rollback_lr_factor=1.0),
          "nan-window-rollback": dict(num_epochs=3, skip_budget=0,
                                      rollback_retries=1,
                                      rollback_lr_factor=0.5)}[case]
    jt, pt = pair(tmp_path, data, **kw)
    if case == "nan-window-rollback":
        poison(jt, 2)
        poison(pt, 2)
    hj = jt.train()
    capsys.readouterr()
    hp = pt.train()
    out = capsys.readouterr().out
    assert len(hp["train"]) == len(hj["train"]) == 1
    assert "skip_budget" in out and "quarantined" in out
    names = event_names(tmp_path / "port")
    assert names == event_names(tmp_path / "jax")
    retries = kw.get("rollback_retries", 0)
    assert names.count("rollback") == retries
    assert names.count("nan_abort") == retries + 1
    assert finite_port(pt) and finite_jax(jt)
    assert pt.cfg.learn_rate == jt.cfg.learn_rate == pytest.approx(
        kw["learn_rate"] if "learn_rate" in kw
        else 1e-4 * kw["rollback_lr_factor"] ** retries)
    for side in ("port", "jax"):
        aborts = events(tmp_path / side, "nan_abort")
        post = [f for f in os.listdir(tmp_path / side) if "postmortem" in f]
        assert post == ["MPGCN_od_postmortem_e1.pkl"], side
        assert aborts[0]["postmortem"].endswith(post[0])
    ckpt = load_checkpoint(events(tmp_path / "port", "nan_abort")[0]
                           ["postmortem"])
    assert "skip_budget" in ckpt["extra"]["quarantine_reason"]
    assert "opt_state_torch" in ckpt


# --- the run log -----------------------------------------------------------


def test_run_log_fields_match_jax(tmp_path, data):
    """The port's events carry the JAX trainer's fields (the JAX one adds
    those of paths the port does not have: precision, streams, the
    metrics registry)."""
    jt, pt = pair(tmp_path, data, num_epochs=1)
    jt.train()
    pt.train()
    ours, ref = events(tmp_path / "port"), events(tmp_path / "jax")
    assert [e["event"] for e in ours] == [e["event"] for e in ref] == [
        "train_start", "epoch", "train_end"]
    for o, r in zip(ours, ref):
        assert set(o) <= set(r), set(o) - set(r)
        for k in ("num_epochs", "steps_per_epoch", "batch_size", "K",
                  "num_nodes", "epoch", "best_epoch", "skipped_steps",
                  "loss_spikes", "resume", "epoch_exec"):
            if k in o:
                assert o[k] == r[k], k
    skip = {"event", "t", "lstm_impl", "bdgcn_impl", "steps_per_sec",
            "support_density"}
    assert set(ours[0]) - skip == {
        "num_epochs", "steps_per_epoch", "batch_size", "hidden_dim",
        "num_branches", "kernel", "K", "num_nodes", "resume", "epoch_exec"}


@pytest.mark.parametrize("logger_cls", [RunLogger, JaxRunLogger])
def test_runlogger_write_failure_does_not_kill_training(tmp_path, capsys,
                                                        logger_cls):
    target = tmp_path / "is_a_dir.jsonl"
    target.mkdir()
    logger = logger_cls(str(target))
    logger.log("epoch", loss=1.0)
    assert logger.path is None
    assert "logging disabled" in capsys.readouterr().out
    logger.log("epoch", loss=2.0)


def test_read_events_skips_a_torn_line(tmp_path):
    path = str(tmp_path / "log.jsonl")
    RunLogger(path).log("epoch", epoch=1)
    with open(path, "a") as f:
        f.write('{"event": "epo')
    assert [e["epoch"] for e in read_events(path, "epoch")] == [1]


# --- the hang watchdog -----------------------------------------------------


@pytest.mark.parametrize("cls", [HangWatchdog, JaxWatchdog])
def test_watchdog_beat_keeps_it_quiet(cls):
    """tests/test_resilience.py:424."""
    fired = []
    wd = cls(0.4, on_timeout=lambda: fired.append(1), poll_s=0.05).start()
    for _ in range(12):
        time.sleep(0.05)
        wd.beat()
    wd.stop()
    assert not fired and not wd.fired


def test_watchdog_fires_dumps_stacks_and_writes_emergency(tmp_path, capfd):
    """tests/test_resilience.py:435, through the ``on_timeout`` seam: the
    stacks on stderr, the emergency pickle from the last host copy (the
    port's checkpoint layout, read by its loader), the exit code and the
    logged event."""
    epath = str(tmp_path / "MPGCN_od_emergency.pkl")
    fired = []
    wd = HangWatchdog(0.3, emergency_path=epath, poll_s=0.05,
                      logger=RunLogger(str(tmp_path / "log.jsonl")),
                      on_timeout=lambda: fired.append(1)).start()
    with pytest.raises(TypeError, match="torch"):
        wd.update_state(checkpoint_payload({"w": torch.zeros(2)}, 1))
    wd.update_state(checkpoint_payload({"w": np.arange(3.0)}, 7,
                                       {"emergency": True}, {"count": 3}))
    deadline = time.time() + 5
    while not wd.fired and time.time() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert fired == [1] and wd.fire_code == WATCHDOG_EXIT_CODE == 113
    err = capfd.readouterr().err
    assert "HANG WATCHDOG" in err and "hread" in err
    with open(epath, "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["epoch"] == 7 and ckpt["opt_state_torch"] == {"count": 3}
    np.testing.assert_array_equal(ckpt["params"]["w"], np.arange(3.0))
    assert read_events(str(tmp_path / "log.jsonl"),
                       "watchdog_timeout")[0]["emergency"] == epath


def test_armed_watchdog_gets_one_host_copy_an_epoch(tmp_path, data):
    """-watchdog: a run that beats completes without firing; the watchdog
    holds the last epoch's state as host data, which the port's loader
    reads back as a checkpoint equal to the live weights."""
    pt = port_trainer(tmp_path, data, num_epochs=2, watchdog_secs=60.0)
    seen = []
    sync = pt._watchdog_sync
    pt._watchdog_sync = lambda *a: (sync(*a), seen.append(
        pt._watchdog._state))[0]
    pt.train()
    assert pt._watchdog is None and len(pt.watchdog_sync_ms) == 3
    state = seen[-1]
    assert state["epoch"] == 2 and state["extra"]["emergency"]
    assert state["opt_state_torch"]["count"] == int(pt.optimizer.step_t)
    path = str(tmp_path / "emergency.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    live = port_params(pt)
    from mpgcn_tpu_torch.utils.convert import params_from_jax

    for k, v in params_from_jax(load_checkpoint(path)["params"]).items():
        assert torch.equal(v, live[k]), k
    assert not os.path.exists(tmp_path / "MPGCN_od_emergency.pkl")


# --- the flags ---------------------------------------------------------------

SLICE_FLAGS = ["-resume", "-multistep", "-accum", "-dead-init",
               "-dead-init-retries", "-no-sentinels", "-skip-budget",
               "-rollback-retries", "-rollback-lr-factor", "-watchdog"]


@pytest.mark.parametrize("flag", SLICE_FLAGS)
def test_self_healing_flags_match_jax(flag):
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "const", "required", "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert type(ours) is type(ref)


def _short_flags(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings
            if not o.startswith("--")}


#: the city-scale feed's flags (tests/test_torch_cli.py holds their values)
FEED_FLAGS = ["-od-storage", "-fused-epilogue", "-no-stream",
              "-stream-chunk-mb", "-native"]


def test_missing_flag_count():
    """The JAX CLI's flags the port lacks: 5, the model axis's and
    liveness's (-bexec, -shard-branches, -liveness, -peer-timeout,
    -straggler-factor; 34 before the self-healing slice, 24 before the
    precision slice added -dtype, -loss-scaling, -loss-scale-init,
    -loss-scale-growth and -infer-precision, 19 before the city-scale
    feed added FEED_FLAGS, 14 before the daemon slice added -faults, 13
    before the operator surface added -trace, -no-obs, -compile-cache and
    -metrics-port, 9 before data-parallel training added -devices, -mp,
    -ckpt and -consistency); the port has none of its own."""
    ours, ref = (_short_flags(p) for p in (cli.build_parser(),
                                           jax_cli.build_parser()))
    assert not ours - ref
    assert "-faults" in ours
    assert len(ref - ours) == 5, sorted(ref - ours)
    assert not set(SLICE_FLAGS) - ours
    assert not set(FEED_FLAGS) - ours


@pytest.mark.parametrize("argv,pred_len", [
    (["-mode", "train"], 1), (["-mode", "train", "-multistep"], 6),
    (["-mode", "test"], 6)])
def test_multistep_keeps_pred_in_train_mode(argv, pred_len):
    args = cli.build_parser().parse_args(argv + ["-pred", "6", "-accum",
                                                 "2", "-resume"]).__dict__
    cfg = cli.config_from_args(dict(args))
    assert cfg.pred_len == pred_len and cfg.grad_accum == 2


def test_config_checks_match_jax():
    from mpgcn_tpu.config import MPGCNConfig as JaxConfig

    for bad in (dict(grad_accum=0), dict(batch_size=4, grad_accum=3),
                dict(dead_init_retries=0), dict(skip_budget=-1),
                dict(rollback_retries=-1), dict(rollback_lr_factor=0.0),
                dict(rollback_lr_factor=1.5), dict(loss_spike_factor=-1.0),
                dict(watchdog_secs=-1.0), dict(on_dead_init="ignore"),
                dict(dtype="float16"), dict(loss_scaling="static"),
                dict(loss_scale_init=0.0), dict(loss_scale_init=1000.0),
                dict(loss_scale_min=3.0), dict(loss_scale_min=-2.0),
                dict(loss_scale_init=2.0, loss_scale_min=4.0),
                dict(loss_scale_growth_interval=0),
                dict(infer_precision="fp8")):
        for cls in (MPGCNConfig, JaxConfig):
            with pytest.raises(ValueError):
                cls(**bad)
