"""The port's data-parallel training (mpgcn_tpu_torch/parallel/) against
the JAX package's, on the CPU: 2 gloo ranks as child processes that
import no JAX (tests/torch_parallel_worker.py), each group through a
``file://`` rendezvous under the test's tmp directory (xdist workers never
race for a port), one torch thread a rank, a 60 s group timeout and a
subprocess timeout, so a hang fails in minutes and never retries.

  (a) ``make_mesh`` shapes and errors; ``initialize`` a no-op without a
      world (tests/test_parallel.py:26, test_distributed.py:20);
  (b) the batch and microbatch divisibility messages, the JAX ones
      (test_parallel.py:37, :334);
  (c) one 2-rank train step equals the port's ``ModelTrainer`` and the
      JAX ``ParallelModelTrainer(num_devices=2)`` on the virtual CPU mesh
      from one init: loss rtol 1e-5, weights atol 2e-5 (:47);
  (d) ``grad_accum=2`` on 2 ranks equals the unchunked step (:325);
  (e) the scan, stream and per-step executors on 2 ranks, with a
      repeat-padded final batch: bit-equal to each other, to the port's
      ``ModelTrainer`` at rtol 2e-5 (:164), and 2 epochs on the scan and
      on the stream executor, without and with ``grad_accum`` 2, to the
      JAX ``ParallelModelTrainer`` on its 2-device mesh, executor for
      executor, at loss rtol 1e-5, weights atol 2e-5;
  (f) ``test`` on 2 ranks writes the one-device scores to 1e-4 (:84);
  (g) ``-consistency 1`` trains clean; a byte flipped on rank 1 raises
      ``ReplicaDivergenceError`` on both ranks in the same epoch, and
      the run rolls back (test_consistency.py:44, :60);
  (h) a 2-rank checkpoint (manifest ``process_count`` 2,
      ``writer_process`` 0) resumes on 1 rank, and a 1-rank one on 2;
  (i) ``-ckpt orbax`` round-trips through the port's directory form; a
      JAX orbax directory is refused, naming the format;
  (j) ``-faults nan_step`` skips the same step on both ranks;
  (k) the CLI ``-GPU cpu -devices 2``, resume then test, against the JAX
      CLI ``-devices 2`` from one JAX checkpoint: epoch losses rtol 1e-5,
      scores rtol 1e-4; a rank killed mid-run fails the command with no
      rank left running;
  (l) ``nn/gcn.py`` against the JAX ``gcn_apply`` at 1e-5.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.nn.gcn import gcn_apply as jax_gcn_apply
from mpgcn_tpu.parallel import ParallelModelTrainer as JaxParallel
from mpgcn_tpu.train.checkpoint import save_checkpoint_orbax
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.nn.gcn import GCN, gcn_apply
from mpgcn_tpu_torch.parallel import (
    Mesh,
    ParallelModelTrainer,
    batch_shard,
    initialize,
    make_mesh,
)
from mpgcn_tpu_torch.train.checkpoint import load_checkpoint
from mpgcn_tpu_torch.utils.convert import params_from_jax
from tests.torch_heal_common import (
    INIT_SEED,
    KW,
    data_for,
    events,
    jax_trainer,
    np_tree,
    port_trainer,
)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(atol=2e-5, rtol=0)
SCENARIOS = ("mesh", "step", "accum", "scan", "stream", "scan_accum",
             "stream_accum", "per_step", "test", "resume", "orbax", "nan",
             "consistency")


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "MPGCN_FAULTS"):
        env.pop(k, None)
    return env


def _launch(out, scenarios, init_params, timeout=300):
    """Run ``scenarios`` on 2 gloo ranks; returns load(name) -> the two
    ranks' findings."""
    os.makedirs(out, exist_ok=True)
    spec = {"init": f"file://{out}/rendezvous", "world": 2, "out": str(out),
            "scenarios": list(scenarios), "init_params": str(init_params),
            "data_kw": KW, "kw": {**KW, "seed": INIT_SEED},
            "timeout_s": 60}
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, os.path.join(out, "spec.json"), str(r)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], \
        "\n".join(x[-3000:] for x in logs)

    def load(name):
        return [torch.load(os.path.join(out, name, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]

    return load


@pytest.fixture(scope="module")
def data():
    return data_for()


@pytest.fixture(scope="module")
def init(data, tmp_path_factory):
    """The JAX init at INIT_SEED: the JAX trainer and its params as the
    port's state_dict file the ranks load."""
    jt = jax_trainer(tmp_path_factory.mktemp("init"), data)
    path = tmp_path_factory.mktemp("init_pt") / "init.pt"
    torch.save(params_from_jax(np_tree(jt.params)), path)
    return jt, path


@pytest.fixture(scope="module")
def ranks(data, init, tmp_path_factory):
    """Every scenario on one 2-rank group (after a 1-rank run to resume
    from)."""
    out = tmp_path_factory.mktemp("ranks")
    port_trainer(out / "resume", data, init=init[0], num_epochs=2).train()
    shutil.copytree(out / "resume", out / "resume_1rank")
    return out, _launch(out, SCENARIOS, init[1])


def _state(tr) -> dict:
    out = {f"p:{k}": v.detach() for k, v in tr.model.state_dict().items()}
    for k, p in tr.model.named_parameters():
        for name, t in tr.optimizer.state[p].items():
            out[f"o:{k}:{name}"] = t.detach()
    return out


def _same_replicas(a: dict, b: dict) -> None:
    keys = [k for k in a if k.startswith(("p:", "o:"))]
    assert keys
    for k in keys:
        assert torch.equal(a[k], b[k]), k


def _close_params(got: dict, ref: dict, tol=PARAM_TOL) -> None:
    for k, v in ref.items():
        np.testing.assert_allclose(got[f"p:{k}"].numpy(), v.numpy(), **tol,
                                   err_msg=k)


# --- (a) the mesh and initialize ---------------------------------------------


def test_mesh_shapes(ranks):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.world == 1
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                                         "visible"):
        make_mesh(2, device="cpu")
    for found in ranks[1]("mesh"):
        assert found["shape"] == {"data": 2, "model": 1}
        assert found["(4, 1)"] == ("ValueError: requested 4 devices, only "
                                   "2 visible")
        assert found["(2, 3)"].startswith("ValueError: num_devices 2 not "
                                          "divisible by model_parallel 3")
        assert found["(2, 2)"] == "ok"  # the (1, 2) mesh of the model axis
    assert batch_shard(Mesh({"data": 2, "model": 1}, 1, 2, "cpu"), 8) \
        == slice(4, 8)


def test_initialize_single_process_is_noop(monkeypatch, tmp_path):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() is False
    assert not torch.distributed.is_initialized()
    try:  # an explicit world of 1: a one-rank group, still not multi
        assert initialize(f"file://{tmp_path}/rdzv", world_size=1,
                          backend="gloo") is False
        assert torch.distributed.get_world_size() == 1
        assert initialize() is False  # idempotent
    finally:
        torch.distributed.destroy_process_group()


# --- (b) divisibility ---------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(batch_size=3),
                                dict(batch_size=4, grad_accum=4)])
def test_divisibility_messages_match_jax(data, tmp_path, kw):
    mesh = Mesh({"data": 2, "model": 1}, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible") as ours:
        ParallelModelTrainer(MPGCNConfig(**{**KW, **kw}), data, mesh=mesh)
    with pytest.raises(ValueError, match="divisible") as ref:
        JaxParallel(JaxConfig(output_dir=str(tmp_path), native_host="off",
                              **{**KW, **kw}), data, num_devices=2)
    assert str(ours.value) == str(ref.value)


# --- (c), (d) one step --------------------------------------------------------


def _jax_step(jt_cfg_kw, data, tmp_path):
    par = JaxParallel(JaxConfig(output_dir=str(tmp_path), native_host="off",
                                donate=False, seed=INIT_SEED,
                                **{**KW, **jt_cfg_kw}), data, num_devices=2)
    batch = next(par.pipeline.batches("train", pad_to_full=True))
    p, _, loss = par._train_step(
        par.params, par.opt_state, par.banks,
        par._device_batch(batch.x, "x"), par._device_batch(batch.y, "x"),
        par._device_batch(batch.keys, "keys"), batch.size)
    return float(loss), params_from_jax(np_tree(p))


def _port_step(data, init, tmp_path, **kw):
    tr = port_trainer(tmp_path, data, init=init, **kw)
    loss = tr.train_step(next(tr.pipeline.batches("train",
                                                  pad_to_full=True)))
    return loss, {k: v.detach() for k, v in tr.model.state_dict().items()}


@pytest.mark.parametrize("scenario,kw", [
    ("step", {}), ("accum", dict(batch_size=8, grad_accum=2))])
def test_parallel_step_equals_single_device(ranks, data, init, tmp_path,
                                            scenario, kw):
    """(c) and (d): both ranks hold one replica; the 2-rank step equals
    the port's one-device step (unchunked under accum) and the JAX 2-device
    mesh step."""
    r0, r1 = ranks[1](scenario)
    _same_replicas(r0, r1)
    assert r0["loss"] == r1["loss"]
    one = {k: v for k, v in kw.items() if k != "grad_accum"}
    loss, params = _port_step(data, init[0], tmp_path / "port", **one)
    np.testing.assert_allclose(r0["loss"], loss, **LOSS_TOL)
    _close_params(r0, params)
    jloss, jparams = _jax_step(kw, data, tmp_path / "jax")
    np.testing.assert_allclose(r0["loss"], jloss, **LOSS_TOL)
    _close_params(r0, jparams)


# --- (e) the executors --------------------------------------------------------

#: the worker's 2-epoch scenarios: the executor's config, without and
#: with grad_accum 2 (batch 8: chunks of 4, 2 rows a rank)
EPOCH_KW = {
    "scan": {},
    "stream": dict(epoch_scan_max_mb=0.0, stream_chunk_mb=0.02),
    "scan_accum": dict(batch_size=8, grad_accum=2),
    "stream_accum": dict(batch_size=8, grad_accum=2, epoch_scan_max_mb=0.0,
                         stream_chunk_mb=0.02),
}


@pytest.fixture(scope="module")
def jax_epochs(data, tmp_path_factory):
    """JAX ``ParallelModelTrainer(num_devices=2)`` trained 2 epochs from the
    init the ranks load, for each of the worker's 2-epoch scenarios:
    scenario -> (hist, params as the port's state_dict)."""
    found = {}
    for name, kw in EPOCH_KW.items():
        par = JaxParallel(JaxConfig(
            output_dir=str(tmp_path_factory.mktemp(f"jax_{name}")),
            native_host="off", seed=INIT_SEED, num_epochs=2,
            **{**KW, **kw}), data, num_devices=2)
        assert par._epoch_exec("train") == name.split("_")[0]
        hist = par.train()
        found[name] = (hist, params_from_jax(np_tree(par.params)))
    return found


def test_executors_agree_on_two_ranks(ranks, data, init, tmp_path):
    """34 training windows at batch 4: the final batch's 2 real rows are
    rank 0's, rank 1's are repeat padding that the global positions
    mask."""
    found = {name: ranks[1](name) for name in ("scan", "stream",
                                               "per_step")}
    assert [found[n][0]["exec"] for n in found] == list(found)
    for name, (r0, r1) in found.items():
        _same_replicas(r0, r1)
        assert r0["hist"] == found["scan"][0]["hist"], name
        _same_replicas(r0, found["scan"][0])
    ref = port_trainer(tmp_path, data, init=init[0], num_epochs=2)
    hist = ref.train()
    r0 = found["scan"][0]
    for mode in ("train", "validate"):
        np.testing.assert_allclose(r0["hist"][mode], hist[mode], rtol=2e-5)
    _close_params(r0, {k: v.detach()
                       for k, v in ref.model.state_dict().items()},
                  dict(atol=3e-5, rtol=0))


@pytest.mark.parametrize("scenario", list(EPOCH_KW))
def test_two_rank_epochs_equal_the_jax_mesh(ranks, jax_epochs, scenario):
    """2 epochs on 2 ranks against the JAX trainer on its 2-device mesh,
    executor for executor, without and with ``grad_accum`` 2 (the padded
    final batch included): epoch losses rtol 1e-5, weights atol 2e-5."""
    r0, r1 = ranks[1](scenario)
    _same_replicas(r0, r1)
    assert r0["exec"] == scenario.split("_")[0]
    hist, params = jax_epochs[scenario]
    for mode in ("train", "validate"):
        np.testing.assert_allclose(r0["hist"][mode], hist[mode], **LOSS_TOL)
    _close_params(r0, params)


# --- (f) test mode ------------------------------------------------------------


def test_two_rank_test_writes_the_one_device_scores(ranks, data, tmp_path):
    out, load = ranks
    r0, r1 = load("test")
    assert r0["results"].keys() == r1["results"].keys() == {"train", "test"}
    rows = (out / "test" / "MPGCN_prediction_scores.txt").read_text()
    assert [line.split(",")[0] for line in rows.splitlines()] == \
        ["train", "test"]  # rank 0 alone wrote
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(out / "test" / "MPGCN_od.pkl", one / "MPGCN_od.pkl")
    ref = port_trainer(one, data, pred_len=3).test()
    for mode in ("train", "test"):
        for k in ("MSE", "RMSE", "MAE", "MAPE"):
            np.testing.assert_allclose(r0["results"][mode][k],
                                       ref[mode][k], rtol=1e-4)
            assert r0["results"][mode][k] == r1["results"][mode][k]


# --- (g) consistency ----------------------------------------------------------


def test_consistency_detects_a_flipped_replica_on_both_ranks(ranks):
    out, load = ranks
    r0, r1 = load("consistency")
    assert r0["clean"] == r1["clean"] == 2
    for found in (r0, r1):
        assert "disagree" in found["flipped"] and "toy" in found["flipped"]
        # epoch 2 raised on both ranks, rolled back, trained on clean
        assert found["raised"] == [2]
        assert len(found["hist"]["train"]) == 2
    _same_replicas(r0, r1)
    names = [e["event"] for e in events(out / "consistency")]
    assert names.count("train_start") == 2
    abort = events(out / "consistency", "nan_abort")
    assert len(abort) == 1 and abort[0]["epoch"] == 2 \
        and abort[0]["reason"].startswith("replica divergence")
    assert [e["epoch"] for e in events(out / "consistency",
                                       "consistency_ok")] == [1, 2, 3]
    assert len(events(out / "consistency", "rollback")) == 1


# --- (h) resume across worlds -------------------------------------------------


def test_checkpoints_resume_across_worlds(ranks, data, init, tmp_path):
    out, load = ranks
    ckpt = load_checkpoint(str(out / "scan" / "MPGCN_od_last.pkl"))
    assert ckpt["epoch"] == 2
    m = ckpt["manifest"]
    assert (m["process_count"], m["device_count"], m["writer_process"],
            m["mesh"]) == (2, 2, 0, {"data": 2, "model": 1})
    # 2 ranks -> 1
    shutil.copytree(out / "scan", tmp_path / "on1")
    tr = port_trainer(tmp_path / "on1", data, num_epochs=3)
    hist = tr.train(resume=True)
    straight = port_trainer(tmp_path / "straight", data, init=init[0],
                            num_epochs=3)
    ref = straight.train()
    np.testing.assert_allclose(hist["train"], ref["train"][2:], rtol=2e-5)
    # 1 rank -> 2: the ranks against the same checkpoint resumed on 1
    r0, r1 = load("resume")
    _same_replicas(r0, r1)
    one = port_trainer(out / "resume_1rank", data, num_epochs=3)
    h1 = one.train(resume=True)
    assert len(r0["hist"]["train"]) == 1
    np.testing.assert_allclose(r0["hist"]["train"], h1["train"], rtol=1e-5)
    _close_params(r0, {k: v.detach()
                       for k, v in one.model.state_dict().items()})


# --- (i) the directory checkpoint ---------------------------------------------


def test_orbax_directory_round_trips_and_jax_orbax_is_refused(
        ranks, init, tmp_path):
    out, load = ranks
    r0, r1 = load("orbax")
    path = out / "orbax" / "MPGCN_od_last.pkl"
    assert path.is_dir() and (path / "meta.pt").is_file()
    ckpt = load_checkpoint(str(path))
    assert ckpt["manifest"]["process_count"] == 2
    for k, v in params_from_jax(ckpt["params"]).items():
        assert np.array_equal(v.numpy(), r0[f"p:{k}"].numpy()), k
    assert np.isfinite(r0["results"]["test"]["RMSE"])
    jax_dir = tmp_path / "jax_orbax"
    save_checkpoint_orbax(str(jax_dir), init[0].params, 1)
    with pytest.raises(ValueError, match="JAX orbax checkpoint directory"):
        load_checkpoint(str(jax_dir))


def test_directory_checkpoint_recovery_and_torn_meta(tmp_path):
    """A write cut between its two renames leaves the last checkpoint at
    <path>.old, where the readers find it; a torn meta.pt is corrupt (so
    resume falls back, as on a torn pickle)."""
    from mpgcn_tpu_torch.train.checkpoint import (
        CheckpointCorruptError,
        checkpoint_exists,
        checkpoint_payload,
        write_checkpoint,
    )

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = str(tmp_path / "MPGCN_od.pkl")
    write_checkpoint(path, checkpoint_payload(params, 1, {"seed": 0}),
                     "orbax")
    write_checkpoint(path, checkpoint_payload(params, 2, {"seed": 0}),
                     "orbax")
    assert sorted(os.listdir(tmp_path)) == ["MPGCN_od.pkl"]
    os.rename(path, path + ".old")
    assert checkpoint_exists(path)
    assert load_checkpoint(path)["epoch"] == 2
    os.rename(path + ".old", path)
    meta = os.path.join(path, "meta.pt")
    with open(meta, "r+b") as f:
        f.truncate(os.path.getsize(meta) // 2)
    with pytest.raises(CheckpointCorruptError, match="corrupt"):
        load_checkpoint(path)


# --- (j) a NaN step -----------------------------------------------------------


def test_nan_step_skipped_on_both_ranks(ranks, data, init, tmp_path):
    out, load = ranks
    r0, r1 = load("nan")
    _same_replicas(r0, r1)
    assert r0["hist"] == r1["hist"]
    assert [e["skipped_steps"] for e in events(out / "nan", "epoch")] == [1]
    ref = port_trainer(tmp_path, data, init=init[0], num_epochs=1,
                       faults="nan_step=2", skip_budget=1)
    hist = ref.train()
    np.testing.assert_allclose(r0["hist"]["train"], hist["train"],
                               rtol=2e-5)


# --- (k) the command line -----------------------------------------------------

CLI_ARGS = ["-data", "synthetic", "-sN", "8", "-sT", "60", "-hidden", "8"]


def _port_cli(argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "-GPU", "cpu",
         *CLI_ARGS, *argv], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=timeout)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _pids(printed: str) -> list:
    return [int(line.split("pid ")[1]) for line in printed.splitlines()
            if line.startswith("[parallel] rank ")]


def _scores(out: str) -> dict:
    """The score file: mode -> {metric: value}."""
    rows = {}
    with open(os.path.join(out, "MPGCN_prediction_scores.txt")) as f:
        for line in f:
            cells = [c.strip() for c in line.split(",")]
            rows[cells[0]] = dict(zip(cells[1:5], map(float, cells[5:])))
    return rows


def test_cli_devices_2_trains_and_tests_as_jax(tmp_path):
    """Epoch 1 by the JAX CLI ``-devices 2``; both CLIs resume it for epoch
    2 (the port's on 2 ranks), then test their own checkpoint: the epoch
    events' losses rtol 1e-5, the score files rtol 1e-4."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    jax_cli.main([*CLI_ARGS, "-devices", "2", "-epoch", "1", "-out", ref])
    shutil.copytree(ref, port)
    for argv in (["-epoch", "2", "-resume"], ["-mode", "test"]):
        proc = _port_cli(["-devices", "2", *argv, "-out", port])
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert len(_pids(proc.stdout)) == 2
        assert all(_gone(p) for p in _pids(proc.stdout))
        jax_cli.main([*CLI_ARGS, "-devices", "2", *argv, "-out", ref])
    ours, theirs = _scores(port), _scores(ref)
    assert list(ours) == list(theirs) == ["train", "test"]
    for mode in ours:
        assert list(ours[mode]) == ["MSE", "RMSE", "MAE", "MAPE"]
        np.testing.assert_allclose(list(ours[mode].values()),
                                   list(theirs[mode].values()), rtol=1e-4,
                                   err_msg=mode)
    # the train runs' events (the port's test mode logs none)
    assert [e["event"] for e in events(port)] == \
        [e["event"] for e in events(ref) if e["event"] != "test"]
    epochs = [events(d, "epoch") for d in (port, ref)]
    assert [e["epoch"] for e in epochs[0]] == \
        [e["epoch"] for e in epochs[1]] == [1, 2]
    for key in ("train_loss", "validate_loss", "best_val"):
        np.testing.assert_allclose([e[key] for e in epochs[0]],
                                   [e[key] for e in epochs[1]], **LOSS_TOL,
                                   err_msg=key)
    mesh = [load_checkpoint(os.path.join(d, "MPGCN_od_last.pkl"))
            ["manifest"]["mesh"] for d in (port, ref)]
    assert mesh[0] == mesh[1] == {"data": 2, "model": 1}


def test_cli_stops_every_rank_when_one_dies(tmp_path):
    proc = _port_cli(["-devices", "2", "-epoch", "3", "-faults",
                      "kill_host_epoch=2", "-out", str(tmp_path)])
    assert proc.returncode == 128 + 9, proc.stdout[-2000:] + \
        proc.stderr[-2000:]
    assert "[parallel] rank 1 exited -9: stopping the others" in proc.stderr
    pids = _pids(proc.stdout)
    assert len(pids) == 2 and all(_gone(p) for p in pids)


@pytest.mark.parametrize("flag", ["-devices", "-mp", "-ckpt",
                                  "-consistency"])
def test_parallel_flags_match_jax(flag):
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("argv,match", [
    (["-mp", "0"], "-mp 0 is invalid"),
    (["-mp", "2", "-devices", "3"], "-devices 3 is not divisible by -mp 2")])
def test_cli_checks_the_mesh_before_loading_data(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["-GPU", "cpu", "-in", str(tmp_path / "missing"),
                  "-data", "npz", *argv, "-out", str(tmp_path)])


# --- (l) nn/gcn.py ------------------------------------------------------------


def test_gcn_matches_jax():
    rng = np.random.default_rng(0)
    G = rng.random((3, 6, 6)).astype(np.float32)
    x = rng.random((2, 6, 4)).astype(np.float32)
    mod = GCN(3, 4, 5, generator=torch.Generator().manual_seed(0))
    params = {"W": mod.W.detach().numpy(), "b": mod.b.detach().numpy()}
    ref = np.asarray(jax_gcn_apply(params, G, x, jax.nn.relu))
    got = gcn_apply({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(G), torch.from_numpy(x), torch.relu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(mod(torch.from_numpy(G), torch.from_numpy(x)),
                       gcn_apply({"W": mod.W, "b": mod.b},
                                 torch.from_numpy(G), torch.from_numpy(x)))
