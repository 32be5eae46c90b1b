"""The port's model axis (mpgcn_tpu_torch/parallel/: ``-mp`` above 1, the
node-sharded training, eval and test, and ``halo.py``) against the JAX
package's, on the CPU. One launch of gloo ranks a world size (2 ranks: a
(1, 2) mesh; 4 ranks: (2, 2)), every scenario in that launch, as child
processes that import no JAX (tests/torch_model_axis_worker.py), each
world through a ``file://`` rendezvous under the test's tmp directory, one
torch thread a rank, a 60 s group timeout and a subprocess timeout. Both
worlds run while this process computes the JAX references.

  (a) the (dp, mp) grid: rank r at (r // mp, r % mp), its subgroups, the
      JAX errors (tests/test_parallel.py:26);
  (b) one train step on each world against the JAX
      ``ParallelModelTrainer(num_devices=8, model_parallel=2)`` step and
      the port's one-device step, from one JAX init: N = 8, ``grad_accum``
      2, multi-step (pred_len 2) and M = 3 (the dynamic branch): loss rtol
      1e-5, weights atol 2e-5 (:45, :232, :305, :325); bf16 + remat at
      N = 16 to the JAX tolerance (:253); N = 47, a padded origin block,
      against the JAX one-device step (the JAX mesh's ``device_put``
      refuses an origin axis of 47 over "model" 2: it does not pad);
  (c) the 'csr' arm, and the JAX routing of 'ell' at mp > 1;
  (d) the 3-step rollout gathered over both axes against the JAX mesh
      rollout at N = 8 (:84);
  (e) the scan and stream executors agree bit for bit, and equal the
      one-device trainer over 2 epochs; ``-consistency 1`` passes on
      every rank's replica;
  (f) test mode at N = 47 on each world writes the one-device scores,
      the port's and the JAX trainer's (:194); the dead-init probe reads
      the real origin rows only, and finds a dead head as one device does;
  (g) checkpoints resume across (dp, mp);
  (h) the CLI's ``-mp`` messages are the JAX CLI's, and ``-devices 2 -mp
      2`` trains and tests at N = 47 to the one-device scores;
  (i) ``build_halo_plan`` is byte for byte the JAX plan; ``halo_spmm`` on 2
      and 4 ranks equals the JAX ``halo_spmm`` on a mesh of as many
      virtual devices and the dense product, forward and gradient, csr
      and ell local arms, overlap on and off, quantized on and off, and
      on the zero-traffic operator (tests/test_sparse.py:405,
      test_overlap.py:47-97, test_quantized_sparse.py:185-253); the
      ``sparse_halo_bytes`` gauge and the traffic model.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.parallel import ParallelModelTrainer as JaxParallel
from mpgcn_tpu.parallel import halo as jax_halo
from mpgcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpgcn_tpu.sparse.formats import csr_from_dense as jax_csr
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu.utils import flops as jax_flops
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.obs.metrics import default_registry
from mpgcn_tpu_torch.parallel import (
    Mesh,
    ParallelModelTrainer,
    build_halo_plan,
    halo_spmm,
)
from mpgcn_tpu_torch.sparse.formats import csr_from_dense
from mpgcn_tpu_torch.train.checkpoint import load_checkpoint
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils import flops
from mpgcn_tpu_torch.utils.convert import params_from_jax
from tests.torch_heal_common import events, np_tree

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_model_axis_worker.py")
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(atol=2e-5, rtol=0)
INIT_SEED = 10
BASE = dict(synthetic_T=50, synthetic_N=8, obs_len=7, pred_len=1,
            batch_size=8, hidden_dim=8, learn_rate=1e-3, seed=INIT_SEED)
CONFIGS = {
    "n8": BASE,
    "n47": {**BASE, "synthetic_N": 47},
    "three": {**BASE, "num_branches": 3},
    "bf16": {**BASE, "synthetic_N": 16, "hidden_dim": 16, "remat": True,
             "dtype": "bfloat16"},
}
#: step scenario -> (its config, the config fields it changes)
STEPS = {"step8": ("n8", {}), "step47": ("n47", {}),
         "accum": ("n8", dict(batch_size=16, grad_accum=2)),
         "multistep": ("n8", dict(pred_len=2)), "three": ("three", {})}
SCENARIOS = ("mesh", *STEPS, "bf16", "csr", "rollout", "scan", "stream",
             "test", "dead47", "resume", "halo")
WORLDS = {2: 2, 4: 2}  # world -> mp
HALO_CASES = [(impl, ov, q) for impl in ("csr", "ell")
              for ov in (False, True) for q in (False, True)]


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "MPGCN_FAULTS"):
        env.pop(k, None)
    return env


def _data(name: str) -> dict:
    return synthetic_dataset(MPGCNConfig(**CONFIGS[name]))


def _jax_cfg(out, name: str, **kw) -> JaxConfig:
    return JaxConfig(output_dir=str(out), native_host="off", donate=False,
                     **{**CONFIGS[name], **kw})


class World:
    """One launch of ``world`` ranks; ``load(name)`` waits for it once,
    then reads each rank's findings of scenario ``name``."""

    def __init__(self, out, world: int, spec: dict, timeout: int = 600):
        self.out, self.world, self.timeout = out, world, timeout
        os.makedirs(out, exist_ok=True)
        spec = {**spec, "init": f"file://{out}/rendezvous", "world": world,
                "mp": WORLDS[world], "out": str(out),
                "scenarios": list(SCENARIOS), "timeout_s": 60}
        with open(os.path.join(out, "spec.json"), "w") as f:
            json.dump(spec, f)
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, os.path.join(out, "spec.json"), str(r)],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.logs = None

    def wait(self):
        if self.logs is not None:
            return
        self.logs = []
        try:
            for p in self.procs:
                self.logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    def load(self, name: str) -> list:
        self.wait()
        assert [p.returncode for p in self.procs] == [0] * self.world, \
            "\n".join(x[-3000:] for x in self.logs)
        return [torch.load(os.path.join(self.out, name, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def _banded(K, N, rng, width=2, extra=0.02):
    """The JAX halo tests' banded operator (a few long-range edges, one
    empty row)."""
    i = np.arange(N)
    d = np.abs(i[:, None] - i[None, :])
    d = np.minimum(d, N - d)
    mask = (d <= width) & (d > 0)
    mask |= rng.random((N, N)) < extra
    G = (rng.normal(size=(K, N, N)) * mask).astype(np.float32)
    G[:, 5 % N, :] = 0.0
    return G


def _blockdiag(K, N, P, rng):
    G = np.zeros((K, N, N), np.float32)
    blk = N // P
    for s in range(P):
        sl = slice(s * blk, (s + 1) * blk)
        G[:, sl, sl] = rng.normal(size=(K, blk, blk))
    return G


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX mesh trainers of every config, their inits as the port's
    state_dict files, the 1-rank checkpoint the worlds resume from, the
    halo operators; then both worlds, launched (they run while the tests
    compute the JAX references)."""
    root = tmp_path_factory.mktemp("model_axis")
    datas = {name: _data(name) for name in CONFIGS}
    jax_par, inits = {}, {}
    for name in CONFIGS:
        jax_par[name] = _jax_ref(root / f"jax_{name}", name, datas[name])
        inits[name] = str(root / f"init_{name}.pt")
        torch.save(params_from_jax(np_tree(jax_par[name].params)),
                   inits[name])
    rng = np.random.default_rng(15)
    ops = {"banded_G": _banded(3, 32, rng),
           "banded_X": rng.normal(size=(32, 6)).astype(np.float32),
           "blockdiag_G": _blockdiag(2, 32, 4, rng),
           "blockdiag_X": rng.normal(size=(32, 4)).astype(np.float32)}
    np.savez(root / "halo.npz", **ops)
    one = _port(root / "resume_1rank", "n47", inits, num_epochs=1)
    one.train()
    worlds = {}
    for world in WORLDS:
        out = root / f"world{world}"
        shutil.copytree(root / "resume_1rank", out / "resume")
        worlds[world] = World(out, world, {
            "configs": CONFIGS, "inits": inits,
            "halo": str(root / "halo.npz")})
    return {"root": root, "data": datas, "jax": jax_par, "inits": inits,
            "ops": ops, "worlds": worlds}


def _jax_ref(out, name: str, data, **kw):
    """The JAX reference of a config: the (4, 2) mesh trainer; at N = 47
    the one-device trainer (the mesh refuses 47 origins over 2)."""
    cfg = _jax_cfg(out, name, **kw)
    if cfg.synthetic_N % 2:
        return JaxTrainer(cfg, data)
    return JaxParallel(cfg, data, num_devices=8, model_parallel=2)


def _port(out, name: str, inits: dict, data=None, init: bool = True,
          bdgcn_impl: str = "auto", **kw) -> ModelTrainer:
    """The port's one-device trainer on the CPU from the JAX init."""
    tr = ModelTrainer(MPGCNConfig(output_dir=str(out),
                                  **{**CONFIGS[name], **kw}),
                      data if data is not None else _data(name),
                      device="cpu", bdgcn_impl=bdgcn_impl)
    if init:
        tr.model.load_state_dict(torch.load(inits[name]))
    return tr


def _params(tr) -> dict:
    return {k: v.detach() for k, v in tr.model.state_dict().items()}


def _same_replicas(found: list) -> None:
    keys = [k for k in found[0] if k.startswith(("p:", "o:"))]
    assert keys
    for other in found[1:]:
        for k in keys:
            assert torch.equal(found[0][k], other[k]), k


def _close_params(got: dict, ref: dict, tol=PARAM_TOL) -> None:
    for k, v in ref.items():
        np.testing.assert_allclose(got[f"p:{k}"].numpy(), np.asarray(v),
                                   **tol, err_msg=k)


def _put(jt, a, kind):
    if isinstance(jt, JaxParallel):
        return jt._device_batch(a, kind)
    return jnp.asarray(a)


def _jax_step(jt, batch):
    """One train step of a JAX reference (``_jax_ref``)."""
    p, _, loss = jt._train_step(
        jt.params, jt.opt_state, jt.banks, _put(jt, batch.x, "x"),
        _put(jt, batch.y, "x"), _put(jt, batch.keys, "keys"), batch.size)
    return float(loss), params_from_jax(np_tree(p))


# --- (a) the grid --------------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_grid_and_subgroups(setup, world):
    mp = WORLDS[world]
    dp = world // mp
    for r, found in enumerate(setup["worlds"][world].load("mesh")):
        assert found["shape"] == {"data": dp, "model": mp}
        assert found["index"] == (r // mp, r % mp)
        assert found["groups"] == [mp, dp if dp > 1 else None]
        assert found["(8, 1)"] == (f"ValueError: requested 8 devices, only "
                                   f"{world} visible")
        assert found[f"({world}, 3)"] == (
            f"ValueError: num_devices {world} not divisible by "
            f"model_parallel 3")
    jm = jax_make_mesh(8, model_parallel=2)
    assert dict(jm.shape) == {"data": 4, "model": 2}


# --- (b) one step ----------------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("scenario", list(STEPS))
def test_step_equals_jax_mesh_and_one_device(setup, tmp_path, scenario,
                                             world):
    name, kw = STEPS[scenario]
    par = setup["jax"][name]
    if kw:
        par = _jax_ref(tmp_path / "jax", name, setup["data"][name], **kw)
    assert getattr(par, "shard_nodes", name == "n47")
    batch = next(par.pipeline.batches("train", pad_to_full=True))
    jloss, jparams = _jax_step(par, batch)
    one = {k: v for k, v in kw.items() if k != "grad_accum"}
    tr = _port(tmp_path / "port", name, setup["inits"],
               setup["data"][name], **one)
    loss = tr.train_step(batch)
    found = setup["worlds"][world].load(scenario)
    _same_replicas(found)
    assert len({f["loss"] for f in found}) == 1
    np.testing.assert_allclose(found[0]["loss"], jloss, **LOSS_TOL)
    np.testing.assert_allclose(found[0]["loss"], loss, **LOSS_TOL)
    _close_params(found[0], jparams)
    _close_params(found[0], _params(tr))


@pytest.mark.parametrize("world", list(WORLDS))
def test_bf16_remat_step_on_the_model_axis(setup, world):
    """bf16 compute + remat at N = 16 (JAX :253): the loss to the JAX mesh
    step at the JAX test's tolerance, finite weights."""
    par = setup["jax"]["bf16"]
    batch = next(par.pipeline.batches("train", pad_to_full=True))
    jloss, _ = _jax_step(par, batch)
    found = setup["worlds"][world].load("bf16")
    _same_replicas(found)
    np.testing.assert_allclose(found[0]["loss"], jloss, rtol=5e-2)
    assert all(bool(v.isfinite().all()) for k, v in found[0].items()
               if k.startswith("p:"))


# --- (c) the sparse arms ------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_csr_arm_on_the_model_axis(setup, tmp_path, world):
    tr = _port(tmp_path, "n8", setup["inits"], setup["data"]["n8"],
               bdgcn_impl="csr")
    loss = tr.train_step(next(tr.pipeline.batches("train",
                                                  pad_to_full=True)))
    found = setup["worlds"][world].load("csr")
    assert found[0]["impl"] == "csr"
    _same_replicas(found)
    np.testing.assert_allclose(found[0]["loss"], loss, **LOSS_TOL)
    _close_params(found[0], _params(tr))


def test_ell_routes_to_csr_on_a_model_axis(setup, tmp_path):
    """'auto' that resolves to 'ell' runs 'csr' at mp > 1; a forced 'ell'
    is refused with the JAX message (mpgcn_tpu/parallel/trainer.py:327)."""
    mesh = Mesh({"data": 1, "model": 2}, 0, 2, torch.device("cpu"))
    sparse = dict(sparse_min_nodes=1, sparse_density_threshold=1.0)
    cfg = MPGCNConfig(output_dir=str(tmp_path), **{**BASE, **sparse})
    tr = ParallelModelTrainer(cfg, setup["data"]["n8"], mesh=mesh)
    assert tr.bdgcn_impl == "csr" and tr.pipeline.requested_impl == "auto"
    one = ModelTrainer(cfg, setup["data"]["n8"], device="cpu")
    assert one.bdgcn_impl == "ell"
    with pytest.raises(ValueError, match="GSPMD") as ours:
        ParallelModelTrainer(cfg, setup["data"]["n8"], mesh=mesh,
                             bdgcn_impl="ell")
    with pytest.raises(ValueError, match="GSPMD") as ref:
        JaxParallel(_jax_cfg(tmp_path / "jax", "n8", bdgcn_impl="ell"),
                    setup["data"]["n8"], num_devices=2, model_parallel=2)
    assert str(ours.value) == str(ref.value)


# --- (d) the rollout -------------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_rollout_gathers_to_the_jax_mesh_rollout(setup, tmp_path, world):
    par = setup["jax"]["n8"]
    batch = next(par.pipeline.batches("test", pad_to_full=True))
    ref = np.asarray(par._rollout(par.params, par.banks,
                                  par._device_batch(batch.x, "x"),
                                  par._device_batch(batch.keys, "keys"), 3))
    found = setup["worlds"][world].load("rollout")
    assert all(np.array_equal(f["pred"], found[0]["pred"]) for f in found)
    assert found[0]["pred"].shape == ref.shape == (8, 3, 8, 8, 1)
    np.testing.assert_allclose(found[0]["pred"], ref, atol=2e-5)
    one = _port(tmp_path, "n8", setup["inits"], setup["data"]["n8"])
    np.testing.assert_allclose(found[0]["pred"],
                               one.predict(batch.x, batch.keys, 3),
                               atol=2e-5)


# --- (e) the executors -------------------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_scan_and_stream_agree_and_equal_one_device(setup, tmp_path, world):
    scan = setup["worlds"][world].load("scan")
    stream = setup["worlds"][world].load("stream")
    assert [scan[0]["exec"], stream[0]["exec"]] == ["scan", "stream"]
    assert scan[0]["refusal"].startswith("cpu")
    for found in (scan, stream):
        _same_replicas(found)
    assert scan[0]["hist"] == stream[0]["hist"]
    _same_replicas([scan[0], stream[0]])
    # -consistency 1 digested every rank's replica after both epochs
    out = setup["worlds"][world].out / "scan"
    assert [e["epoch"] for e in events(out, "consistency_ok")] == [1, 2]
    ref = _port(tmp_path, "n47", setup["inits"], setup["data"]["n47"],
                num_epochs=2)
    hist = ref.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(scan[0]["hist"][mode], hist[mode],
                                   rtol=2e-5)
    _close_params(scan[0], _params(ref), dict(atol=3e-5, rtol=0))


# --- (f) test mode ---------------------------------------------------------------


def _scores_close(got: dict, ref: dict) -> None:
    for mode in ("train", "test"):
        for k in ("MSE", "RMSE", "MAE", "MAPE"):
            np.testing.assert_allclose(got[mode][k], ref[mode][k],
                                       rtol=1e-4, err_msg=f"{mode} {k}")


@pytest.mark.parametrize("world", list(WORLDS))
def test_test_mode_writes_the_one_device_scores(setup, tmp_path, world):
    w = setup["worlds"][world]
    found = w.load("test")
    assert all(f["results"] == found[0]["results"] for f in found)
    rows = (w.out / "test" / "MPGCN_prediction_scores.txt").read_text()
    assert [line.split(",")[0] for line in rows.splitlines()] == \
        ["train", "test"]  # rank 0 alone wrote
    shutil.copy(w.out / "test" / "MPGCN_od.pkl", tmp_path / "MPGCN_od.pkl")
    ref = _port(tmp_path, "n47", setup["inits"], setup["data"]["n47"],
                init=False, pred_len=3).test()
    _scores_close(found[0]["results"], ref)
    if world == 2:  # and the JAX trainer's test mode on that checkpoint
        jdir = tmp_path / "jax"
        jdir.mkdir()
        shutil.copy(w.out / "test" / "MPGCN_od.pkl", jdir / "MPGCN_od.pkl")
        jres = _jax_ref(jdir, "n47", setup["data"]["n47"], pred_len=3,
                        mode="test").test()
        _scores_close(found[0]["results"], jres)


@pytest.mark.parametrize("world", list(WORLDS))
def test_dead_init_probe_reads_real_origins_only(setup, tmp_path, world):
    """A dead head at N = 47 on -mp 2: the probe finds the dead init on
    every rank, as one device does, though the padded row of the second
    origin block forecasts nonzero (the biases alone reach it)."""
    found = setup["worlds"][world].load("dead47")
    assert [(f["n_loc"], f["real"]) for f in found] == \
        [(24, 24), (24, 23)] * (world // 2)
    assert [f["dead"] for f in found] == [True] * world
    out = setup["worlds"][world].out / "dead47"
    assert [e["epoch"] for e in events(out, "dead_init")] == [1]
    one = _port(tmp_path, "n47", setup["inits"], setup["data"]["n47"],
                num_epochs=1, on_dead_init="warn")
    with torch.no_grad():
        for br in one.model.branches:
            for p in br.fc.parameters():
                p.copy_(-p.abs() - 0.1)
    one.train()
    assert one._dead_init_detected


# --- (g) resume across (dp, mp) ----------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_checkpoints_resume_across_meshes(setup, tmp_path, world):
    w = setup["worlds"][world]
    # 1 rank -> this mesh: against the same checkpoint resumed on 1 rank
    found = w.load("resume")
    _same_replicas(found)
    shutil.copytree(setup["root"] / "resume_1rank", tmp_path / "one")
    one = _port(tmp_path / "one", "n47", setup["inits"],
                setup["data"]["n47"], init=False, num_epochs=2)
    h1 = one.train(resume=True)
    assert len(found[0]["hist"]["train"]) == 1
    np.testing.assert_allclose(found[0]["hist"]["train"], h1["train"],
                               rtol=1e-5)
    _close_params(found[0], _params(one))
    # this mesh -> 1 rank: its 2-epoch scan checkpoint, epoch 3 on one
    # device, against 3 epochs straight
    w.load("scan")
    ckpt = load_checkpoint(str(w.out / "scan" / "MPGCN_od_last.pkl"))
    mp = WORLDS[world]
    assert ckpt["epoch"] == 2
    assert ckpt["manifest"]["mesh"] == {"data": world // mp, "model": mp}
    assert ckpt["manifest"]["process_count"] == world
    shutil.copytree(w.out / "scan", tmp_path / "on1")
    tr = _port(tmp_path / "on1", "n47", setup["inits"], setup["data"]["n47"],
               init=False, num_epochs=3)
    hist = tr.train(resume=True)
    straight = _port(tmp_path / "straight", "n47", setup["inits"],
                     setup["data"]["n47"], num_epochs=3).train()
    np.testing.assert_allclose(hist["train"], straight["train"][2:],
                               rtol=2e-5)


# --- (h) the command line ----------------------------------------------------


@pytest.mark.parametrize("argv", [["-mp", "0"], ["-mp", "2"],
                                  ["-devices", "3", "-mp", "2"],
                                  ["-devices", "4", "-mp", "3"]])
def test_cli_mp_messages_match_jax(tmp_path, argv):
    args = ["-in", str(tmp_path / "missing"), "-data", "npz", *argv,
            "-out", str(tmp_path)]
    with pytest.raises(SystemExit) as ours:
        cli.main(["-GPU", "cpu", *args])
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(args)
    assert str(ours.value) == str(ref.value)


def _scores_file(out) -> dict:
    rows = {}
    with open(os.path.join(out, "MPGCN_prediction_scores.txt")) as f:
        for line in f:
            cells = [c.strip() for c in line.split(",")]
            rows[cells[0]] = [float(v) for v in cells[5:]]
    return rows


def test_cli_devices_2_mp_2_trains_and_tests_as_one_device(tmp_path):
    """``-devices 2 -mp 2`` at N = 47 (a padded origin block): 1 epoch,
    then test mode; the scores equal the one-device test of the same
    checkpoint (the training steps are held to one device's above)."""
    args = ["-GPU", "cpu", "-data", "synthetic", "-sN", "47", "-sT", "60",
            "-hidden", "8"]
    mp, one = tmp_path / "mp", tmp_path / "one"
    for argv in (["-epoch", "1"], ["-mode", "test"]):
        proc = subprocess.run(
            [sys.executable, "-m", "mpgcn_tpu_torch.cli", *args, "-devices",
             "2", "-mp", "2", *argv, "-out", str(mp)], env=_env(), cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    shutil.copytree(mp, one)
    os.remove(one / "MPGCN_prediction_scores.txt")
    cli.main([*args, "-mode", "test", "-out", str(one)])
    ours, ref = _scores_file(mp), _scores_file(one)
    assert list(ours) == ["train", "test"]
    for mode in ours:
        np.testing.assert_allclose(ours[mode], ref[mode], rtol=1e-4,
                                   err_msg=mode)
    assert [e["epoch"] for e in events(mp, "epoch")] == [1]
    manifest = load_checkpoint(str(mp / "MPGCN_od.pkl"))["manifest"]
    assert manifest["mesh"] == {"data": 1, "model": 2}


# --- (i) the halo SpMM ---------------------------------------------------------


def _plans(G, P, impl):
    return (build_halo_plan(csr_from_dense(G), P, bucket=1, local_impl=impl),
            jax_halo.build_halo_plan(jax_csr(G), P, bucket=1,
                                     local_impl=impl))


@pytest.mark.parametrize("impl", ["csr", "ell"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("op", ["banded", "blockdiag"])
def test_halo_plan_is_byte_identical_to_jax(setup, op, P, impl):
    ours, ref = _plans(setup["ops"][f"{op}_G"], P, impl)
    assert (ours.n_shards, ours.n_loc, ours.halo_cols) == \
        (ref.n_shards, ref.n_loc, ref.halo_cols)
    pairs = [(getattr(ours, k), getattr(ref, k)) for k in (
        "local_indices", "local_values", "own_indices", "own_values",
        "halo_indices", "halo_values")]
    assert [r for r, _ in ours.send_rounds] == \
        [r for r, _ in ref.send_rounds]
    pairs += [(a, b) for (_, a), (_, b) in zip(ours.send_rounds,
                                               ref.send_rounds)]
    if impl == "ell":
        for mine, theirs in ((ours.ell_own, ref.ell_own),
                             (ours.ell_halo, ref.ell_halo)):
            assert mine.n_cols == theirs[2]
            pairs += [(mine.block_cols, theirs[0]), (mine.blocks, theirs[1])]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("world", list(WORLDS))
def test_halo_spmm_matches_jax_and_dense(setup, world):
    found = setup["worlds"][world].load("halo")
    mesh = jax_make_mesh(world)
    for op in ("banded", "blockdiag"):
        G, X = setup["ops"][f"{op}_G"], setup["ops"][f"{op}_X"]
        dense = np.einsum("knm,mf->knf", G, X)
        dense_g = 2 * np.einsum("knm,knf->mf", G, dense)
        cols = found[0][(op, "halo_cols")]
        assert (cols > 0) == (op == "banded")
        for impl, ov, q in HALO_CASES:
            out = np.concatenate([f[(op, impl, ov, q)][0] for f in found], 1)
            grad = np.concatenate([f[(op, impl, ov, q)][1] for f in found])
            jplan = jax_halo.build_halo_plan(jax_csr(G), world, bucket=1,
                                             local_impl=impl)

            def jfn(x):
                return jax_halo.halo_spmm(jplan, x, mesh=mesh, overlap=ov,
                                          local_impl=impl, quantized=q)

            @jax.jit
            def fwd_grad(x):  # the output and the grad of its sum of squares
                out, vjp = jax.vjp(jfn, x)
                return out, vjp(2 * out)[0]

            jout, jgrad = (np.asarray(a) for a in fwd_grad(jnp.asarray(X)))
            case = f"{op} {impl} overlap={ov} quantized={q}"
            np.testing.assert_allclose(out, jout, rtol=2e-5, atol=1e-5,
                                       err_msg=case)
            np.testing.assert_allclose(grad, jgrad, rtol=2e-4, atol=1e-4,
                                       err_msg=case)
            if q and cols:
                assert _rel_err(out, dense) < 0.01, case
                assert _rel_err(grad, dense_g) < 0.03, case
            else:
                np.testing.assert_allclose(out, dense, rtol=2e-5, atol=1e-5,
                                           err_msg=case)
                np.testing.assert_allclose(grad, dense_g, rtol=2e-4,
                                           atol=1e-4, err_msg=case)
            if not cols:  # nothing on the wire: quantized is bitwise
                assert np.array_equal(
                    out, np.concatenate([f[(op, impl, ov, False)][0]
                                         for f in found], 1))


def test_halo_gauge_and_traffic_model(setup):
    G = setup["ops"]["banded_G"]
    plan = build_halo_plan(csr_from_dense(G), 4, bucket=1, feature_width=6)
    assert default_registry().snapshot()["mpgcn_sparse_halo_bytes"] == \
        flops.halo_exchange_bytes(plan.halo_cols, 4, 6) > 0
    for args in [(16, 8, 64, 4), (plan.halo_cols, 4, 6, 2)]:
        assert flops.halo_exchange_bytes(*args) == \
            jax_flops.halo_exchange_bytes(*args)
    assert flops.quantized_halo_bytes(16, 8, 64, 2) == \
        jax_flops.quantized_halo_bytes(16, 8, 64, 2) == 8 * 16 * 64 + 64


def test_halo_validation_matches_jax(setup):
    G = setup["ops"]["banded_G"]
    for build in (build_halo_plan, jax_halo.build_halo_plan):
        with pytest.raises(ValueError, match="divisible"):
            build((csr_from_dense if build is build_halo_plan
                   else jax_csr)(G[:, :30, :30]), 4)
    plan = build_halo_plan(csr_from_dense(G), 2)
    with pytest.raises(ValueError, match="plan was built for 2 shards but "
                                         "the mesh has 1 devices"):
        halo_spmm(plan, torch.zeros(16, 6))
    with pytest.raises(ValueError, match="no blocked-ELL split"):
        halo_spmm(build_halo_plan(csr_from_dense(G), 1),
                  torch.zeros(32, 6), local_impl="ell")
    with pytest.raises(ValueError, match="unknown local_impl"):
        build_halo_plan(csr_from_dense(G), 2, local_impl="coo")
    one = build_halo_plan(csr_from_dense(G), 1, local_impl="ell")
    x = torch.from_numpy(setup["ops"]["banded_X"])
    np.testing.assert_allclose(
        halo_spmm(one, x, local_impl="ell").numpy(),
        np.einsum("knm,mf->knf", G, x.numpy()), rtol=2e-5, atol=1e-5)
