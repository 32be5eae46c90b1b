"""The port's chunked-stream epoch executor and sparse host OD storage
against the JAX package on the CPU: the three-way dispatch
(``_epoch_exec``), the chunk budget and plan over a grid of budgets and
flags; two epochs on the stream executor against the scan and per-step
executors bit for bit and against the JAX stream executor (a shuffled
run at a cosine rate with the clip on); the chunk counters (at most two
chunks resident); a NaN window skipped by the step sentinels inside a
chunk; ``SparseODSeries`` / ``WindowView`` gathers byte for byte against
the dense views and the JAX ones; ``od_storage`` resolution; the
pipeline's chunks against the JAX pipeline's; the staging thread
retired on an early exit.

Sizes: N=8, hidden 8, synthetic_T=60 (34 training and 8 validation
windows), batch 4; chunk budgets that give chunks of 1 to 3 steps.
Tolerances are tests/test_torch_executor.py's against the JAX trainer:
losses rtol 1e-5, parameters rtol 1e-4 / atol 2e-6; everything inside
the port bit for bit."""

import os
import threading

import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.data.windows import SparseODSeries as JaxSeries
from mpgcn_tpu.data.windows import WindowView as JaxView
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.data.windows import (
    SparseODSeries,
    WindowView,
    sliding_windows,
)
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, H = 8, 8
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, seed=0)
INIT_SEED = 10  # tests/test_torch_executor.py's: both branches live
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
RUN = dict(pred_len=1, num_epochs=2, shuffle=True, lr_schedule="cosine",
           clip_norm=0.5)
#: every mode over the scan budget; chunks of 3 steps (34 windows at
#: batch 4: 9 train steps in 3 chunks; 8 validation windows: 1 chunk)
STREAM = dict(epoch_scan_max_mb=0.0, stream_chunk_mb=0.025)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(MPGCNConfig(**KW))


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("stream")
    pt = ModelTrainer(MPGCNConfig(pred_len=1, output_dir=str(out), **KW),
                      data, device="cpu")
    jt = JaxTrainer(JaxConfig(native_host="off", pred_len=1,
                              output_dir=str(out), **KW), data)
    return pt, jt


def _both(pair, **kw):
    pt, jt = pair
    pt.cfg = pt.cfg.replace(**kw)
    jt.cfg = jt.cfg.replace(**kw)
    return pt, jt


# --- the dispatch and the plan -----------------------------------------------


@pytest.mark.parametrize("batch_size", [4, 2])
@pytest.mark.parametrize("mode", ["train", "validate"])
@pytest.mark.parametrize("scan,stream", [(True, True), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("budget", ["below", "equal", "above"])
def test_epoch_exec_matches_jax(pair, batch_size, mode, scan, stream,
                                budget):
    pt, jt = _both(pair, batch_size=batch_size)
    mb = pt._mode_bytes(mode)
    limit = {"below": mb * (1 - 1e-9), "equal": mb, "above": 2 * mb}[budget]
    pt, jt = _both(pair, epoch_scan=scan, epoch_stream=stream,
                   epoch_scan_max_mb=limit)
    got = pt._epoch_exec(mode)
    assert got == jt._epoch_exec(mode)
    want = ("per_step" if not scan else "scan" if budget != "below"
            else "stream" if stream else "per_step")
    assert got == want


@pytest.mark.parametrize("scan_mb,chunk_mb", [(0.0, 0.0), (0.0, 0.025),
                                              (0.02, 0.0), (512.0, 0.05),
                                              (0.0, 1e9), (0.0, 1e-9)])
@pytest.mark.parametrize("batch_size", [4, 3])
def test_chunk_budget_and_plan_match_jax(pair, scan_mb, chunk_mb,
                                         batch_size):
    pt, jt = _both(pair, epoch_scan_max_mb=scan_mb, stream_chunk_mb=chunk_mb,
                   batch_size=batch_size)
    assert pt._chunk_budget_mb() == jt._chunk_budget_mb() > 0
    for mode in ("train", "validate", "test"):
        assert pt._stream_steps_per_chunk(mode) == \
            jt._stream_steps_per_chunk(mode) >= 1
        assert pt._stream_plan(mode) == jt._stream_plan(mode)


def test_stream_chunk_budget_checks_match_jax():
    for cls in (MPGCNConfig, JaxConfig):
        with pytest.raises(ValueError, match="stream_chunk_mb"):
            cls(stream_chunk_mb=-1.0)
        for name, bad in (("od_storage", "csr"), ("native_host", "on")):
            with pytest.raises(ValueError, match=name):
                cls(**{name: bad})
    ours, ref = MPGCNConfig(), JaxConfig()
    for name in ("fused_epilogue", "od_storage", "epoch_stream",
                 "stream_chunk_mb", "native_host"):
        assert getattr(ours, name) == getattr(ref, name), name


# --- two epochs on the three executors ---------------------------------------


def _trainer(cfg, data, out, init, **kw):
    tr = ModelTrainer(cfg.replace(output_dir=str(out), **kw), data,
                      device="cpu")
    tr.model.load_state_dict(init)
    return tr


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Two epochs of RUN from the JAX init at INIT_SEED: the port on its
    scan, stream (dense and sparse host storage) and per-step executors,
    and the JAX trainer on its stream executor."""
    out = {k: tmp_path_factory.mktemp(k)
           for k in ("scan", "stream", "sparse", "step", "jax")}
    cfg = MPGCNConfig(**{**KW, **RUN, "seed": INIT_SEED})
    jt = JaxTrainer(JaxConfig(native_host="off", output_dir=str(out["jax"]),
                              **{**KW, **RUN, **STREAM,
                                 "seed": INIT_SEED}), data)
    assert [jt._epoch_exec(m) for m in ("train", "validate")] == \
        ["stream"] * 2
    init = params_from_jax(_np(jt.params))
    res = {}
    for name, kw in (("scan", {}), ("stream", STREAM),
                     ("sparse", dict(STREAM, od_storage="sparse")),
                     ("step", dict(epoch_scan=False))):
        tr = _trainer(cfg, data, out[name], init, **kw)
        hist = tr.train()
        res[name] = (tr, hist, dict(tr._stream_stats))
    hist_j = jt.train()
    return dict(jt=jt, hist_j=hist_j, stats_j=dict(jt._stream_stats),
                init=init, **res)


def _same_state(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("other", ["scan", "step", "sparse"])
def test_stream_equals_the_other_executors_bitwise(runs, other):
    (ts, hs, _), (to, ho, _) = runs["stream"], runs[other]
    assert hs == ho  # epoch means, float for float
    _same_state(ts, to)
    steps = 2 * ts.pipeline.num_batches("train")
    assert ts.global_step == to.global_step == steps
    assert ts.optimizer.count == int(ts.optimizer.step_t) == steps
    for k, v in ts.model.state_dict().items():
        assert not torch.equal(v, runs["init"][k]), k


def test_stream_executor_matches_jax_stream_executor(runs):
    for mode in ("train", "validate"):
        np.testing.assert_allclose(runs["stream"][1][mode],
                                   runs["hist_j"][mode], **LOSS_TOL)
    final = params_from_jax(_np(runs["jt"].params))
    for k, v in runs["stream"][0].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k,
                                   **PARAM_TOL)


@pytest.mark.parametrize("name", ["stream", "sparse"])
def test_stream_counters_match_jax(runs, name):
    ours, ref = runs[name][2], runs["stats_j"]
    assert set(ours) == set(ref) == {"train", "validate"}
    for mode in ours:
        assert set(ours[mode]) == set(ref[mode])
        for k in ("chunks", "steps_per_chunk", "max_resident_chunks"):
            assert ours[mode][k] == ref[mode][k], (mode, k)
        assert ours[mode]["max_resident_chunks"] <= 2
        assert 0 <= ours[mode]["overlap_pct"] <= 100
    assert (ours["train"]["chunks"], ours["train"]["steps_per_chunk"]) == \
        (3, 3)


def test_run_log_records_the_stream(runs):
    from mpgcn_tpu_torch.utils.logging import read_events, run_log_path

    tr = runs["stream"][0]
    events = read_events(run_log_path(tr.cfg.output_dir, tr.cfg.model,
                                      True))
    start = next(e for e in events if e["event"] == "train_start")
    assert start["epoch_exec"] == {"train": "stream", "validate": "stream"}
    assert start["stream_plan"]["train"] == {"chunks": 3,
                                             "steps_per_chunk": 3}
    epochs = [e for e in events if e["event"] == "epoch"]
    assert len(epochs) == 2
    assert all(e["stream"]["train"]["max_resident_chunks"] <= 2
               for e in epochs)


def test_no_stream_runs_per_step(data, tmp_path, runs, capsys):
    tr = _trainer(MPGCNConfig(**{**KW, **RUN, "seed": INIT_SEED}), data,
                  tmp_path, runs["init"], epoch_stream=False, **STREAM)
    assert [tr._epoch_exec(m) for m in ("train", "validate")] == \
        ["per_step"] * 2
    assert tr.train() == runs["stream"][1]
    _same_state(tr, runs["stream"][0])
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("[dispatch] epoch_exec:"))
    assert line.startswith("[dispatch] epoch_exec: train=per_step, "
                           "validate=per_step")


def test_dispatch_line_in_the_jax_format(data, tmp_path, capsys):
    cfg = MPGCNConfig(pred_len=1, num_epochs=1, output_dir=str(tmp_path),
                      **KW, **STREAM)
    ModelTrainer(cfg, data, device="cpu").train()
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("[dispatch] epoch_exec:"))
    jt = JaxTrainer(JaxConfig(native_host="off", pred_len=1, num_epochs=1,
                              output_dir=str(tmp_path), **KW, **STREAM),
                    data)
    jt.train()
    ref = next(l for l in capsys.readouterr().out.splitlines()
               if l.startswith("[dispatch] epoch_exec:"))
    assert line.startswith(ref)
    assert ref.startswith("[dispatch] epoch_exec: train=stream(3 chunks x 3 "
                          "steps), validate=stream(1 chunks x 3 steps)")
    assert line.endswith("; stream steps: eager (cpu: CUDA graphs need the "
                         "card)")


def test_poisoned_window_skipped_inside_a_chunk(data, tmp_path):
    """NaN in one day of the series poisons the windows that read it; the
    step sentinels skip those steps inside the stream executor's chunks
    exactly as on the scan executor (losses, weights, Adam's state)."""
    bad = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in data.items()}
    bad["OD"][12] = np.nan  # train windows 5..12 read day 12 (x or y)
    cfg = MPGCNConfig(**{**KW, "pred_len": 1, "num_epochs": 1,
                         "skip_budget": 5, "nan_guard": True,
                         "seed": INIT_SEED})
    out = {}
    for name, kw in (("scan", {}), ("stream", STREAM)):
        tr = ModelTrainer(cfg.replace(output_dir=str(tmp_path / name), **kw),
                          bad, device="cpu")
        losses, sizes = tr._run_epoch("train", tr._epoch_exec("train"),
                                      np.random.default_rng(0))
        out[name] = (tr, losses)
    (ts, ls), (tm, lm) = out["scan"], out["stream"]
    assert tm._epoch_exec("train") == "stream"
    assert tm._stream_stats["train"]["chunks"] == 3
    skipped = np.flatnonzero(~np.isfinite(lm))
    # batch 4: windows 5..12 fall in steps 1-3, across the first two chunks
    np.testing.assert_array_equal(skipped, [1, 2, 3])
    np.testing.assert_array_equal(ls, lm)
    _same_state(ts, tm)


# --- sparse host storage -----------------------------------------------------


def _series(seed=0, T=40, n=6):
    rng = np.random.default_rng(seed)
    od = (rng.random((T, n, n, 1)) < 0.3) * rng.poisson(3.0, (T, n, n, 1))
    return od.astype(np.float32)


@pytest.mark.parametrize("obs,pred", [(7, 1), (7, 7), (3, 2)])
def test_window_view_matches_dense_views_and_jax(obs, pred):
    od = _series()
    x, y = sliding_windows(od, obs, pred)
    s, js = SparseODSeries.from_dense(od), JaxSeries.from_dense(od)
    assert s.nbytes == js.nbytes and s.density == js.density
    for base, a, length in ((0, x, obs), (obs, y, pred)):
        v = WindowView(s, base, a.shape[0], length)
        jv = JaxView(js, base, a.shape[0], length)
        assert v.shape == jv.shape == a.shape and len(v) == len(a)
        assert v.nbytes == jv.nbytes == a.nbytes
        for sel in (np.array([3, 0, -1, 3]), np.array([[1, 2], [5, 4]]),
                    np.arange(a.shape[0]) % 2 == 0, 2):
            want = a[sel]
            assert v[sel].tobytes() == want.tobytes() == jv[sel].tobytes()
            assert v[sel].shape == want.shape
        out = np.full((3,) + a.shape[1:], 7.0, np.float32)
        got = v.take(np.array([2, 1, 0]), out=out)
        assert np.shares_memory(got, out)
        assert out.tobytes() == a[[2, 1, 0]].tobytes()
        assert np.asarray(v).tobytes() == np.ascontiguousarray(a).tobytes()
        for bad in (a.shape[0], -a.shape[0] - 1):
            with pytest.raises(IndexError):
                v[np.array([bad])]
            with pytest.raises(IndexError):
                jv[np.array([bad])]


@pytest.mark.parametrize("storage", ["auto", "dense", "sparse"])
@pytest.mark.parametrize("n,density,min_nodes,threshold", [
    (8, 0.1, 256, 0.25), (8, 0.1, 4, 0.25), (8, 0.5, 4, 0.25),
    (8, 0.25, 8, 0.25), (8, 0.3, 8, 0.31)])
def test_od_storage_resolution_matches_jax(storage, n, density, min_nodes,
                                           threshold):
    rng = np.random.default_rng(3)
    od = (rng.random((40, n, n, 1)) < density).astype(np.float32)
    data = synthetic_dataset(MPGCNConfig(synthetic_T=40, synthetic_N=n))
    data = dict(data, OD=od)
    kw = dict(od_storage=storage, sparse_min_nodes=min_nodes,
              sparse_density_threshold=threshold, synthetic_T=40,
              synthetic_N=n, pred_len=1)
    ours = DataPipeline(MPGCNConfig(**kw), data, "cpu")
    ref = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    assert ours.od_storage == ref.od_storage
    for mode in ("train", "validate", "test"):
        a, b = ours.modes[mode], ref.modes[mode]
        assert type(a.x).__name__ == type(b.x).__name__
        assert a.x.nbytes == b.x.nbytes
        sel = np.arange(len(a))[::-1]
        assert a.x[sel].tobytes() == b.x[sel].tobytes()
        assert a.y[sel].tobytes() == b.y[sel].tobytes()


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_epoch_chunks_match_jax(data, storage):
    kw = dict(KW, pred_len=2, od_storage=storage)
    ours = DataPipeline(MPGCNConfig(**kw), data, "cpu")
    ref = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    rng = np.random.default_rng(4)
    idx = rng.permutation(33)[:32].reshape(8, 4).astype(np.int32)
    sizes = np.full(8, 4, np.int32)
    a = list(ours.stream_chunks("train", idx, sizes, 3))
    b = list(ref.epoch_chunks("train", idx, sizes, 3))
    assert len(a) == len(b) == 3
    for ca, cb in zip(a, b):
        assert ca.start_step == cb.start_step and ca.pinned == ()
        for f in ("x", "y", "keys", "sizes"):
            x, y = getattr(ca, f), getattr(cb, f)
            assert x.shape == y.shape and x.tobytes() == y.tobytes(), f


def test_stream_chunks_retire_their_thread_on_an_early_exit(data):
    pipe = DataPipeline(MPGCNConfig(**KW, pred_len=1), data, "cpu")
    idx = np.arange(32, dtype=np.int32).reshape(8, 4)
    before = threading.active_count()
    it = pipe.stream_chunks("train", idx, np.full(8, 4, np.int32), 1)
    next(it)
    it.close()
    deadline = 50
    while threading.active_count() > before and deadline:
        threading.Event().wait(0.1)
        deadline -= 1
    assert threading.active_count() == before

    def boom():
        yield 1
        raise OSError("gather failed")

    with pytest.raises(OSError, match="gather failed"):
        list(DataPipeline._threaded(boom(), 1))


def test_entry_points_default_to_the_card(data):
    """The pipeline and the trainer this slice extends run on the card
    unless asked for the CPU: without a card, the default raises."""
    if torch.cuda.is_available():
        assert DataPipeline(MPGCNConfig(**KW), data).device.type == "cuda"
        return
    cfg = MPGCNConfig(**KW, od_storage="sparse", **STREAM)
    for make in (lambda: DataPipeline(cfg, data),
                 lambda: ModelTrainer(cfg, data)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
