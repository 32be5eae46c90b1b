"""The port's epoch executor against the JAX trainer's on the CPU: the
dispatch (``_mode_bytes``, ``_epoch_exec``) over cases that straddle the
budget, the epoch index, and two epochs on the scan executor against the
port's per-step path (bit for bit) and against the JAX trainer with its
default ``epoch_scan=True`` (a shuffled run at a cosine rate with the
clip on, so the epoch index, the rate table on the device and the clip
all take part); the rate table against ``lr_at``; the graph set's
refusals and the launch tally's rule.

Sizes: N=8, hidden 8, synthetic_T=60 (34 training and 8 validation
windows), batch 4 or 2. Tolerances are those of
tests/test_torch_train.py's ``test_two_epochs_match_jax_trainer``:
losses rtol 1e-5, parameters rtol 1e-4 / atol 2e-6."""

import os

import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.native import build
from mpgcn_tpu_torch.service.serve import ServeEngine
from mpgcn_tpu_torch.train.graphs import GraphSet, refusal
from mpgcn_tpu_torch.train.objectives import lr_at, make_optimizer
from mpgcn_tpu_torch.train.trainer import ModelTrainer, epoch_mean
from mpgcn_tpu_torch.utils.convert import params_from_jax

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, H = 8, 8
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, seed=0)
#: the JAX init seed that leaves both branches live at these widths
#: (tests/test_torch_train.py INIT_SEED)
INIT_SEED = 10
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
#: the run held against the JAX trainer: shuffled, cosine rate, clip on
RUN = dict(pred_len=1, num_epochs=2, shuffle=True, lr_schedule="cosine",
           clip_norm=0.5)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(MPGCNConfig(**KW))


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    """A port trainer and a JAX trainer over the same data (batch 4)."""
    out = tmp_path_factory.mktemp("exec")
    pt = ModelTrainer(MPGCNConfig(pred_len=1, output_dir=str(out), **KW),
                      data, device="cpu")
    jt = JaxTrainer(JaxConfig(native_host="off", pred_len=1,
                              output_dir=str(out), **KW), data)
    return pt, jt


@pytest.mark.parametrize("batch_size", [4, 2])
@pytest.mark.parametrize("mode", ["train", "validate"])
@pytest.mark.parametrize("scan,budget", [(True, "below"), (True, "equal"),
                                         (True, "above"), (False, "above")])
def test_mode_bytes_and_epoch_exec_match_jax(pair, batch_size, mode, scan,
                                             budget):
    """34 training windows: a multiple of batch 2, not of batch 4; the
    budget just below the mode's bytes, at them and above them (the
    stream executor off on both sides: tests/test_torch_stream.py holds
    the three-way dispatch)."""
    pt, jt = pair
    pt.cfg = pt.cfg.replace(batch_size=batch_size, epoch_stream=False)
    jt.cfg = jt.cfg.replace(batch_size=batch_size, epoch_stream=False)
    mb = pt._mode_bytes(mode)
    assert mb == jt._mode_bytes(mode) > 0
    limit = {"below": mb * (1 - 1e-9), "equal": mb, "above": 2 * mb}[budget]
    pt.cfg = pt.cfg.replace(epoch_scan=scan, epoch_scan_max_mb=limit)
    jt.cfg = jt.cfg.replace(epoch_scan=scan, epoch_scan_max_mb=limit)
    got = pt._epoch_exec(mode)
    assert got == jt._epoch_exec(mode)
    assert got == ("scan" if scan and budget != "below" else "per_step")


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("mode,batch_size", [("train", 4), ("train", 2),
                                             ("validate", 4)])
def test_epoch_index_matches_jax(pair, shuffle, mode, batch_size):
    pt, jt = pair
    pt.cfg = pt.cfg.replace(batch_size=batch_size)
    jt.cfg = jt.cfg.replace(batch_size=batch_size)
    idx, sizes = pt._epoch_index(mode, shuffle, np.random.default_rng(3))
    ref = jt._epoch_index(mode, shuffle, np.random.default_rng(3))
    np.testing.assert_array_equal(idx, ref[0])
    np.testing.assert_array_equal(sizes, ref[1])
    assert idx.dtype == ref[0].dtype and sizes.dtype == ref[1].dtype
    # the same rows, in the same order, as the per-step batches
    batches = list(pt.pipeline.batches(mode, batch_size=batch_size,
                                       shuffle=shuffle,
                                       rng=np.random.default_rng(3),
                                       pad_to_full=True))
    md = pt.pipeline.modes[mode]
    for b, row, size in zip(batches, idx, sizes):
        np.testing.assert_array_equal(b.x, md.x[row])
        assert b.size == size


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Two epochs of ``RUN`` from the JAX init at INIT_SEED: the port on
    its scan executor and on its per-step executor, and the JAX trainer
    on its defaults (the epoch scan)."""
    out = {k: tmp_path_factory.mktemp(k) for k in ("scan", "step", "jax")}
    cfg = MPGCNConfig(**{**KW, **RUN, "seed": INIT_SEED})
    jt = JaxTrainer(JaxConfig(native_host="off", output_dir=str(out["jax"]),
                              **{**KW, **RUN, "seed": INIT_SEED}), data)
    assert jt.cfg.epoch_scan
    assert [jt._epoch_exec(m) for m in ("train", "validate")] == ["scan"] * 2
    init = params_from_jax(_np(jt.params))
    res = {}
    for name, scan in (("scan", True), ("step", False)):
        tr = ModelTrainer(cfg.replace(epoch_scan=scan,
                                      output_dir=str(out[name])), data,
                          device="cpu")
        tr.model.load_state_dict(init)
        res[name] = (tr, tr.train())
    return dict(jt=jt, hist_j=jt.train(), init=init, **res)


def test_scan_executor_equals_per_step_bitwise(runs):
    (ts, hs), (tp, hp) = runs["scan"], runs["step"]
    assert hs == hp  # epoch means, float for float
    for (k, a), b in zip(ts.model.state_dict().items(),
                         tp.model.state_dict().values()):
        assert torch.equal(a, b), k
        assert not torch.equal(a, runs["init"][k]), k
    for sa, sb in zip(ts.optimizer.state.values(),
                      tp.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    steps = 2 * ts.pipeline.num_batches("train")
    assert ts.global_step == tp.global_step == steps
    assert ts.optimizer.count == int(ts.optimizer.step_t) == steps
    assert tp.optimizer.count == int(tp.optimizer.step_t) == steps


def test_scan_executor_matches_jax_trainer(runs):
    for mode in ("train", "validate"):
        np.testing.assert_allclose(runs["scan"][1][mode],
                                   runs["hist_j"][mode], **LOSS_TOL)
    final = params_from_jax(_np(runs["jt"].params))
    for k, v in runs["scan"][0].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_dispatch_line_in_the_jax_format(data, tmp_path, capsys):
    """The port's ``[dispatch] epoch_exec:`` line opens as the JAX
    trainer's does; over the budget a mode runs on the stream executor,
    and says so."""
    cfg = MPGCNConfig(pred_len=1, num_epochs=1, output_dir=str(tmp_path),
                      **KW)
    ModelTrainer(cfg, data, device="cpu").train()
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("[dispatch] epoch_exec:"))
    assert line.startswith("[dispatch] epoch_exec: train=scan, "
                           "validate=scan (epoch_scan_max_mb=512.0")
    assert "scan steps: eager (cpu" in line
    jt = JaxTrainer(JaxConfig(native_host="off", pred_len=1, num_epochs=1,
                              output_dir=str(tmp_path), **KW), data)
    jt.train()
    ref = next(l for l in capsys.readouterr().out.splitlines()
               if l.startswith("[dispatch] epoch_exec:"))
    assert ref.startswith(line.split(")")[0])
    small = ModelTrainer(cfg, data, device="cpu")
    limit = (small._mode_bytes("train") + small._mode_bytes("validate")) / 2
    small.cfg = small.cfg.replace(epoch_scan_max_mb=limit)
    hist = small.train()
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("[dispatch] epoch_exec:"))
    chunks, spc = small._stream_plan("train")
    assert chunks > 1
    assert line.startswith(f"[dispatch] epoch_exec: train=stream({chunks} "
                           f"chunks x {spc} steps), validate=scan "
                           f"(epoch_scan_max_mb={limit}, chunk budget "
                           f"{limit} MB)")
    assert "; scan and stream steps: eager (cpu" in line
    assert np.isfinite(hist["train"]).all()


def test_epoch_mean_is_the_jax_formula():
    losses = np.array([1.5, 2.25, 4.0], np.float32)
    sizes = np.array([4, 4, 2], np.int32)
    assert epoch_mean(losses, sizes) == float(losses @ sizes) / 10


@pytest.mark.parametrize("schedule", ["none", "cosine", "exponential"])
def test_rate_table_equals_lr_at(schedule):
    """The f32 rate table on the device, step by step, past total_steps
    too (the table grows: exponential is not clipped)."""
    p = torch.zeros(3, requires_grad=True)
    opt = make_optimizer("Adam", [p], 0.5, lr_schedule=schedule,
                         total_steps=8)
    ref = lr_at(0.5, schedule, 8)
    assert opt.lr_table.dtype == torch.float32
    assert opt.lr_table.shape[0] == 8
    assert not opt.reserve(8) and opt.reserve(13)
    assert opt.lr_table.shape[0] >= 13
    for i in range(13):
        assert opt.lr_table[i].item() == np.float32(ref(i)), i
    for i in range(13):
        p.grad = torch.ones(3)
        opt.step()
        assert opt.lr_t.item() == np.float32(ref(i))
    assert opt.count == int(opt.step_t) == 13


def test_graph_set_refuses_the_cpu_and_the_ell_arm():
    assert refusal(torch.device("cpu"), "kernel").startswith("cpu")
    assert refusal(torch.device("cuda"), "ell").startswith("bdgcn_impl=ell")
    assert refusal(torch.device("cuda"), "kernel") is None
    with pytest.raises(RuntimeError, match="cannot capture"):
        GraphSet(torch.device("cpu"), "kernel")


def test_replays_add_the_captured_tally():
    """A replay counts each kernel's captured launches; a capture context
    does not nest."""
    k = build.CudaKernel("lstm_infer", "lstm_infer_last_f32", 7, 4)
    k.launches = 3
    build.add_replayed({k: 2}, times=5)
    assert k.launches == 13
    with build.capture_launches() as tally:
        assert tally == {}
        with pytest.raises(RuntimeError, match="already"):
            build.capture_launches().__enter__()


def test_serve_engine_says_it_runs_eager_on_the_cpu(data, capsys,
                                                    tmp_path):
    eng = ServeEngine(MPGCNConfig(**KW), data,
                      ServeConfig(buckets=(1, 2), output_dir=str(tmp_path)),
                      device="cpu", allow_fresh=True)
    try:
        out = capsys.readouterr().out
        assert "[serve] rollout graphs: none (cpu" in out
        md = eng.pipeline.modes["test"]
        t = eng.submit(md.x[0, ..., 0], int(md.keys[0]))
        assert t.wait(60) and t.ok
    finally:
        eng.close()
