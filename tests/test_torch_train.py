"""The port's training path against the JAX package on the CPU: batching,
losses, Adam, metrics, whole-model gradients against ``jax.grad`` through
the Pallas backward kernels, a 2-epoch ``ModelTrainer`` run against the
JAX ``ModelTrainer`` from the same weights, checkpoints read both ways,
and the CLI.

Sizes: N=8, hidden 8, synthetic_T=60, batch 4 (34 training windows, so
the last training batch holds 2 real rows and 2 repeat-padded ones). The
data is drawn from seed 0. The weights that the gradient and training
comparisons start from are the JAX init at seed 10 (``INIT_SEED``): at these
widths seed 0 leaves the static branch's ReLU head dead, so its gradients
would be all 0 and their comparison vacuous; seed 10 gives both branches'
heads non-zero outputs everywhere. The tests assert every branch live.

Tolerances, f32 on both sides with different summation orders:
  * losses and metrics rtol 1e-5 (means of O(1)-O(10) values);
  * gradients rtol 1e-4 with atol 1e-5 x the tensor's largest entry: each
    gradient sums B N^2 T products through three BDGCN layers, and near-
    zero entries of a tensor carry the absolute error of its large ones;
  * params after 2 epochs rtol 1e-4 / atol 2e-6: Adam's update is
    lr * m / (sqrt(v) + eps), so an entry whose gradient is near zero can
    move by a visible fraction of lr = 1e-4 on f32 noise alone;
  * forwards rtol 1e-4 / atol 1e-5, the 7-step rollout scores rtol 1e-4.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.nn import pallas_bdgcn, pallas_lstm
from mpgcn_tpu.nn.mpgcn import mpgcn_apply
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu.train import metrics as jax_metrics
from mpgcn_tpu.train.checkpoint import check_branch_spec, load_checkpoint
from mpgcn_tpu.train.objectives import make_loss_fn as jax_loss_fn
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.train import metrics
from mpgcn_tpu_torch.train.objectives import make_loss_fn, make_optimizer
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax, params_to_jax

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, H = 8, 8
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, seed=0)
#: the JAX init seed of the gradient and training comparisons (see above)
INIT_SEED = 10
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-4, atol=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_grads_close(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(
            ours[k], r, rtol=1e-4, atol=1e-5 * float(np.abs(r).max()),
            err_msg=k)


def _assert_branches_live(model, x, graphs):
    """Every branch's pre-head output and FC+ReLU head are mostly non-zero:
    a dead branch has all-zero gradients, which compare trivially."""
    _, hidden = model(x, graphs, return_hidden=True)
    with torch.no_grad():
        for m, (b, h) in enumerate(zip(model.branches, hidden)):
            assert float((h != 0).float().mean()) > 0.1, f"branch {m}"
            head = torch.relu(b.fc(h))
            assert float((head != 0).float().mean()) > 0.1, f"branch {m}"


def _jax_cfg(out, **kw):
    return JaxConfig(native_host="off", output_dir=str(out),
                     **{**KW, **kw})


# --- data, losses, optimizer, metrics ------------------------------------


@pytest.mark.parametrize("mode,shuffle", [("train", False), ("train", True),
                                          ("validate", False)])
def test_batches_match_jax_pipeline(mode, shuffle):
    cfg = MPGCNConfig(pred_len=1, **KW)
    data = synthetic_dataset(cfg)
    ours = DataPipeline(cfg, data, device="cpu")
    ref = JaxPipeline(_jax_cfg("unused", pred_len=1), data)
    assert ours.num_batches(mode) == ref.num_batches(mode)
    got = list(ours.batches(mode, shuffle=shuffle,
                            rng=np.random.default_rng(3), pad_to_full=True))
    want = list(ref.batches(mode, shuffle=shuffle,
                            rng=np.random.default_rng(3), pad_to_full=True))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.size == b.size
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.keys, b.keys)
    assert got[-1].x.shape[0] == cfg.batch_size
    if mode == "train":
        assert got[-1].size == 2  # 34 windows: two real rows, two pads


@pytest.mark.parametrize("kind", ["MSE", "MAE", "Huber"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(4, 1, 5, 5, 1)).astype(np.float32) * 2
    target = rng.normal(size=pred.shape).astype(np.float32)
    ours = make_loss_fn(kind)(torch.from_numpy(pred),
                              torch.from_numpy(target))
    ref = jax_loss_fn(kind)(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(ours), float(ref), **LOSS_TOL)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(NotImplementedError, match="loss"):
        make_loss_fn("L3")
    with pytest.raises(NotImplementedError, match="optimizer"):
        make_optimizer("SGD", [torch.zeros(1, requires_grad=True)], 1e-3)
    with pytest.raises(ValueError, match="loss"):
        MPGCNConfig(loss="L3")


@pytest.mark.parametrize("decay,schedule", [
    pytest.param(0.0, "none", id="0.0"), pytest.param(0.01, "none", id="0.01"),
    pytest.param(0.0, "cosine", id="0.0-cosine"),
    pytest.param(0.01, "exponential", id="0.01-exponential")])
def test_adam_matches_optax_chain(decay, schedule):
    """torch Adam(weight_decay) against the JAX package's optax chain
    (add_decayed_weights before adam) over 5 steps of fixed gradients, at
    a fixed rate and at each schedule over 4 steps (the rate read from the
    device table; exponential runs on past its end)."""
    from mpgcn_tpu.train.objectives import make_optimizer as jax_optimizer

    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(6, 3)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer("Adam", [p], 1e-2, decay, lr_schedule=schedule,
                         total_steps=4)
    tx = jax_optimizer("Adam", 1e-2, decay, lr_schedule=schedule,
                       total_steps=4)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.random((5, 3, 4, 4, 1)).astype(np.float32) * 3
    true = rng.random(pred.shape).astype(np.float32) * 3
    for name in ("MSE", "RMSE", "MAE", "MAPE", "PCC"):
        np.testing.assert_allclose(getattr(metrics, name)(pred, true),
                                   getattr(jax_metrics, name)(pred, true),
                                   rtol=1e-12)
    np.testing.assert_allclose(metrics.per_horizon_rmse(pred, true),
                               jax_metrics.per_horizon_rmse(pred, true),
                               rtol=1e-12)
    np.testing.assert_allclose(metrics.evaluate(pred, true),
                               jax_metrics.evaluate(pred, true), rtol=1e-12)


def test_config_training_fields_match_jax_defaults():
    ours, ref = MPGCNConfig(), JaxConfig()
    for name in ("output_dir", "batch_size", "loss", "optimizer",
                 "learn_rate", "decay_rate", "num_epochs", "shuffle",
                 "early_stop_patience", "mode", "epoch_scan",
                 "epoch_scan_max_mb"):
        assert getattr(ours, name) == getattr(ref, name), name


# --- whole-model gradients against jax.grad ------------------------------


@pytest.fixture(scope="module")
def grad_case(tmp_path_factory):
    """A JAX trainer on the Pallas paths, and the last (partial) training
    batch: two real rows of four."""
    cfg = MPGCNConfig(pred_len=1, **KW)
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(seed=INIT_SEED)
    jt = JaxTrainer(_jax_cfg(tmp_path_factory.mktemp("grad"), pred_len=1,
                             seed=INIT_SEED, lstm_impl="pallas",
                             bdgcn_impl="pallas"), data)
    batch = list(jt.pipeline.batches("train", pad_to_full=True))[-1]
    assert batch.size == 2
    return cfg, data, jt, batch


#: hidden 128 and dual_random_walk_diffusion of order 3 (K = 7 supports) at
#: N = 6: the widths the card takes only through its wide kernels
WIDE = dict(synthetic_N=6, hidden_dim=128,
            kernel_type="dual_random_walk_diffusion", cheby_order=3)


@pytest.fixture(scope="module")
def wide_grad_case(tmp_path_factory):
    """``grad_case`` at the WIDE widths: its last training batch."""
    cfg = MPGCNConfig(pred_len=1, **{**KW, **WIDE})
    assert cfg.support_K == 7
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(seed=INIT_SEED)
    jt = JaxTrainer(_jax_cfg(tmp_path_factory.mktemp("wide_grad"),
                             pred_len=1, seed=INIT_SEED, lstm_impl="pallas",
                             bdgcn_impl="pallas", **WIDE), data)
    batch = list(jt.pipeline.batches("train", pad_to_full=True))[-1]
    return cfg, data, jt, batch


@pytest.mark.parametrize("arms,case", [
    pytest.param(("kernel", "kernel"), "grad_case", id="arms0"),
    pytest.param(("plain", "einsum"), "grad_case", id="arms1"),
    pytest.param(("kernel", "kernel"), "wide_grad_case",
                 id="arms0-hidden128-K7")])
def test_model_gradients_match_jax_grad(request, monkeypatch, arms, case):
    cfg, data, jt, batch = request.getfixturevalue(case)
    # reach the Pallas backward kernels at this small size
    monkeypatch.setattr(pallas_lstm, "_PALLAS_BWD_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_bdgcn, "_BDGCN_BWD_MIN_PAIRS", 0)
    jargs = (jt.banks, jnp.asarray(batch.x), jnp.asarray(batch.y),
             jnp.asarray(batch.keys), batch.size)
    loss_ref, grads = jax.jit(jax.value_and_grad(jt._batch_loss),
                              static_argnums=5)(jt.params, *jargs)
    pred_ref = jt._forward(jt.params, jnp.asarray(batch.x),
                           jt._graphs(jt.banks, jnp.asarray(batch.keys)),
                           remat=False)
    assert float((np.asarray(pred_ref)[:2] != 0).mean()) > 0.1

    pt = ModelTrainer(cfg, data, device="cpu", lstm_impl=arms[0],
                      bdgcn_impl=arms[1])
    pt.model.load_state_dict(params_from_jax(_np(jt.params)))
    x, y, keys = pt._tensors(batch)
    _assert_branches_live(pt.model, x,
                          graphs_for(pt.banks, keys, pt.model.sources))
    loss = pt._batch_loss(x, y, keys, batch.size)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    _assert_grads_close(
        {k: p.grad.numpy() for k, p in pt.model.named_parameters()},
        params_from_jax(_np(grads)))


def test_kernel_arm_backward_runs_the_hand_written_functions(grad_case):
    cfg, data, jt, batch = grad_case
    pt = ModelTrainer(cfg, data, device="cpu")
    x, y, keys = pt._tensors(batch)
    pred = pt.model(x, graphs_for(pt.banks, keys, pt.model.sources),
                    inference=False)
    seen, stack = set(), [pred.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack += [f for f, _ in fn.next_functions]
    names = {type(fn).__name__ for fn in seen}
    assert {"LSTMLayerFnBackward", "PairProjectFnBackward"} <= names
    # inference forwards record nothing
    assert pt.model(x, graphs_for(pt.banks, keys, pt.model.sources)
                    ).grad_fn is None


# --- ModelTrainer against the JAX ModelTrainer ----------------------------


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """2 epochs of the JAX trainer (its CPU defaults) and of the port's
    kernel-arm trainer on the CPU from the same init, then test mode
    (pred_len 7) of each on its own checkpoint."""
    out_j = tmp_path_factory.mktemp("jax_run")
    out_p = tmp_path_factory.mktemp("port_run")
    cfg = MPGCNConfig(pred_len=1, num_epochs=2, output_dir=str(out_p), **KW)
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(seed=INIT_SEED)
    jt = JaxTrainer(_jax_cfg(out_j, pred_len=1, num_epochs=2,
                             seed=INIT_SEED), data)
    init = _np(jt.params)
    pt = ModelTrainer(cfg, data, device="cpu")
    pt.model.load_state_dict(params_from_jax(init))
    batch = next(pt.pipeline.batches("train", pad_to_full=True))
    x, _, keys = pt._tensors(batch)
    _assert_branches_live(pt.model, x,
                          graphs_for(pt.banks, keys, pt.model.sources))
    hist_j = jt.train()
    hist_p = pt.train()
    res_j = JaxTrainer(_jax_cfg(out_j, pred_len=7, mode="test",
                                seed=INIT_SEED), data).test()
    res_p = ModelTrainer(cfg.replace(pred_len=7, mode="test"), data,
                         device="cpu").test()
    return dict(cfg=cfg, data=data, out_j=out_j, out_p=out_p, jt=jt, pt=pt,
                init=params_from_jax(init), hist_j=hist_j, hist_p=hist_p,
                res_j=res_j, res_p=res_p)


def test_two_epochs_match_jax_trainer(two_runs):
    r = two_runs
    for mode in ("train", "validate"):
        assert len(r["hist_p"][mode]) == 2
        np.testing.assert_allclose(r["hist_p"][mode], r["hist_j"][mode],
                                   **LOSS_TOL)
    # best epoch: the epoch each checkpoint was saved at
    ck_j = load_checkpoint(os.path.join(r["out_j"], "MPGCN_od.pkl"))
    with open(os.path.join(r["out_p"], "MPGCN_od.pkl"), "rb") as f:
        ck_p = pickle.load(f)
    assert ck_p["epoch"] == ck_j["epoch"] == r["pt"].best_epoch >= 1
    np.testing.assert_allclose(ck_p["extra"]["best_val"],
                               ck_j["extra"]["best_val"], **LOSS_TOL)
    assert ck_p["extra"]["global_step"] == ck_j["extra"]["global_step"]
    final_j = params_from_jax(_np(r["jt"].params))
    for k, v in r["pt"].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final_j[k].numpy(),
                                   err_msg=k, **PARAM_TOL)
    # training moved every weight, of both branches: the comparison is not
    # of two inits, nor of a branch that never trained
    for k, v in r["pt"].model.state_dict().items():
        assert not torch.equal(v, r["init"][k]), k


def _score_lines(out):
    with open(os.path.join(out, "MPGCN_prediction_scores.txt")) as f:
        return [line.rstrip("\n").split(", ") for line in f]


def test_test_mode_scores_match_jax(two_runs):
    r = two_runs
    lines_j, lines_p = _score_lines(r["out_j"]), _score_lines(r["out_p"])
    assert [l[:5] for l in lines_p] == [l[:5] for l in lines_j] == [
        [m, "MSE", "RMSE", "MAE", "MAPE"] for m in ("train", "test")]
    for lp, lj in zip(lines_p, lines_j):
        assert all(len(v.split(".")[1]) == 10 for v in lp[5:])
        np.testing.assert_allclose([float(v) for v in lp[5:]],
                                   [float(v) for v in lj[5:]], **SCORE_TOL)
    for mode in ("train", "test"):
        np.testing.assert_allclose(r["res_p"][mode]["RMSE_by_horizon"],
                                   r["res_j"][mode]["RMSE_by_horizon"],
                                   **SCORE_TOL)
        assert np.isfinite(r["res_p"][mode]["MSE"])


def test_port_checkpoint_loads_in_jax(two_runs):
    r = two_runs
    path = os.path.join(r["out_p"], "MPGCN_od.pkl")
    ckpt = load_checkpoint(path)
    check_branch_spec(ckpt, path, 2, ("static", "dynamic"))
    with pytest.raises(ValueError, match="num_branches"):
        check_branch_spec(ckpt, path, 3, None)
    # the optimizer state rides under the port's own key, which the JAX
    # loader does not read, and so does its integrity record; the JAX
    # loader verified the manifest and the params record
    assert set(ckpt) == {"epoch", "params", "opt_state_torch", "extra",
                         "manifest", "integrity", "integrity_torch"}
    assert set(ckpt["extra"]) == {"seed", "num_branches", "branch_sources",
                                  "best_val", "global_step"}
    jt = r["jt"]
    jt.load_trained(path)  # the JAX trainer's own loader takes it as-is
    md = jt.pipeline.modes["test"]
    x, keys = np.ascontiguousarray(md.x[:4]), md.keys[:4]
    ref = np.asarray(mpgcn_apply(ckpt["params"], jnp.asarray(x),
                                 jt._graphs(jt.banks, jnp.asarray(keys)),
                                 inference=True))
    assert (ref != 0).mean() > 0.1
    np.testing.assert_allclose(r["pt"].predict(x, keys, 1), ref, **FWD_TOL)
    np.testing.assert_allclose(jt.predict(x, keys, 1), ref, rtol=1e-6)


def test_jax_checkpoint_feeds_port_test(two_runs, tmp_path):
    r = two_runs
    shutil.copy(os.path.join(r["out_j"], "MPGCN_od.pkl"), tmp_path)
    res = ModelTrainer(r["cfg"].replace(pred_len=7, mode="test",
                                        output_dir=str(tmp_path)),
                       r["data"], device="cpu").test()
    for mode in ("train", "test"):
        for k in ("MSE", "RMSE", "MAE", "MAPE"):
            np.testing.assert_allclose(res[mode][k], r["res_j"][mode][k],
                                       **SCORE_TOL)
    assert len(_score_lines(tmp_path)) == 2


def test_params_to_jax_inverts_params_from_jax(two_runs):
    sd = two_runs["pt"].model.state_dict()
    tree = params_to_jax(sd)
    jax_tree = _np(two_runs["jt"].params)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax_tree))
    for k, v in params_from_jax(tree).items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


# --- the CLI and the entry points' device rule ----------------------------


def test_cli_trains_then_tests_on_the_cpu(tmp_path, capsys):
    argv = ["-GPU", "cpu", "-data", "synthetic", "-sN", str(N), "-sT", "60",
            "-hidden", str(H), "-epoch", "1", "-out", str(tmp_path)]
    hist = cli.main(argv)
    assert set(hist) == {"train", "validate"} and len(hist["train"]) == 1
    assert os.path.exists(tmp_path / "MPGCN_od.pkl")
    res = cli.main(argv + ["-mode", "test", "-pred", "3"])
    assert len(res["test"]["RMSE_by_horizon"]) == 3
    lines = _score_lines(tmp_path)
    assert [l[0] for l in lines] == ["train", "test"]
    out = capsys.readouterr().out
    assert "validation loss drops from inf" in out
    assert "model testing ends" in out


@pytest.mark.parametrize("flag", ["-kernel", "-K"])
def test_cli_graph_kernel_flags_match_jax(flag):
    """-kernel/--kernel_type and -K/--cheby_order: the same names, choices
    and defaults as mpgcn_tpu.cli's."""
    from mpgcn_tpu import cli as jax_cli

    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr


def test_cli_trains_then_tests_the_wide_configuration(tmp_path):
    """-hidden 128 -kernel dual_random_walk_diffusion -K 3 (K = 7 supports),
    the widths the card takes only through its wide kernels: one epoch on
    the CPU, then test mode."""
    argv = ["-GPU", "cpu", "-data", "synthetic", "-sN", "6", "-sT", "40",
            "-hidden", "128", "-kernel", "dual_random_walk_diffusion", "-K",
            "3", "-epoch", "1", "-out", str(tmp_path)]
    hist = cli.main(argv)
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"]).all()
    res = cli.main(argv + ["-mode", "test"])
    assert len(res["test"]["RMSE_by_horizon"]) == 7
    assert np.isfinite(res["test"]["RMSE"])
    with open(tmp_path / "MPGCN_od.pkl", "rb") as f:
        W = pickle.load(f)["params"]["branches"][0]["spatial"][0]["W"]
    assert np.shape(W) == (7 * 7 * 128, 128)


def test_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MPGCNConfig(pred_len=1, **KW)
    data = synthetic_dataset(cfg)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ModelTrainer(cfg, data)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["-data", "synthetic", "-sN", str(N), "-sT", "60",
                  "-hidden", str(H), "-out", str(tmp_path)])
    assert cli.device_for("cpu") == "cpu"
    assert cli.device_for("1") == "cuda:1"
    with pytest.raises(SystemExit):
        cli.device_for("tpu")

