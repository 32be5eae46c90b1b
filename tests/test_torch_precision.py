"""The port's precision plane against the JAX package's, on the CPU: the
plain bf16 twins of the LSTM and K-BDGCN kernels against the Pallas
kernels in bf16 (interpret mode), the bf16 model forward and gradients
against ``mpgcn_apply(compute_dtype=bfloat16)``, the dynamic loss scaler
against mpgcn_tpu/quant/scaling.py and its composition with the step
sentinels, int8 weight-only quantization against mpgcn_tpu/quant/int8.py,
remat, bf16 checkpoints crossing the two packages, and the CLI under
``-dtype bfloat16``.

Tolerances (each test names its own):
  * the plain twins against the Pallas kernels: both store bf16 and sum in
    f32 in other orders, so a sum within f32 rounding of a bf16 boundary
    rounds to the neighbouring bf16 value (2^-8 relative), which the LSTM
    carries through h into later steps: ``BF16_TOL``, rtol 2^-7 and atol
    2^-6 (4 bf16 ulps at 1.0). K-BDGCN rounds its intermediate at another
    point than the Pallas kernel (U = h1 Wr against t = h1 G_d, both
    bf16), ``BDGCN_BF16_TOL``: 2^-6 of the output's largest entry;
  * the model (an LSTM and three BDGCN layers in bf16, either package):
    ``MODEL_BF16_TOL``, rtol and atol 2e-2 x the largest output (measured
    5e-3); its weight matrices' gradients ``GRAD_BF16_TOL``, 3e-2 x each
    one's largest entry (measured: each package within 6.4e-3 of the f32
    gradient). Its bias gradients are held against the f32 gradient at
    1e-2 (measured 4.8e-3): the JAX package reduces them over B N^2 rows in
    bf16, 18% from f32 at these shapes;
  * the scaler's state equal to the JAX scaler's exactly; Adam's updates
    rtol 1e-6 (optax and torch order Adam's arithmetic differently);
  * int8 codes and scales bitwise equal to the JAX package's; the int8
    forward within the JAX bound, 0.05 of the f32 forward;
  * remat gradients equal to the gradients without it, bit for bit; a
    clean bf16 run with the scaler equal to one without, bit for bit;
  * the CLI: validation RMSE under bf16 within 10% of f32's (the JAX
    package's bound, tests/test_precision.py:178-193); test mode under
    bf16 on the JAX CLI's bf16 checkpoint against the JAX CLI's own test
    mode at rtol 2e-2 (the two bf16 forwards, measured 5e-3 apart above);
    int8 against bf16 test mode at rtol 5e-2.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.nn import pallas_bdgcn, pallas_lstm
from mpgcn_tpu.nn.mpgcn import mpgcn_apply
from mpgcn_tpu.quant import int8 as jax_int8
from mpgcn_tpu.quant.scaling import dynamic_loss_scaling
from mpgcn_tpu.train.checkpoint import load_checkpoint as jax_load
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.quant import int8
from mpgcn_tpu_torch.quant.scaling import DynamicLossScaler
from mpgcn_tpu_torch.resilience import sentinels
from mpgcn_tpu_torch.train.objectives import make_optimizer
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils.convert import params_from_jax, read_checkpoint
from tests.torch_heal_common import (
    data_for,
    events,
    jax_params,
    jax_trainer,
    np_tree,
    port_params,
    port_trainer,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)
BDGCN_BF16_TOL = 2 ** -6
MODEL_BF16_TOL = 2e-2
GRAD_BF16_TOL = 3e-2
BIAS_GRAD_TOL = 1e-2
bf16 = torch.bfloat16


def _j(a):
    """A float32 numpy array as a JAX bf16 array."""
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t(a):
    """The same values as a torch bf16 tensor."""
    return torch.from_numpy(np.array(a, np.float32)).to(bf16)


def _np(a):
    """A JAX or torch array (bf16 included) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(ours, ref, rtol, atol, what=""):
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=rtol, atol=atol,
                               err_msg=what)


# --- the plain bf16 twins against the Pallas kernels in bf16 ---------------


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("H", [8, 16])
def test_bf16_lstm_infer_twin_matches_pallas(collect, H):
    """lstm_infer_last / collect on bf16 x_proj against
    _fused_layer_infer on the same bf16 operands."""
    rng = np.random.default_rng(H)
    T, R = 7, 40
    xp = rng.normal(size=(T, R, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    ref = pallas_lstm._fused_layer_infer(_j(xp), _j(w), collect,
                                         interpret=True)
    ours = cuda_lstm.lstm_layer_infer_plain(_t(xp), _t(w), collect)
    assert ours.dtype == bf16 and tuple(ours.shape) == ref.shape
    assert ref.dtype == jnp.bfloat16
    _close(ours, ref, **BF16_TOL)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("F", [1, 3])
def test_bf16_lstm_fused_twin_matches_pallas(collect, F):
    """The fused form's bf16 twin (projection rounded as x_proj is stored)
    against fused_layer_scan on bf16 weights: XLA's bf16 projection, then
    the Pallas layer in bf16."""
    rng = np.random.default_rng(F)
    T, R, H = 7, 40, 8
    s = 1 / np.sqrt(H)
    layer = {k: rng.uniform(-s, s, shape).astype(np.float32)
             for k, shape in (("w_ih", (4 * H, F)), ("w_hh", (4 * H, H)),
                              ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
    seq = rng.normal(size=(R, T, F)).astype(np.float32)
    outs, (h_T, _) = pallas_lstm.fused_layer_scan(
        {k: _j(v) for k, v in layer.items()}, _j(seq), collect,
        inference=True, interpret=True)
    ref = outs.transpose(1, 0, 2) if collect else h_T
    w = {k: _t(v) for k, v in layer.items()}
    ours = cuda_lstm.lstm_layer_infer_fused_plain(
        _t(seq), w["w_ih"], w["b_ih"] + w["b_hh"], w["w_hh"].t(), collect)
    assert ours.dtype == bf16
    _close(ours, ref, **BF16_TOL)


@pytest.mark.parametrize("H", [8, 16])
def test_bf16_lstm_train_twins_match_pallas(H):
    """The training forward's and the BPTT's bf16 twins against
    _fused_layer_fwd_impl and _fused_layer_bwd_pallas in bf16: hs and cs,
    then dx_proj and dW_hh^T (summed in f32, cast to bf16 as the Pallas
    VJP casts it) on the Pallas forward's own hs and cs."""
    rng = np.random.default_rng(100 + H)
    T, R = 7, 40
    xp = rng.normal(size=(T, R, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    hs_j, cs_j = pallas_lstm._fused_layer_fwd_impl(_j(xp), _j(w), True)
    hs, cs = cuda_lstm.lstm_layer_train_plain(_t(xp), _t(w))
    assert hs.dtype == cs.dtype == bf16
    _close(hs, hs_j, **BF16_TOL)
    _close(cs, cs_j, rtol=BF16_TOL["rtol"],
           atol=BF16_TOL["atol"] * float(np.abs(_np(cs_j)).max()))
    dhs = rng.normal(size=(T, R, H)).astype(np.float32)
    dcs = rng.normal(size=(T, R, H)).astype(np.float32)
    h_prev = jnp.concatenate([jnp.zeros_like(hs_j[:1]), hs_j[:-1]])
    c_prev = jnp.concatenate([jnp.zeros_like(cs_j[:1]), cs_j[:-1]])
    dxp_j, dw_j = pallas_lstm._fused_layer_bwd_pallas(
        True, _j(xp), _j(w), h_prev, c_prev, cs_j, _j(dhs), _j(dcs))
    hs_t, cs_t = _t(_np(hs_j)), _t(_np(cs_j))
    dxp, dw = cuda_lstm.lstm_layer_bwd(_t(xp), _t(w), hs_t, cs_t, _t(dhs),
                                       _t(dcs))
    assert dxp.dtype == dw.dtype == bf16 and dw_j.dtype == jnp.bfloat16
    scale = float(np.abs(_np(dxp_j)).max())
    _close(dxp, dxp_j, rtol=BF16_TOL["rtol"], atol=BF16_TOL["atol"] * scale)
    _close(dw, dw_j, rtol=BF16_TOL["rtol"],
           atol=2 ** -8 * float(np.abs(_np(dw_j)).max()))


@pytest.mark.parametrize("dynamic", [False, True])
def test_bf16_bdgcn_twins_match_pallas(dynamic):
    """K-BDGCN's bf16 forward and backward twins against the Pallas
    kernels in bf16 (_fwd_impl, _bwd_pallas): out, dh1 and dW."""
    rng = np.random.default_rng(7 + dynamic)
    K, B, N, C, H = 3, 3, 9, 8, 8
    h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
    g = (rng.random((B if dynamic else 1, K, N, N)) / N).astype(np.float32)
    w = (rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C)).astype(
        np.float32)
    dout = rng.normal(size=(B, N, N, H)).astype(np.float32)
    ref = pallas_bdgcn._fwd_impl(_j(h1), _j(g), _j(w), True)
    ours = cuda_bdgcn.folded_pair_project_plain(_t(h1), _t(g), _t(w))
    assert ours.dtype == bf16 and ref.dtype == jnp.bfloat16
    top = float(np.abs(_np(ref)).max())
    _close(ours, ref, rtol=BDGCN_BF16_TOL, atol=BDGCN_BF16_TOL * top)
    dh1_j, dw_j = pallas_bdgcn._bwd_pallas(_j(h1), _j(g), _j(w), _j(dout),
                                           True)
    dh1, dw = cuda_bdgcn.folded_pair_project_bwd(_t(h1), _t(g), _t(w),
                                                 _t(dout))
    assert dh1.dtype == dw.dtype == bf16
    for a, b in ((dh1, dh1_j), (dw, dw_j)):
        top = float(np.abs(_np(b)).max())
        _close(a, b, rtol=BDGCN_BF16_TOL, atol=BDGCN_BF16_TOL * top)


# --- the model in bf16 against mpgcn_apply(compute_dtype=bfloat16) ---------


def _model_case(seed=0):
    from tests.test_torch_model import _port, _setup

    cfg, data, params, x, keys, graphs = _setup(1, seed)
    model, tgraphs = _port(cfg, data, params, keys)
    return params, x, graphs, model, tgraphs


def test_bf16_forward_and_grads_match_mpgcn_apply():
    """The port's model with compute dtype bf16 (weights from
    params_from_jax, cast inside the forward) against mpgcn_apply with
    compute_dtype=bfloat16 on the Pallas arms: the inference forward, and
    the training forward's gradients of sum(out^2), which land in the f32
    master weights on both sides (biases against the f32 gradient: see
    the module docstring). Seed 0: branch 1 live, branch 0's head dead
    (its gradients zero on both sides)."""
    params, x, graphs, model, tgraphs = _model_case()
    apply = lambda p, inference, dt=jnp.bfloat16: mpgcn_apply(
        p, jnp.asarray(x), graphs, compute_dtype=dt,
        lstm_impl="pallas", bdgcn_impl="pallas", inference=inference)
    ref = np.asarray(apply(params, True))
    xt = torch.from_numpy(x)
    out = model(xt, tgraphs, dtype=bf16)
    assert out.dtype == torch.float32 and (ref != 0).mean() > 0.1
    top = float(np.abs(ref).max())
    _close(out, ref, rtol=MODEL_BF16_TOL, atol=MODEL_BF16_TOL * top)
    grads = {dt: params_from_jax(np_tree(jax.grad(
        lambda p: jnp.sum(apply(p, False, dt) ** 2))(params)))
        for dt in (jnp.bfloat16, None)}
    model.zero_grad()
    (model(xt, tgraphs, inference=False, dtype=bf16) ** 2).sum().backward()
    live = 0
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        bias = name.endswith(("b_ih", "b_hh", ".b", "bias"))
        r = grads[None if bias else jnp.bfloat16][name].numpy()
        top = float(np.abs(r).max())
        live += top > 0
        tol = BIAS_GRAD_TOL if bias else GRAD_BF16_TOL
        _close(p.grad, r, rtol=tol, atol=tol * top, what=name)
    assert live == 12


def test_remat_gradients_equal_no_remat():
    """remat (each branch under torch.utils.checkpoint) recomputes the
    same forward in the backward: gradients bit for bit those without it,
    in f32 and in bf16."""
    params, x, _, model, tgraphs = _model_case()
    xt = torch.from_numpy(x)
    for dtype in (None, bf16):
        got = []
        for remat in (False, True):
            model.remat = remat
            model.zero_grad()
            (model(xt, tgraphs, inference=False, dtype=dtype) ** 2).sum() \
                .backward()
            got.append([p.grad.clone() for p in model.parameters()])
        for a, b in zip(*got):
            assert torch.equal(a, b)
    model.remat = False


# --- the dynamic loss scaler -------------------------------------------------


def _jax_tx(init=8.0, interval=3, min_scale=1.0):
    import optax

    return dynamic_loss_scaling(optax.adam(1e-2), init_scale=init,
                                growth_interval=interval,
                                min_scale=min_scale)


def test_scaler_state_machine_matches_jax():
    """A stream of scaled gradients (clean, then non-finite, then clean
    past the growth interval, then non-finite down to the floor) through
    the port's ChainAdam with its scaler and through the JAX scaler around
    optax's Adam: after every step the scale, streak and skip count are
    equal, the weights within rtol 1e-6, and a skipped step leaves the
    weights and Adam's state as they were, bit for bit."""
    tx = _jax_tx(init=4.0, interval=3, min_scale=1.0)
    w0 = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    jp = {"w": jnp.asarray(w0)}
    st = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer("Adam", [p], 1e-2, loss_scaling=True,
                         loss_scale_init=4.0, loss_scale_growth_interval=3,
                         loss_scale_min=1.0)
    rng = np.random.default_rng(0)
    pattern = "ccnccccnnnnc"
    for i, kind in enumerate(pattern):
        g = rng.normal(size=4).astype(np.float32)
        if kind == "n":
            g[i % 4] = np.inf if i % 2 else np.nan
        scaled = g * float(st.scale)
        upd, st = tx.update({"w": jnp.asarray(scaled)}, st, jp)
        jp = {"w": jp["w"] + upd["w"]}
        before = [p.detach().clone(),
                  *[t.clone() for t in opt.state[p].values()]]
        p.grad = torch.from_numpy(scaled.copy())
        opt.step()
        stats = opt.scaler.stats()
        assert stats["scale"] == float(st.scale), i
        assert stats["good_steps"] == int(st.good_steps), i
        assert stats["skipped_steps"] == int(st.skipped), i
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, err_msg=str(i))
        if kind == "n":
            after = [p.detach(), *opt.state[p].values()]
            assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert opt.scaler.stats()["scale"] == 1.0  # at the floor


def test_scaler_validation_matches_jax():
    for kw in (dict(init_scale=-1.0), dict(growth_interval=0),
               dict(init_scale=0.5, min_scale=1.0)):
        with pytest.raises(ValueError):
            DynamicLossScaler([torch.zeros(2)], **kw)
        with pytest.raises(ValueError):
            _jax_tx(**{{"init_scale": "init", "growth_interval": "interval",
                         "min_scale": "min_scale"}[k]: v
                        for k, v in kw.items()})


@pytest.fixture(scope="module")
def data():
    return data_for()


def test_bf16_clean_run_with_scaler_equals_without(tmp_path, data):
    """Power-of-two scales are exponent shifts: a clean bf16 run with the
    scaler on equals one with it off bit for bit (epoch losses, weights),
    as the JAX package claims of its own (tests/test_precision.py:164)."""
    runs = []
    for ls in ("dynamic", "none"):
        tr = port_trainer(tmp_path / ls, data, dtype="bfloat16",
                          loss_scaling=ls, num_epochs=2)
        h = tr.train()
        runs.append((h, port_params(tr)))
        assert (tr.optimizer.scaler is not None) == (ls == "dynamic")
    (h_on, p_on), (h_off, p_off) = runs
    assert h_on == h_off
    for k in p_on:
        assert torch.equal(p_on[k], p_off[k]), k
    ev = events(tmp_path / "dynamic", "epoch")
    assert all(e["loss_scale"] == 65536.0 and e["scaler_skipped_steps"] == 0
               for e in ev)
    assert "loss_scale" not in events(tmp_path / "none", "epoch")[0]


def test_scaler_skip_halves_without_marking_the_loss(tmp_path, data):
    """A step whose scaled gradients overflow (one weight's gradient made
    Inf) is skipped by the scaler inside the step: the weights and Adam's
    state stay, the scale halves, the loss is not marked (no sentinel
    skip), and the next step runs at the halved scale."""
    tr = port_trainer(tmp_path, data, dtype="bfloat16", num_epochs=1)
    x, y, keys, size = tr._first_batch()
    p0 = port_params(tr)
    loss = tr._loss_and_grads(x, y, keys, size)
    first = next(tr.model.parameters())
    first.grad.view(-1)[0] = float("inf")
    out = tr.optimizer.update(loss)
    assert torch.isfinite(out) and torch.equal(out, loss)
    for k, v in port_params(tr).items():
        assert torch.equal(v, p0[k]), k
    assert tr.optimizer.scaler.stats() == {
        "scale": 32768.0, "good_steps": 0, "skipped_steps": 1}
    assert int(tr.optimizer.step_t) == 0


def test_sentinel_reject_with_finite_grads_keeps_scaler_streak(
        tmp_path, data, monkeypatch):
    """A sentinel-rejected step whose gradients were finite keeps the
    scaler's state from before it (no streak advance); a scaler skip
    (non-finite gradients) keeps its halving and count through the
    sentinel's revert (the JAX trainer's composition,
    mpgcn_tpu/train/trainer.py:671-690)."""
    tr = port_trainer(tmp_path, data, dtype="bfloat16", num_epochs=1)
    x, y, keys, size = tr._first_batch()
    sc = tr.optimizer.scaler
    monkeypatch.setattr(sentinels, "all_finite",
                        lambda tensors: torch.tensor(False))
    loss = tr.optimizer.update(tr._loss_and_grads(x, y, keys, size))
    assert torch.isnan(loss)
    assert sc.stats() == {"scale": 65536.0, "good_steps": 0,
                          "skipped_steps": 0}
    monkeypatch.undo()
    loss = tr.optimizer.update(tr._loss_and_grads(x, y, keys, size))
    assert torch.isfinite(loss) and sc.stats()["good_steps"] == 1
    tr._loss_and_grads(torch.full_like(x, float("nan")), y, keys, size)
    tr.optimizer.update(torch.tensor(1.0))
    assert sc.stats() == {"scale": 32768.0, "good_steps": 0,
                          "skipped_steps": 1}


def test_scaler_and_sentinels_share_one_select(tmp_path, data, monkeypatch):
    """With the scaler and the step sentinels both on, an update puts the
    weights and Adam's state back through one pass (the sentinel's, given
    the scaler's verdict), never ``StepGuard.select`` as well: a scaler
    skip leaves them as they were, bit for bit, and a clean step keeps
    them as the update left them."""
    tr = port_trainer(tmp_path, data, dtype="bfloat16", num_epochs=1)
    monkeypatch.setattr(sentinels.StepGuard, "select", lambda self, ok: (
        pytest.fail("a second select pass")))
    x, y, keys, size = tr._first_batch()
    before = [t.clone() for t in tr.optimizer.guarded()]
    loss = tr._loss_and_grads(x, y, keys, size)
    next(tr.model.parameters()).grad.view(-1)[0] = float("inf")
    assert torch.equal(tr.optimizer.update(loss), loss)
    assert all(torch.equal(a, b)
               for a, b in zip(before, tr.optimizer.guarded()))
    assert tr.optimizer.scaler.stats()["skipped_steps"] == 1
    loss = tr.optimizer.update(tr._loss_and_grads(x, y, keys, size))
    assert torch.isfinite(loss) and int(tr.optimizer.step_t) == 1
    n = len(tr.optimizer.all_params())
    assert not all(torch.equal(a, b) for a, b in zip(
        before[:n], tr.optimizer.guarded()[:n]))


def test_scaler_skip_at_the_floor_counts_as_a_sentinel_skip(tmp_path, data):
    """A scaler skip while the scale is already at loss_scale_min is no
    scale-induced overflow: the loss is marked (counted against
    skip_budget), as in the JAX trainer (mpgcn_tpu/train/trainer.py:
    691-703)."""
    tr = port_trainer(tmp_path, data, dtype="bfloat16", num_epochs=1,
                      loss_scale_init=2.0, loss_scale_min=2.0)
    x, y, keys, size = tr._first_batch()
    loss = tr._loss_and_grads(x, y, keys, size)
    next(tr.model.parameters()).grad.view(-1)[0] = float("nan")
    assert torch.isnan(tr.optimizer.update(loss))
    assert tr.optimizer.scaler.stats()["skipped_steps"] == 1


# --- int8 weight-only inference ----------------------------------------------


def test_int8_codes_and_scales_bitwise_equal_jax():
    """quantize_params on the port's tree against the JAX package's on the
    same weights: every quantized leaf's codes and scales bit for bit, the
    same leaves quantized (LSTM w_ih / w_hh on axis 0, BDGCN W on axis 1),
    biases and the FC head left dense; the round-trip error within scale /
    2 and equal to the JAX analyzer's."""
    params, _, _, model, _ = _model_case(seed=3)
    qj = jax_int8.quantize_params(params)
    ours = int8.quantize_params(dict(model.named_parameters()))
    ref = {k: v for k, v in params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_int8.dequantize_params(qj))).items()}
    n_q = 0
    for bi, br in enumerate(qj["branches"]):
        pairs = [(f"branches.{bi}.temporal.layers.{i}.{k}", lay[k])
                 for i, lay in enumerate(br["temporal"]["layers"])
                 for k in ("w_ih", "w_hh")]
        pairs += [(f"branches.{bi}.spatial.{i}.W", lay["W"])
                  for i, lay in enumerate(br["spatial"])]
        for name, qt in pairs:
            mine = ours[name]
            assert int8.is_quantized(mine) and jax_int8.is_quantized(qt)
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(qt.q))
            np.testing.assert_array_equal(mine.scale.numpy(),
                                          np.asarray(qt.scale))
            assert mine.q.dtype == torch.int8
            np.testing.assert_array_equal(mine.dequantize().numpy(),
                                          ref[name].numpy())
            n_q += 1
    dense = [k for k, v in ours.items() if not int8.is_quantized(v)]
    assert n_q == 10 and all(k.endswith(("b_ih", "b_hh", ".b", "weight",
                                        "bias")) for k in dense)
    err = int8.quantization_error(dict(model.named_parameters()), ours)
    err_j = jax_int8.quantization_error(params, qj)
    assert err["max_abs_error"] == err_j["max_abs_error"]
    assert err["quantized_leaves"] == err_j["quantized_leaves"] == 10
    assert err["param_bytes_int8"] == err_j["param_bytes_int8"]
    for row in err["per_layer"].values():
        assert row["max_abs_error"] <= row["bound_half_scale"]
    with pytest.raises(ValueError, match="non-finite"):
        int8.quantize_tensor(torch.tensor([[float("nan"), 1.0]]), 0)


def test_int8_forward_within_the_jax_bound():
    """The forward on the int8 tree (dequantized inside it) within 0.05 of
    the f32 forward (the JAX bound, tests/test_precision.py:421), and
    within f32 tolerance of mpgcn_apply on the JAX int8 tree."""
    params, x, graphs, model, tgraphs = _model_case()
    xt = torch.from_numpy(x)
    q = int8.quantize_params(dict(model.named_parameters()))
    p8 = model(xt, tgraphs, params=q)
    p32 = model(xt, tgraphs)
    assert float((p8 - p32).abs().max()) < 0.05
    ref = np.asarray(mpgcn_apply(jax_int8.quantize_params(params),
                                 jnp.asarray(x), graphs, lstm_impl="pallas",
                                 bdgcn_impl="pallas", inference=True))
    np.testing.assert_allclose(p8.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_infer_precision_rollouts_and_the_int8_cache(tmp_path, data):
    """predict at -infer-precision bf16 and int8 against f32 (within
    0.05, the JAX bounds); the int8 tree is quantized once per weights
    version and refilled in place, so its tensors keep their storage."""
    base = port_trainer(tmp_path / "f32", data, num_epochs=1)
    base.train()
    md = base.pipeline.modes["test"]
    p32 = base.predict(md.x[:2], md.keys[:2])
    for ip in ("bf16", "int8"):
        tr = port_trainer(tmp_path / ip, data, infer_precision=ip)
        tr.load_trained(base._ckpt_path())
        p = tr.predict(md.x[:2], md.keys[:2])
        assert p.dtype == np.float32 and np.isfinite(p).all()
        assert float(np.abs(p - p32).max()) < 0.05, ip
    q = tr._inference_params()
    ptrs = [v.q.data_ptr() for v in q.values() if int8.is_quantized(v)]
    assert tr._inference_params() is q and tr.quant_max_abs_error > 0
    tr.train()  # the weights move: quantized again, in place
    q2 = tr._inference_params()
    assert q2 is q and ptrs == [v.q.data_ptr() for v in q2.values()
                                if int8.is_quantized(v)]
    fresh = int8.quantize_params(dict(tr.model.named_parameters()))
    for k, v in fresh.items():
        if int8.is_quantized(v):
            assert torch.equal(q2[k].q, v.q) and torch.equal(
                q2[k].scale, v.scale), k


# --- checkpoints and the CLI -------------------------------------------------


def test_bf16_checkpoint_resume_crosses_packages(tmp_path, data):
    """A JAX bf16 run's rolling checkpoint (DynamicLossScaleState around
    the optax chain) resumed by the port: Adam's count and the scaler's
    scale, streak and skips taken over; the port's bf16 checkpoint keeps
    them under its own key, resumes on the port with them, and the JAX
    trainer reads its params (with a fresh optimizer, as for f32)."""
    src = tmp_path / "src"
    jt = jax_trainer(src, data, dtype="bfloat16", num_epochs=2,
                     loss_scale_growth_interval=5)
    jt.train()
    saved = jax_load(str(src / "MPGCN_od_last.pkl"))["opt_state"]
    shutil.copytree(src, tmp_path / "port")
    pt = port_trainer(tmp_path / "port", data, dtype="bfloat16",
                      num_epochs=2, loss_scale_growth_interval=5)
    pt.load_trained(str(tmp_path / "port" / "MPGCN_od_last.pkl"))
    st = pt.optimizer.scaler.stats()
    assert st == {"scale": float(saved.scale),
                  "good_steps": int(saved.good_steps),
                  "skipped_steps": int(saved.skipped)}
    assert st["scale"] > 65536.0  # it grew over the JAX run's steps
    S = pt.pipeline.num_batches("train")
    assert int(pt.optimizer.step_t) == 2 * S
    for k, v in port_params(pt).items():
        assert torch.equal(v, jax_params(jt)[k]), k
    pt3 = port_trainer(tmp_path / "port", data, dtype="bfloat16",
                       num_epochs=3, loss_scale_growth_interval=5)
    h = pt3.train(resume=True)
    assert len(h["train"]) == 1 and np.isfinite(h["train"]).all()
    ckpt = read_checkpoint(str(tmp_path / "port" / "MPGCN_od_last.pkl"))
    ls = ckpt["opt_state_torch"]["loss_scale"]
    assert ls == {"scale": pt3.optimizer.scaler.stats()["scale"],
                  "good_steps": pt3.optimizer.scaler.stats()["good_steps"],
                  "skipped": 0}
    pt4 = port_trainer(tmp_path / "port", data, dtype="bfloat16",
                       num_epochs=3)
    pt4.load_trained(str(tmp_path / "port" / "MPGCN_od_last.pkl"))
    assert pt4.optimizer.scaler.stats() == pt3.optimizer.scaler.stats()
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jt2 = jax_trainer(tmp_path / "jax", data, dtype="bfloat16",
                      num_epochs=3)
    jt2.load_trained(str(tmp_path / "jax" / "MPGCN_od_last.pkl"))
    live = port_params(pt3)
    for k, v in jax_params(jt2).items():
        assert torch.equal(v, live[k]), k
    # an f32 checkpoint in a bf16 run: the structure differs, fresh state
    f32 = port_trainer(tmp_path / "f32", data, num_epochs=1)
    f32.train()
    pt5 = port_trainer(tmp_path / "f32", data, dtype="bfloat16")
    pt5.load_trained(str(tmp_path / "f32" / "MPGCN_od_last.pkl"))
    assert int(pt5.optimizer.step_t) == 0
    assert pt5.optimizer.scaler.stats()["scale"] == 65536.0


def _scores(out):
    with open(os.path.join(out, "MPGCN_prediction_scores.txt")) as f:
        return [[float(v) for v in line.split(",")[5:]] for line in f]


def test_cli_bf16_trains_and_tests_near_f32_and_jax(tmp_path):
    """python -m mpgcn_tpu_torch.cli -dtype bfloat16 trains (on the bf16
    twins, the scaler on under -loss-scaling auto) and tests: its final
    validation loss within 10% of the f32 run's in RMSE. On the JAX CLI's
    bf16 checkpoint (the two CLIs draw different inits from one seed) its
    test mode scores match the JAX CLI's test mode; -infer-precision int8
    tests too."""
    common = ["-data", "synthetic", "-sN", "8", "-sT", "60", "-hidden",
              "8", "-epoch", "3", "-seed", "10", "-lr", "1e-2"]
    runs = {}
    for tag, extra in (("f32", []), ("bf16", ["-dtype", "bfloat16"])):
        out = str(tmp_path / tag)
        runs[tag] = cli.main(["-GPU", "cpu", *common, *extra, "-out", out])
        assert np.isfinite(runs[tag]["validate"]).all()
    rmse32 = float(np.sqrt(runs["f32"]["validate"][-1]))
    rmse16 = float(np.sqrt(runs["bf16"]["validate"][-1]))
    assert rmse16 <= 1.10 * rmse32, (rmse16, rmse32)
    ev = events(tmp_path / "bf16", "epoch")
    assert ev and all("loss_scale" in e for e in ev)
    jout = str(tmp_path / "jax")
    jax_cli.main([*common, "-dtype", "bfloat16", "-out", jout])
    bout = str(tmp_path / "from_jax")
    shutil.copytree(jout, bout)
    jax_cli.main([*common, "-dtype", "bfloat16", "-mode", "test", "-out",
                  jout])
    cli.main(["-GPU", "cpu", *common, "-dtype", "bfloat16", "-mode", "test",
              "-out", bout])
    np.testing.assert_allclose(_scores(bout), _scores(jout), rtol=2e-2)
    cli.main(["-GPU", "cpu", *common, "-dtype", "bfloat16",
              "-infer-precision", "int8", "-mode", "test", "-out", bout])
    s = _scores(bout)
    assert len(s) == 4 and np.isfinite(s).all()
    np.testing.assert_allclose(s[2:], s[:2], rtol=5e-2)


PRECISION_FLAGS = ["-dtype", "-loss-scaling", "-loss-scale-init",
                   "-loss-scale-growth", "-infer-precision"]


@pytest.mark.parametrize("flag", PRECISION_FLAGS)
def test_precision_flags_match_jax(flag):
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "const", "required", "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr


def test_model_takes_its_precision_from_the_config():
    from mpgcn_tpu_torch.config import MPGCNConfig

    m = MPGCN.from_config(MPGCNConfig(dtype="bfloat16", remat=True,
                                      hidden_dim=8, num_nodes=4),
                          device="cpu")
    assert m.compute_dtype == bf16 and m.remat
    m = MPGCN.from_config(MPGCNConfig(hidden_dim=8, num_nodes=4),
                          device="cpu")
    assert m.compute_dtype is None and not m.remat
    assert all(p.dtype == torch.float32 for p in m.parameters())
