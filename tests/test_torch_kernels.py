"""K-LSTM, K-LSTM-train, K-BDGCN and K-BDGCN-bwd: the plain versions
against the JAX package's Pallas kernels (run in interpret mode on the
CPU, as the JAX tests run them) and its XLA backward paths, the autograd
Functions against finite differences, and the wrappers' device dispatch.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.

Tolerances: f32 on both sides with different summation orders.
K-LSTM rtol 1e-5 / atol 1e-6 (outputs are tanh-bounded); K-BDGCN rtol 1e-5
/ atol 1e-5 (sums of K^2 N C products of O(1) values). The backward
outputs sum over rows and time as well: dx_proj rtol 1e-5 / atol 1e-5,
dW rtol 1e-5 / atol 1e-4 (sums of R T products of O(1) values, |dW| up to
about 50 here). gradcheck runs in float64 at its default tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.nn import pallas_bdgcn, pallas_lstm
from mpgcn_tpu.nn.bdgcn import bdgcn_apply as jax_bdgcn_apply
from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
from mpgcn_tpu_torch.nn.bdgcn import BDGCN, bdgcn_apply
from mpgcn_tpu_torch.nn.lstm import LSTM
from mpgcn_tpu_torch.utils.convert import params_from_jax

LSTM_TOL = dict(rtol=1e-5, atol=1e-6)
BDGCN_TOL = dict(rtol=1e-5, atol=1e-5)
DX_TOL = dict(rtol=1e-5, atol=1e-5)
DW_TOL = dict(rtol=1e-5, atol=1e-4)


#: the widths the card took only after its wide kernels: hidden 128 (w_hh^T
#: past a block's shared memory), and (K, C, H) past K <= 5 and C, H <= 64
WIDE_H = 128
WIDE_BDGCN = [dict(K=7, B=1, N=5, C=128, H=128), dict(K=9, B=2, N=5, C=16,
                                                      H=16)]
#: one support (K = 1) and channel widths C != H: the kernel's products by
#: Wr first, (K C, K H), then by G_d^T, (N, K N), at shapes whose axes differ
ODD_BDGCN = [dict(K=1, C=8, H=5), dict(K=3, C=12, H=5)]


def _cases(pairs):
    """(values, id) pairs as parametrize cases: the narrow cases keep the
    ids they had before the wide ones joined them."""
    return [pytest.param(*c, id=i) for c, i in pairs]


def _lstm_params(rng, F, H, layers):
    out = []
    for i in range(layers):
        f = F if i == 0 else H
        s = 1 / np.sqrt(H)
        out.append({k: rng.uniform(-s, s, shape).astype(np.float32)
                    for k, shape in (("w_ih", (4 * H, f)),
                                     ("w_hh", (4 * H, H)),
                                     ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))})
    return out


def _torch_lstm(params, F, H):
    mod = LSTM(F, H, len(params), torch.Generator().manual_seed(0))
    mod.load_state_dict({f"layers.{i}.{k}": torch.from_numpy(v)
                         for i, p in enumerate(params) for k, v in p.items()})
    return mod


@pytest.mark.parametrize("collect,H", _cases(
    [((c, 8), str(c)) for c in (False, True)]
    + [((c, WIDE_H), f"{c}-H128") for c in (False, True)]))
def test_lstm_layer_plain_matches_pallas(collect, H):
    rng = np.random.default_rng(0)
    T, R = 7, 50 if H == 8 else 24
    xp = rng.normal(size=(T, R, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    ref = pallas_lstm._fused_layer_infer(jnp.asarray(xp), jnp.asarray(w),
                                         collect, interpret=True)
    ours = cuda_lstm.lstm_layer_infer_plain(torch.from_numpy(xp),
                                            torch.from_numpy(w), collect)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LSTM_TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_stack_matches_pallas_inference(layers):
    rng = np.random.default_rng(layers)
    R, T, F, H = 64, 7, 1, 8
    params = _lstm_params(rng, F, H, layers)
    x = rng.normal(size=(R, T, F)).astype(np.float32)
    ref = pallas_lstm.lstm_last_step_fused(
        {"layers": [{k: jnp.asarray(v) for k, v in p.items()}
                    for p in params]},
        jnp.asarray(x), inference=True, interpret=True)
    mod = _torch_lstm(params, F, H)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fused = cuda_lstm.lstm_last_step_fused(mod.layers, xt)
        plain = cuda_lstm.lstm_last_step_fused(
            mod.layers, xt, layer_fn=cuda_lstm.lstm_layer_infer_plain)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), **LSTM_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **LSTM_TOL)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("H", [8, WIDE_H])
def test_lstm_fused_plain_matches_pallas(collect, F, H):
    """The fused form's plain version (projection from x, then the layer)
    against the JAX layer scan on the inference path: XLA's projection,
    then _fused_layer_infer in interpret mode. The weights cross by
    params_from_jax."""
    rng = np.random.default_rng(10 * H + F)
    T, R = 7, 40 if H == 8 else 24
    (layer,) = _lstm_params(rng, F, H, 1)
    seq = rng.normal(size=(R, T, F)).astype(np.float32)
    outs, (h_T, _) = pallas_lstm.fused_layer_scan(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(seq),
        collect, inference=True, interpret=True)
    ref = np.asarray(outs).transpose(1, 0, 2) if collect else np.asarray(h_T)
    sd = params_from_jax({"branches": [{
        "temporal": {"layers": [layer]}, "spatial": [],
        "fc": {"w": np.zeros((H, 1), np.float32),
               "b": np.zeros(1, np.float32)}}]})
    w = {k: sd[f"branches.0.temporal.layers.0.{k}"]
         for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    ours = cuda_lstm.lstm_layer_infer_fused_plain(
        torch.from_numpy(seq), w["w_ih"], w["b_ih"] + w["b_hh"],
        w["w_hh"].t(), collect)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, **LSTM_TOL)


def test_lstm_stack_takes_the_fused_form_for_narrow_inputs(monkeypatch):
    """On the inference kernel arm, lstm_last_step_fused sends the first
    layer (F = 1 <= FUSED_MAX_F) to the fused form, whose CPU version is
    lstm_layer_infer_fused_plain, and the second (F = H = 8) to x_proj;
    the plain and recorded arms never take it. The result is the plain
    arm's to the bit."""
    calls = []
    fused_plain = cuda_lstm.lstm_layer_infer_fused_plain

    def spy(x, w_ih, b, w_hh_T, collect):
        calls.append((tuple(x.shape), collect))
        return fused_plain(x, w_ih, b, w_hh_T, collect)

    monkeypatch.setattr(cuda_lstm, "lstm_layer_infer_fused_plain", spy)
    rng = np.random.default_rng(3)
    R, T, F, H = 20, 7, 1, 8
    mod = _torch_lstm(_lstm_params(rng, F, H, 2), F, H)
    xt = torch.from_numpy(rng.normal(size=(R, T, F)).astype(np.float32))
    with torch.no_grad():
        fused = cuda_lstm.lstm_last_step_fused(mod.layers, xt)
        assert calls == [((R, T, F), True)]
        plain = cuda_lstm.lstm_last_step_fused(
            mod.layers, xt, layer_fn=cuda_lstm.lstm_layer_infer_plain)
    recorded = cuda_lstm.lstm_last_step_fused(
        mod.layers, xt, layer_fn=cuda_lstm.lstm_layer_recorded)
    assert len(calls) == 1
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    torch.testing.assert_close(recorded.detach(), plain, rtol=0, atol=0)


def _bdgcn_inputs(rng, K=3, B=3, N=9, C=8, H=8, dynamic=False):
    h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
    g = rng.random((B if dynamic else 1, K, N, N)).astype(np.float32) / N
    w = (rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C)).astype(
        np.float32)
    return h1, g, w


@pytest.mark.parametrize("dynamic,wide", _cases(
    [((dyn, {}), str(dyn)) for dyn in (False, True)]
    + [((dyn, w), f"{dyn}-K{w['K']}-C{w['C']}-H{w['H']}")
       for w in WIDE_BDGCN + ODD_BDGCN for dyn in (False, True)]))
def test_bdgcn_plain_matches_pallas(dynamic, wide):
    h1, g, w = _bdgcn_inputs(np.random.default_rng(4), dynamic=dynamic,
                             **wide)
    ref = pallas_bdgcn.folded_pair_project(jnp.asarray(h1), jnp.asarray(g),
                                           jnp.asarray(w), interpret=True)
    ours = cuda_bdgcn.folded_pair_project_plain(
        torch.from_numpy(h1), torch.from_numpy(g), torch.from_numpy(w))
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BDGCN_TOL)


@pytest.mark.parametrize("dynamic,impl,shape", _cases(
    [((dyn, impl, None), f"{impl}-{dyn}") for impl in ("kernel", "einsum")
     for dyn in (False, True)]
    + [((dyn, impl, w), f"{impl}-{dyn}-K{w['K']}-C{w['C']}-H{w['H']}")
       for w in ODD_BDGCN + WIDE_BDGCN[:1] for impl in ("kernel", "einsum")
       for dyn in (False, True)]))
def test_bdgcn_apply_arms_match_jax(dynamic, impl, shape):
    rng = np.random.default_rng(5)
    B, N, C, H, K = 2, 7, 8, 8, 3
    w_scale = 8.0
    if shape is not None:  # O(1) outputs at every K^2 C
        C, H, K = shape["C"], shape["H"], shape["K"]
        w_scale = np.sqrt(K * K * C)
    X = rng.normal(size=(B, N, N, C)).astype(np.float32)
    gs = rng.random((B, K, N, N)).astype(np.float32) / N
    W = (rng.normal(size=(K * K * C, H)) / w_scale).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    G = (gs, gs[::-1].copy()) if dynamic else gs[0]
    ref = jax_bdgcn_apply({"W": jnp.asarray(W), "b": jnp.asarray(b)},
                          jnp.asarray(X),
                          tuple(map(jnp.asarray, G)) if dynamic
                          else jnp.asarray(G), impl="einsum")
    layer = BDGCN(K, C, H, True, torch.Generator().manual_seed(0))
    layer.load_state_dict({"W": torch.from_numpy(W),
                           "b": torch.from_numpy(b)})
    Gt = (tuple(map(torch.from_numpy, G)) if dynamic
          else torch.from_numpy(G))
    with torch.no_grad():
        ours = bdgcn_apply(layer, torch.from_numpy(X), Gt, impl=impl)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BDGCN_TOL)


@pytest.mark.parametrize("dynamic", [False, True])
def test_bdgcn_plain_order_matches_pair_first_sum(dynamic):
    """The plain version projects by Wr first, as the kernel does; in
    float64 that equals the TPU kernel's pair-first sum
    sum_{o, d} (h1[o]^T G_d)^T Wr[o, d] to rounding."""
    h1, g, w = (torch.from_numpy(a).double() for a in _bdgcn_inputs(
        np.random.default_rng(14), K=4, C=6, H=5, dynamic=dynamic))
    K = h1.shape[0]
    ref = torch.zeros(h1.shape[1:4] + (w.shape[-1],), dtype=torch.float64)
    for o in range(K):
        for d in range(K):
            gd, gs = (g[:, d], "bce") if dynamic else (g[0, d], "ce")
            t = torch.einsum(f"bmcl,{gs}->bmle", h1[o], gd)
            ref += torch.einsum("bmle,lh->bmeh", t, w[o, d])
    torch.testing.assert_close(cuda_bdgcn.folded_pair_project_plain(h1, g, w),
                               ref, rtol=1e-12, atol=1e-12)


def _lstm_train_inputs(rng, T=7, R=50, H=8):
    xp = rng.normal(size=(T, R, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xp, w


def test_lstm_train_plain_matches_pallas_fwd():
    xp, w = _lstm_train_inputs(np.random.default_rng(7))
    hs_ref, cs_ref = pallas_lstm._fused_layer_fwd_impl(
        jnp.asarray(xp), jnp.asarray(w), interpret=True)
    hs, cs = cuda_lstm.lstm_layer_train_plain(torch.from_numpy(xp),
                                              torch.from_numpy(w))
    assert tuple(hs.shape) == hs_ref.shape and tuple(cs.shape) == cs_ref.shape
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), **LSTM_TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_ref), **LSTM_TOL)


@pytest.mark.parametrize("with_dcs,ref,H,T", _cases(
    [((dcs, ref, 8, 7), f"{dcs}-{ref}") for dcs in (False, True)
     for ref in ("pallas", "xla")]
    + [((dcs, "pallas", WIDE_H, 7), f"{dcs}-pallas-H128")
       for dcs in (False, True)]
    # one step (no recurrent product, no dW depth) at the engine path's
    # width; H = 97, whose hs rows are not 16-byte aligned
    + [((dcs, "pallas", WIDE_H, 1), f"{dcs}-pallas-H128-T1")
       for dcs in (False, True)]
    + [((dcs, "pallas", 97, 3), f"{dcs}-pallas-H97-T3")
       for dcs in (False, True)]))
def test_lstm_bwd_plain_matches_jax(ref, with_dcs, H, T):
    """The plain training forward and BPTT against the Pallas kernels (and
    the BPTT against the XLA backward)."""
    rng = np.random.default_rng(8)
    xp, w = _lstm_train_inputs(rng, T=T, R=50 if H == 8 else 24, H=H)
    hs, cs = (np.array(a) for a in pallas_lstm._fused_layer_fwd_impl(
        jnp.asarray(xp), jnp.asarray(w), interpret=True))
    for ours, theirs in zip(cuda_lstm.lstm_layer_train_plain(
            torch.from_numpy(xp), torch.from_numpy(w)), (hs, cs)):
        np.testing.assert_allclose(ours.numpy(), theirs, **LSTM_TOL)
    dhs = rng.normal(size=hs.shape).astype(np.float32)
    dcs = (rng.normal(size=hs.shape) if with_dcs
           else np.zeros(hs.shape)).astype(np.float32)
    h_prev = np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])
    c_prev = np.concatenate([np.zeros_like(cs[:1]), cs[:-1]])
    args = [jnp.asarray(a) for a in (xp, w, h_prev, c_prev, cs, dhs, dcs)]
    if ref == "pallas":
        dxp_ref, dw_ref = pallas_lstm._fused_layer_bwd_pallas(True, *args)
    else:
        dxp_ref, dw_ref = pallas_lstm._fused_layer_bwd_xla(*args)
    t = torch.from_numpy
    dxp, dw = cuda_lstm.lstm_layer_bwd_plain(
        t(xp), t(w), t(hs), t(cs), t(dhs), t(dcs) if with_dcs else None)
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dxp_ref), **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **DW_TOL)


def _lstm_bwd_engine_order(xp, w, hs, cs, dhs, dcs):
    """The BPTT in the order of the card's engine path (csrc/lstm_train.cu,
    H > 81): (1) the recurrent pre-activations of every t >= 1 as one
    product over the (T-1) R rows of hs; (2) for t = T-1..0 the cell's
    backward from x_proj_t + pre_t, then (3) dh_{t-1} = dgates_t W_hh for
    t >= 1; (4) dW_hh^T as one product of hs rows 0..T-2 and dgates rows
    R..TR over all (T-1) R of them."""
    T, R, G = xp.shape
    H = G // 4
    pre = torch.zeros_like(xp)
    pre[1:] = (hs[:-1].reshape(-1, H) @ w).reshape(T - 1, R, G)
    dxp = torch.empty_like(xp)
    dh = dc = torch.zeros((R, H), dtype=xp.dtype)
    for t in reversed(range(T)):
        a = xp[t] + pre[t]
        i, f = torch.sigmoid(a[:, :H]), torch.sigmoid(a[:, H:2 * H])
        g, o = torch.tanh(a[:, 2 * H:3 * H]), torch.sigmoid(a[:, 3 * H:])
        cp = cs[t - 1] if t > 0 else torch.zeros_like(dh)
        dhv = dh + (dhs[t] if dhs is not None else 0)
        dcv = dc + (dcs[t] if dcs is not None else 0)
        tc = torch.tanh(cs[t])
        dct = dcv + dhv * o * (1 - tc * tc)
        dc = dct * f
        dxp[t] = torch.cat([dct * g * i * (1 - i), dct * cp * f * (1 - f),
                            dct * i * (1 - g * g),
                            dhv * tc * o * (1 - o)], dim=-1)
        if t > 0:
            dh = dxp[t] @ w.t()
    dw = hs[:-1].reshape(-1, H).t() @ dxp[1:].reshape(-1, G)
    return dxp, dw


@pytest.mark.parametrize("T,R,H,with_dcs", [(7, 13, 12, False),
                                            (7, 13, 12, True),
                                            (1, 9, 8, True),
                                            (3, 5, 97, False)])
def test_lstm_bwd_engine_order_matches_plain(T, R, H, with_dcs):
    """In float64 the engine path's order of the BPTT (gates from hs in one
    product, the reverse loop of cell backward and dh, dW in one product
    over all rows) computes what lstm_layer_bwd_plain computes step by
    step, to 1e-12."""
    rng = np.random.default_rng(T * 100 + H)
    xp = torch.from_numpy(rng.normal(size=(T, R, 4 * H)))
    w = torch.from_numpy(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    hs, cs = cuda_lstm.lstm_layer_train_plain(xp, w)
    dhs = torch.from_numpy(rng.normal(size=(T, R, H)))
    dcs = torch.from_numpy(rng.normal(size=(T, R, H))) if with_dcs else None
    dxp, dw = _lstm_bwd_engine_order(xp, w, hs, cs, dhs, dcs)
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, dcs)
    torch.testing.assert_close(dxp, dxr, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, dwr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dynamic,ref,wide", _cases(
    [((dyn, ref, {}), f"{dyn}-{ref}") for dyn in (False, True)
     for ref in ("pallas", "xla")]
    + [((dyn, "pallas", w), f"{dyn}-pallas-K{w['K']}-C{w['C']}-H{w['H']}")
       for w in WIDE_BDGCN for dyn in (False, True)]))
def test_bdgcn_bwd_plain_matches_jax(ref, dynamic, wide):
    rng = np.random.default_rng(9)
    h1, g, w = _bdgcn_inputs(rng, dynamic=dynamic, **wide)
    dout = rng.normal(size=h1.shape[1:4] + (w.shape[-1],)).astype(np.float32)
    args = [jnp.asarray(a) for a in (h1, g, w, dout)]
    if ref == "pallas":
        dh1_ref, dw_ref = pallas_bdgcn._bwd_pallas(*args, interpret=True)
    else:
        dh1_ref, dw_ref = pallas_bdgcn._bwd_xla(*args)
    dh1, dw = cuda_bdgcn.folded_pair_project_bwd_plain(
        *map(torch.from_numpy, (h1, g, w, dout)))
    np.testing.assert_allclose(dh1.numpy(), np.asarray(dh1_ref), **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **DW_TOL)


@pytest.mark.parametrize("out", ["hs_and_cs", "last_h"])
def test_lstm_layer_fn_gradcheck(out):
    rng = np.random.default_rng(10)
    xp = torch.from_numpy(rng.normal(size=(3, 5, 16))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(4, 16)) / 2).requires_grad_()

    def fn(x, ww):
        hs, cs = cuda_lstm.LSTMLayerFn.apply(x, ww)
        return (hs, cs) if out == "hs_and_cs" else hs[-1]

    assert torch.autograd.gradcheck(fn, (xp, w))


@pytest.mark.parametrize("dynamic", [False, True])
def test_pair_project_fn_gradcheck(dynamic):
    rng = np.random.default_rng(11)
    K, B, N, C, H = 3, 2, 4, 3, 2
    h1 = torch.from_numpy(rng.normal(size=(K, B, N, N, C))).requires_grad_()
    g = torch.from_numpy(rng.random((B if dynamic else 1, K, N, N))
                         ).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(K, K, C, H))).requires_grad_()
    assert torch.autograd.gradcheck(cuda_bdgcn.PairProjectFn.apply,
                                    (h1, g, w))


def test_folded_pair_project_records_through_pair_project_fn():
    h1, g, w = map(torch.from_numpy, _bdgcn_inputs(np.random.default_rng(12)))
    out = cuda_bdgcn.folded_pair_project(h1.requires_grad_(), g, w)
    assert type(out.grad_fn).__name__ == "PairProjectFnBackward"
    with torch.no_grad():
        assert cuda_bdgcn.folded_pair_project(h1, g, w).grad_fn is None


def test_cpu_wrappers_take_plain_version_without_launching():
    rng = np.random.default_rng(6)
    xp = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    h1, g, wr = map(torch.from_numpy, _bdgcn_inputs(rng))
    kernels = (cuda_lstm.LSTM_INFER_LAST, cuda_lstm.LSTM_INFER_COLLECT,
               cuda_lstm.LSTM_TRAIN_FWD, cuda_lstm.LSTM_TRAIN_BWD,
               cuda_bdgcn.BDGCN_PAIR_FWD, cuda_bdgcn.BDGCN_PAIR_BWD)
    before = [k.launches for k in kernels]
    x = torch.from_numpy(rng.normal(size=(5, 3, 2)).astype(np.float32))
    w_ih = torch.from_numpy(rng.normal(size=(16, 2)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    for collect in (False, True):
        torch.testing.assert_close(
            cuda_lstm.lstm_layer_infer(xp, w, collect),
            cuda_lstm.lstm_layer_infer_plain(xp, w, collect), rtol=0,
            atol=0)
        torch.testing.assert_close(
            cuda_lstm.lstm_layer_infer_fused(x, w_ih, b, w, collect),
            cuda_lstm.lstm_layer_infer_fused_plain(x, w_ih, b, w, collect),
            rtol=0, atol=0)
    torch.testing.assert_close(
        cuda_bdgcn.folded_pair_project(h1, g, wr),
        cuda_bdgcn.folded_pair_project_plain(h1, g, wr), rtol=0, atol=0)
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    for a, b in zip((hs, cs), cuda_lstm.lstm_layer_train_plain(xp, w)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, hs, None),
                    cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, hs, None)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dout = torch.ones((3, 9, 9, 8))
    for a, b in zip(cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout),
                    cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, wr,
                                                             dout)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert before == [k.launches for k in kernels]


@pytest.mark.parametrize("H,collect,shape", [
    (128, False, (2, 5, 128)), (128, True, (1, 5, 128)), (32, False, None)])
def test_fwd_scratch_shape_follows_the_kernel(monkeypatch, H, collect,
                                              shape):
    """The inference entries' scratch: (2, R, H) for h_T only (the c carry
    and a second h buffer), (1, R, H) for every h_t (the c carry), where
    the card's forwards take the wide kernel; none on the resident one."""
    monkeypatch.setattr(cuda_lstm, "device_index", lambda device: 0)
    monkeypatch.setattr(cuda_lstm, "fwd_on_wide",
                        lambda index, width: width > 116)
    scratch = cuda_lstm.fwd_scratch(5, H, torch.device("cpu"), collect)
    if shape is None:
        assert scratch is None
    else:
        assert scratch.shape == shape and scratch.dtype == torch.float32


def test_dw_reduce_cpu_takes_plain_version():
    """On the CPU the two backward entries that sum their dW partials in
    their own launch on the card take their plain versions, without a
    launch: dW comes in one piece (its partials are dW[None]), and
    dw_reduce_plain, the plain version of the kernels' sum, adds partials
    in order p = 0, 1, ..."""
    rng = np.random.default_rng(13)
    xp = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    hs, cs = cuda_lstm.lstm_layer_train_plain(xp, w)
    h1, g, wr = map(torch.from_numpy, _bdgcn_inputs(rng))
    dout = torch.from_numpy(rng.normal(size=(3, 9, 9, 8)).astype(
        np.float32))
    kernels = (cuda_lstm.LSTM_TRAIN_BWD, cuda_bdgcn.BDGCN_PAIR_BWD)
    before = [k.launches for k in kernels]
    for (*_, dw, part), (_, ref) in (
            (cuda_lstm.lstm_layer_bwd_partials(xp, w, hs, cs, hs, None),
             cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, hs, None)),
            (cuda_bdgcn.folded_pair_project_bwd_partials(h1, g, wr, dout),
             cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, wr, dout))):
        assert part.shape == (1, *dw.shape)
        torch.testing.assert_close(dw, ref, rtol=0, atol=0)
        torch.testing.assert_close(cuda_lstm.dw_reduce_plain(part), dw,
                                   rtol=0, atol=0)
    assert before == [k.launches for k in kernels]
    part = torch.from_numpy(rng.normal(size=(30, 3, 3, 4, 5)).astype(
        np.float32))
    ordered = part[0].clone()
    for p in range(1, 30):
        ordered = ordered + part[p]
    torch.testing.assert_close(cuda_lstm.dw_reduce_plain(part), ordered,
                               rtol=0, atol=0)
    # f32 sums of 30 O(1) terms in another order
    torch.testing.assert_close(cuda_lstm.dw_reduce_plain(part), part.sum(0),
                               rtol=1e-5, atol=1e-5)


def test_non_cuda_non_cpu_tensors_raise():
    xp = torch.zeros((2, 3, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_infer(xp, torch.zeros((2, 8), device="meta"),
                                   False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_infer_fused(
            torch.zeros((3, 2, 1), device="meta"),
            torch.zeros((8, 1), device="meta"),
            torch.zeros((8,), device="meta"),
            torch.zeros((2, 8), device="meta"), False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_train(xp, torch.zeros((2, 8), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_bwd(xp, torch.zeros((2, 8), device="meta"),
                                 None, None, None, None)
    h1 = torch.zeros((3, 1, 4, 4, 2), device="meta")
    g = torch.zeros((1, 3, 4, 4), device="meta")
    wr = torch.zeros((3, 3, 2, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_bdgcn.folded_pair_project(h1, g, wr)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_bdgcn.folded_pair_project_bwd(
            h1, g, wr, torch.zeros((1, 4, 4, 2), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_bwd_partials(
            xp, torch.zeros((2, 8), device="meta"), None, None, None, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_bdgcn.folded_pair_project_bwd_partials(
            h1, g, wr, torch.zeros((1, 4, 4, 2), device="meta"))
