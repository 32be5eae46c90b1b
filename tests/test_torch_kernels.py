"""K-LSTM and K-BDGCN: the plain versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as the JAX tests run them), and
the wrappers' device dispatch. The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda.py.

Tolerances: f32 on both sides with different summation orders.
K-LSTM rtol 1e-5 / atol 1e-6 (outputs are tanh-bounded); K-BDGCN rtol 1e-5
/ atol 1e-5 (sums of K^2 N C products of O(1) values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.nn import pallas_bdgcn, pallas_lstm
from mpgcn_tpu.nn.bdgcn import bdgcn_apply as jax_bdgcn_apply
from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
from mpgcn_tpu_torch.nn.bdgcn import BDGCN, bdgcn_apply
from mpgcn_tpu_torch.nn.lstm import LSTM

LSTM_TOL = dict(rtol=1e-5, atol=1e-6)
BDGCN_TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("collect", [False, True])
def test_lstm_layer_plain_matches_pallas(collect):
    rng = np.random.default_rng(0)
    T, R, H = 7, 50, 8
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


def _bdgcn_inputs(rng, K=3, B=3, N=9, C=8, H=8, dynamic=False):
    h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
    g = rng.random((B if dynamic else 1, K, N, N)).astype(np.float32) / N
    w = (rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C)).astype(
        np.float32)
    return h1, g, w


@pytest.mark.parametrize("dynamic", [False, True])
def test_bdgcn_plain_matches_pallas(dynamic):
    h1, g, w = _bdgcn_inputs(np.random.default_rng(4), dynamic=dynamic)
    ref = pallas_bdgcn.folded_pair_project(jnp.asarray(h1), jnp.asarray(g),
                                           jnp.asarray(w), interpret=True)
    ours = cuda_bdgcn.folded_pair_project_plain(
        torch.from_numpy(h1), torch.from_numpy(g), torch.from_numpy(w))
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BDGCN_TOL)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_bdgcn_apply_arms_match_jax(dynamic, impl):
    rng = np.random.default_rng(5)
    B, N, C, H, K = 2, 7, 8, 8, 3
    X = rng.normal(size=(B, N, N, C)).astype(np.float32)
    gs = rng.random((B, K, N, N)).astype(np.float32) / N
    W = (rng.normal(size=(K * K * C, H)) / 8).astype(np.float32)
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


def test_cpu_wrappers_take_plain_version_without_launching():
    rng = np.random.default_rng(6)
    xp = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    h1, g, wr = map(torch.from_numpy, _bdgcn_inputs(rng))
    before = (cuda_lstm.LSTM_INFER_LAST.launches,
              cuda_lstm.LSTM_INFER_COLLECT.launches,
              cuda_bdgcn.BDGCN_PAIR_FWD.launches)
    for collect in (False, True):
        torch.testing.assert_close(
            cuda_lstm.lstm_layer_infer(xp, w, collect),
            cuda_lstm.lstm_layer_infer_plain(xp, w, collect), rtol=0,
            atol=0)
    torch.testing.assert_close(
        cuda_bdgcn.folded_pair_project(h1, g, wr),
        cuda_bdgcn.folded_pair_project_plain(h1, g, wr), rtol=0, atol=0)
    assert before == (cuda_lstm.LSTM_INFER_LAST.launches,
                      cuda_lstm.LSTM_INFER_COLLECT.launches,
                      cuda_bdgcn.BDGCN_PAIR_FWD.launches)


def test_non_cuda_non_cpu_tensors_raise():
    xp = torch.zeros((2, 3, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_lstm.lstm_layer_infer(xp, torch.zeros((2, 8), device="meta"),
                                   False)
    h1 = torch.zeros((3, 1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_bdgcn.folded_pair_project(
            h1, torch.zeros((1, 3, 4, 4), device="meta"),
            torch.zeros((3, 3, 2, 2), device="meta"))
