"""The port's fused epilogues against the JAX package's (``fused_epilogue``,
mpgcn_tpu/nn/fused.py) on the CPU: each BDGCN arm that takes the knob
(einsum, folded, csr, and ell on the plain ELL versions) fused, forward
and W and X gradients, static and dynamic, against JAX ``bdgcn_apply(...,
fused=True)`` and against the port's own unfused arm; the stacked LSTM
gate scan against JAX ``stacked_lstm_last_step``; the whole model with
``-lstm plain`` and the fused epilogue against ``mpgcn_apply(...,
fused_epilogue=True)``, forward and gradients, remat too; ``lazy_quant``
(an int8 tree dequantised at each use site) against the JAX fused int8
path (tests/test_overlap.py:166-182 holds the same pair inside JAX); and
the ``kernel`` arm and the LSTM kernels unchanged by the knob.

Sizes: the BDGCN layer at K=3, B=2, N=12, C=4, H=5; the model at N=8,
hidden 8, M=2 (static and dynamic graphs), seed 0 (live head asserted).

Tolerances, f32 in other summation orders: forwards rtol 1e-4 / atol
1e-5; gradients rtol 1e-4 / atol 1e-4; fused against unfused forward
rtol 2e-5 / atol 1e-5 and gradients rtol 2e-3 / atol 2e-4 (the JAX
package's own pins for the same reassociation, tests/test_overlap.py);
the kernel arm with and without the knob bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.nn import fused as jax_fused
from mpgcn_tpu.nn.mpgcn import init_mpgcn, mpgcn_apply
from mpgcn_tpu.quant.int8 import quantize_params as jax_quantize
from mpgcn_tpu.sparse import formats as jax_formats
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn import fused, mpgcn as port_mpgcn
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.quant.int8 import QuantizedTensor, quantize_params
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils.convert import params_from_jax
from tests.torch_layer_common import run_layer

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
FUSED_FWD_TOL = dict(rtol=2e-5, atol=1e-5)
FUSED_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
NM, HM, BM = 8, 8, 4


# --- the BDGCN epilogues -----------------------------------------------------


@pytest.mark.parametrize("impl", ["einsum", "folded", "csr", "ell"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_fused_arm_matches_jax(impl, dynamic):
    (out, dW, dX), (ref, rW, rX) = run_layer(impl, dynamic, fused=True)
    assert (ref != 0).mean() > 0.3
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(dW, rW, **GRAD_TOL)
    np.testing.assert_allclose(dX, rX, **GRAD_TOL)


@pytest.mark.parametrize("impl", ["einsum", "folded", "csr", "ell"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_fused_arm_matches_unfused(impl, dynamic):
    fused_run, _ = run_layer(impl, dynamic, fused=True)
    plain_run, _ = run_layer(impl, dynamic, fused=False)
    np.testing.assert_allclose(fused_run[0], plain_run[0], **FUSED_FWD_TOL)
    for a, b in zip(fused_run[1:], plain_run[1:]):
        np.testing.assert_allclose(a, b, **FUSED_GRAD_TOL)


def test_sparse_fused_epilogue_runs_one_destination_spmm(monkeypatch):
    """The fused sparse layer runs 2 SpMMs (origin, then destination over
    the stacked origins, K B N C wide) where the unfused runs 1 + K, and
    its backward runs the destination SpMM again (the checkpoint)."""
    from mpgcn_tpu_torch.sparse import kernels

    widths = []
    real = kernels.ell_spmm
    monkeypatch.setattr(kernels, "ell_spmm", lambda G, X: (
        widths.append(X.shape[-1]), real(G, X))[1])
    for fused_on in (False, True):
        widths.clear()
        run_layer("ell", False, fused=fused_on)
        # the port's forward and backward in run_layer: B N C = 96
        # columns an origin, K of them stacked
        want = ([96, 288, 288] if fused_on else [96, 96, 96, 96])
        assert widths == want, (fused_on, widths)


# --- the stacked LSTM scan ---------------------------------------------------


def _lstm_layers(rng, M, F, Hh, n_layers):
    out = []
    for _ in range(M):
        layers = []
        for i in range(n_layers):
            fin = F if i == 0 else Hh
            layers.append({k: (rng.normal(size=s) / 3).astype(np.float32)
                           for k, s in (("w_ih", (4 * Hh, fin)),
                                        ("w_hh", (4 * Hh, Hh)),
                                        ("b_ih", (4 * Hh,)),
                                        ("b_hh", (4 * Hh,)))})
        out.append(layers)
    return out


class _Layer:
    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, torch.from_numpy(v))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_stacked_lstm_matches_jax(n_layers):
    rng = np.random.default_rng(11)
    M, R, T, F, Hh = 2, 37, 7, 1, 8
    branches = _lstm_layers(rng, M, F, Hh, n_layers)
    x = rng.normal(size=(R, T, F)).astype(np.float32)
    stack = {"layers": [
        {k: jnp.stack([jnp.asarray(b[i][k]) for b in branches])
         for k in branches[0][i]} for i in range(n_layers)]}
    ref = np.asarray(jax_fused.stacked_lstm_last_step(stack, jnp.asarray(x)))
    ours = fused.stacked_lstm_last_step(
        [[_Layer(d) for d in b] for b in branches], torch.from_numpy(x))
    assert tuple(ours.shape) == ref.shape == (M, R, Hh)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_fused_origin_project_matches_jax():
    rng = np.random.default_rng(12)
    K, B, N, C, H = 3, 2, 6, 4, 5
    h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
    Wr = rng.normal(size=(K, K, C, H)).astype(np.float32)
    for G, fn in ((rng.normal(size=(K, N, N)), "static"),
                  (rng.normal(size=(B, K, N, N)), "dynamic")):
        G = G.astype(np.float32)
        name = f"fused_origin_project_{fn}"
        ref = getattr(jax_fused, name)(jnp.asarray(h1), jnp.asarray(G),
                                       jnp.asarray(Wr))
        ours = getattr(fused, name)(torch.from_numpy(h1),
                                    torch.from_numpy(G),
                                    torch.from_numpy(Wr))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


# --- the model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    kw = dict(synthetic_T=60, synthetic_N=NM, hidden_dim=HM, seed=0)
    cfg = MPGCNConfig(**kw).replace(num_nodes=NM)
    data = synthetic_dataset(cfg)
    jp = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    md = jp.modes["test"]
    x = np.ascontiguousarray(md.x[:BM])
    keys = md.keys[:BM]
    params = init_mpgcn(jax.random.PRNGKey(0), M=2, K=cfg.support_K,
                        input_dim=1, lstm_hidden_dim=HM, lstm_num_layers=1,
                        gcn_hidden_dim=HM, gcn_num_layers=3)
    dense = {"static": jp.static_supports, "o": jp.o_support_bank[keys],
             "d": jp.d_support_bank[keys]}
    return cfg, data, params, x, keys, dense


def _jax_graphs(dense, impl):
    g = {k: (jax_formats.sparsify_support_stack(v, impl)
             if impl in ("csr", "ell") else jnp.asarray(v))
         for k, v in dense.items()}
    return [g["static"], (g["o"], g["d"])]


def _port(case, impl, lstm_impl="plain", **kw):
    cfg, data, params, x, keys, _ = case
    model = MPGCN.from_config(cfg.replace(**kw), device="cpu",
                              lstm_impl=lstm_impl, bdgcn_impl=impl)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    banks = DataPipeline(cfg, data, "cpu", bdgcn_impl=impl).banks
    return model, graphs_for(banks, torch.from_numpy(keys).long(),
                             model.sources)


@pytest.mark.parametrize("impl", ["einsum", "folded", "csr", "ell"])
def test_fused_model_matches_jax(case, impl):
    """Forward and every parameter's gradient of the model with the
    stacked LSTM scan and the fused epilogue (and under remat the same)."""
    _, _, params, x, _, dense = case
    graphs = _jax_graphs(dense, impl)

    def loss(p):
        return (mpgcn_apply(p, jnp.asarray(x), graphs, bdgcn_impl=impl,
                            fused_epilogue=True) ** 2).sum()

    ref = np.asarray(mpgcn_apply(params, jnp.asarray(x), graphs,
                                 bdgcn_impl=impl, fused_epilogue=True,
                                 inference=True))
    assert (ref != 0).mean() > 0.1, "dead ReLU head: parity would be vacuous"
    grads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    for remat in (False, True):
        model, tg = _port(case, impl, fused_epilogue=True, remat=remat)
        out = model(torch.from_numpy(x), tg, inference=False)
        np.testing.assert_allclose(out.detach().numpy(), ref, **FWD_TOL)
        (out ** 2).sum().backward()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_stacked_scan_runs_only_under_plain_lstm(case, monkeypatch):
    calls = []
    real = port_mpgcn.stacked_lstm_last_step
    monkeypatch.setattr(port_mpgcn, "stacked_lstm_last_step",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(case[3])
    for lstm_impl, want in (("plain", 1), ("kernel", 0)):
        calls.clear()
        model, tg = _port(case, "einsum", lstm_impl, fused_epilogue=True)
        model(x, tg)
        assert len(calls) == want, lstm_impl


def test_lstm_kernels_ignore_the_knob(case):
    x = torch.from_numpy(case[3])
    a, tg = _port(case, "kernel", "kernel", fused_epilogue=True)
    b, _ = _port(case, "kernel", "kernel")
    for inference in (True, False):
        assert torch.equal(a(x, tg, inference=inference),
                           b(x, tg, inference=inference))


@pytest.mark.parametrize("impl", ["einsum", "folded", "csr", "ell"])
def test_lazy_quant_matches_the_jax_fused_int8_path(case, impl, monkeypatch):
    """An int8 tree under the fused epilogue with the plain LSTM: the port
    keeps the codes to each use site (no up-front dequantize) and matches
    the JAX fused int8 forward and the port's own up-front path."""
    _, _, params, x, _, dense = case
    qp = jax_quantize(params)
    ref = np.asarray(mpgcn_apply(qp, jnp.asarray(x), _jax_graphs(dense, impl),
                                 bdgcn_impl=impl, fused_epilogue=True,
                                 inference=True))
    model, tg = _port(case, impl, fused_epilogue=True)
    qtree = quantize_params(dict(model.named_parameters()))
    assert any(isinstance(v, QuantizedTensor) for v in qtree.values())
    seen = []
    real = port_mpgcn.dequantize_params
    monkeypatch.setattr(port_mpgcn, "dequantize_params",
                        lambda t: seen.append(1) or real(t))
    out = model(torch.from_numpy(x), tg, params=qtree)
    assert not seen, "the lazy path dequantized the whole tree up front"
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    eager, _ = _port(case, impl)
    up_front = eager(torch.from_numpy(x), tg, params=qtree)
    assert seen
    np.testing.assert_allclose(out.numpy(), up_front.numpy(),
                               **FUSED_FWD_TOL)


def test_kernel_arm_ignores_the_knob_and_dequantizes_up_front(case):
    x = torch.from_numpy(case[3])
    a, tg = _port(case, "kernel", fused_epilogue=True)
    b, _ = _port(case, "kernel")
    assert not a._lazy_quant(quantize_params(dict(a.named_parameters())))
    assert torch.equal(a(x, tg), b(x, tg))
    q = quantize_params(dict(a.named_parameters()))
    assert torch.equal(a(x, tg, params=q), b(x, tg, params=q))
