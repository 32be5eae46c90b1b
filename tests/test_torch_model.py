"""The port's MPGCN forward against the JAX package's
``mpgcn_apply(lstm_impl="pallas", bdgcn_impl="pallas", inference=True)``
at M=2 (static + dynamic graphs), with the JAX weights carried across by
``params_from_jax``. The Pallas kernels run in interpret mode on the CPU.

Tolerance rtol 1e-4 / atol 1e-5: f32 throughout, and the summation order
differs in every contraction of a 3-layer BDGCN stack. Seed 0 gives a live
ReLU head at these widths, and the tests assert it: an all-zero output
would make every comparison pass trivially."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.nn.bdgcn import bdgcn_apply as jax_bdgcn_apply
from mpgcn_tpu.nn.mpgcn import init_mpgcn, mpgcn_apply
from mpgcn_tpu.nn.pallas_lstm import lstm_last_step_fused as jax_lstm_fused
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils.convert import params_from_jax

N, H, B = 8, 8, 4
TOL = dict(rtol=1e-4, atol=1e-5)
#: hidden 128 and dual_random_walk_diffusion of order 3 (K = 7 supports) at
#: N = 6: the widths the card takes only through its wide kernels
WIDE = dict(synthetic_N=6, hidden_dim=128,
            kernel_type="dual_random_walk_diffusion", cheby_order=3)


def _setup(layers, seed=0, **wide):
    kw = {**dict(synthetic_T=60, synthetic_N=N, hidden_dim=H,
                 lstm_num_layers=layers, seed=seed), **wide}
    cfg = MPGCNConfig(**kw).replace(num_nodes=kw["synthetic_N"])
    data = synthetic_dataset(cfg)
    jp = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    md = jp.modes["test"]
    x = np.ascontiguousarray(md.x[:B])
    keys = md.keys[:B]
    graphs = [jnp.asarray(jp.static_supports),
              (jnp.asarray(jp.o_support_bank[keys]),
               jnp.asarray(jp.d_support_bank[keys]))]
    params = init_mpgcn(jax.random.PRNGKey(seed), M=2, K=cfg.support_K,
                        input_dim=1, lstm_hidden_dim=cfg.hidden_dim,
                        lstm_num_layers=layers,
                        gcn_hidden_dim=cfg.hidden_dim, gcn_num_layers=3)
    return cfg, data, params, x, keys, graphs


def _port(cfg, data, params, keys, **kw):
    model = MPGCN.from_config(cfg, device="cpu", **kw)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    banks = DataPipeline(cfg, data, device="cpu").banks
    return model, graphs_for(banks, torch.from_numpy(keys).long(),
                             model.sources)


def _jax_prehead(params, x, graphs):
    """Each branch's BDGCN-stack output before the FC head (JAX)."""
    Bx, T, n, _, i = x.shape
    lstm_in = jnp.asarray(x).transpose(0, 2, 3, 1, 4).reshape(-1, T, i)
    out = []
    for br, G in zip(params["branches"], graphs):
        h = jax_lstm_fused(br["temporal"], lstm_in, inference=True,
                           interpret=True).reshape(Bx, n, n, -1)
        for layer in br["spatial"]:
            h = jax_bdgcn_apply(layer, h, G, activation=jax.nn.relu,
                                impl="pallas")
        out.append(np.asarray(h))
    return out


@pytest.mark.parametrize("layers,wide", [
    pytest.param(1, {}, id="1"), pytest.param(2, {}, id="2"),
    pytest.param(1, WIDE, id="1-hidden128-K7")])
def test_forward_matches_jax_pallas_inference(layers, wide):
    cfg, data, params, x, keys, graphs = _setup(layers, **wide)
    n = cfg.num_nodes
    ref = np.asarray(jax.jit(lambda p, xx, g: mpgcn_apply(
        p, xx, g, lstm_impl="pallas", bdgcn_impl="pallas",
        inference=True))(params, jnp.asarray(x), graphs))
    model, tgraphs = _port(cfg, data, params, keys)
    out, hidden = model(torch.from_numpy(x), tgraphs, return_hidden=True)
    assert tuple(out.shape) == ref.shape == (B, 1, n, n, 1)
    assert (ref != 0).mean() > 0.1, "dead ReLU head: parity would be vacuous"
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for h, r in zip(hidden, _jax_prehead(params, x, graphs)):
        assert (r != 0).mean() > 0.1
        np.testing.assert_allclose(h.numpy(), r, **TOL)


def test_plain_arms_match_kernel_arms():
    cfg, data, params, x, keys, _ = _setup(2)
    kernel, graphs = _port(cfg, data, params, keys)
    plain, _ = _port(cfg, data, params, keys, lstm_impl="plain",
                     bdgcn_impl="einsum")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(plain(xt, graphs).numpy(),
                               kernel(xt, graphs).numpy(), **TOL)


def test_params_from_jax_layout():
    params = jax.tree_util.tree_map(np.asarray, init_mpgcn(
        jax.random.PRNGKey(1), M=2, K=3, input_dim=1, lstm_hidden_dim=H,
        lstm_num_layers=2, gcn_hidden_dim=H, gcn_num_layers=3))
    sd = params_from_jax(params)
    model = MPGCN(M=2, K=3, input_dim=1, hidden_dim=H, lstm_num_layers=2,
                  gcn_num_layers=3, device="cpu")
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape and v.dtype == torch.float32, k
    fc = params["branches"][1]["fc"]
    np.testing.assert_array_equal(sd["branches.1.fc.weight"].numpy(),
                                  fc["w"].T)
    np.testing.assert_array_equal(
        sd["branches.0.spatial.2.W"].numpy(),
        params["branches"][0]["spatial"][2]["W"])


def test_seeded_init_is_reproducible_and_shaped():
    a = MPGCN(M=2, K=3, input_dim=1, hidden_dim=H, lstm_num_layers=1,
              gcn_num_layers=3, seed=5, device="cpu")
    b = MPGCN(M=2, K=3, input_dim=1, hidden_dim=H, lstm_num_layers=1,
              gcn_num_layers=3, seed=5, device="cpu")
    for (k, v), (_, w) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        torch.testing.assert_close(v, w, rtol=0, atol=0)
    assert a.branches[0].spatial[0].W.shape == (H * 9, H)
    assert a.branches[0].fc.weight.shape == (1, H)
    bound = 1 / np.sqrt(H)
    assert float(a.branches[0].temporal.layers[0].w_hh.detach().abs()
                 .max()) <= bound
    with pytest.raises(ValueError, match="lstm_impl"):
        MPGCN(M=1, K=3, input_dim=1, hidden_dim=H, lstm_num_layers=1,
              gcn_num_layers=1, lstm_impl="scan", device="cpu")
