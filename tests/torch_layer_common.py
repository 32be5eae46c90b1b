"""One BDGCN layer run by the port and by the JAX package on the same
numpy-seeded inputs (tests/test_torch_csr.py, tests/test_torch_fused.py):
K=3, B=2, N=12, C=4, H=5, static or dynamic supports with an isolated
node, as dense stacks or as padded-CSR / blocked-ELL containers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpgcn_tpu.nn.bdgcn import bdgcn_apply as jax_bdgcn_apply
from mpgcn_tpu.sparse import formats as jax_formats
from mpgcn_tpu_torch.nn.bdgcn import bdgcn_apply
from mpgcn_tpu_torch.sparse import formats

K, B, N, C, H = 3, 2, 12, 4, 5


def sparse_stack(rng, shape, density=0.3):
    """A random sparse stack with an isolated node (a zero row)."""
    A = (rng.normal(size=shape) * (rng.random(shape) < density)).astype(
        np.float32)
    A[..., 1, :] = 0.0
    return A


def _layer_inputs(rng, dynamic):
    X = rng.normal(size=(B, N, N, C)).astype(np.float32)
    W = (rng.normal(size=(K * K * C, H)) / 6).astype(np.float32)
    bias = rng.normal(size=(H,)).astype(np.float32)
    dout = rng.normal(size=(B, N, N, H)).astype(np.float32)
    G = ((sparse_stack(rng, (B, K, N, N)), sparse_stack(rng, (B, K, N, N)))
         if dynamic else sparse_stack(rng, (K, N, N)))
    return X, W, bias, dout, G


def _graph(G, impl, lib):
    """G as the arm takes it: dense stacks, or containers of ``lib``."""
    if isinstance(G, tuple):
        return tuple(_graph(g, impl, lib) for g in G)
    if impl in ("csr", "ell"):
        return lib.sparsify_support_stack(G, impl)
    return torch.from_numpy(G) if lib is formats else jnp.asarray(G)


def run_layer(impl, dynamic, fused=False, seed=7):
    """(port out, dW, dX), (JAX out, dW, dX) of one BDGCN layer with ReLU."""
    X, W, bias, dout, G = _layer_inputs(np.random.default_rng(seed), dynamic)
    out_ref, vjp = jax.vjp(
        lambda w, x: jax_bdgcn_apply({"W": w, "b": jnp.asarray(bias)}, x,
                                     _graph(G, impl, jax_formats),
                                     activation=jax.nn.relu, impl=impl,
                                     fused=fused),
        jnp.asarray(W), jnp.asarray(X))
    ref = (np.asarray(out_ref),
           *(np.asarray(g) for g in vjp(jnp.asarray(dout))))

    class Layer:
        pass

    layer = Layer()
    layer.W = torch.from_numpy(W).requires_grad_()
    layer.b = torch.from_numpy(bias)
    Xt = torch.from_numpy(X).requires_grad_()
    out = bdgcn_apply(layer, Xt, _graph(G, impl, formats),
                      activation=torch.relu, impl=impl, fused=fused)
    out.backward(torch.from_numpy(dout))
    return (out.detach().numpy(), layer.W.grad.numpy(),
            Xt.grad.numpy()), ref
