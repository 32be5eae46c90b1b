"""The port's data path against the JAX package on the same seed: the
synthetic dataset, its windows and keys, and the support banks.

Tolerances: everything numpy-side is exact (same generators, same draw
order, same float64 arithmetic). Supports are float32 matrix products whose
summation order differs between XLA and PyTorch: atol 1e-6 on entries of
magnitude <= ~2."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data import loader as jax_loader
from mpgcn_tpu.data import windows as jax_windows
from mpgcn_tpu.data.dyn_graphs import construct_dyn_g as jax_dyn_g
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.graph import kernels as jax_kernels
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data import loader
from mpgcn_tpu_torch.data import windows
from mpgcn_tpu_torch.data.dyn_graphs import construct_dyn_g
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.graph import kernels

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, T = 8, 60
ATOL = 1e-6


@pytest.mark.parametrize("profile", ["smooth", "realistic"])
def test_synthetic_od_byte_identical(profile):
    for seed, salt in ((0, ""), (3, "city-b")):
        a = loader.synthetic_od(T, N, seed, profile=profile, salt=salt)
        b = jax_loader.synthetic_od(T, N, seed, profile=profile, salt=salt)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (loader.synthetic_adjacency(N, 5).tobytes()
            == jax_loader.synthetic_adjacency(N, 5).tobytes())
    assert (loader.synthetic_poi_features(N, seed=2).tobytes()
            == jax_loader.synthetic_poi_features(N, seed=2).tobytes())
    assert loader.fold_seed(7, "x", "y") == jax_loader.fold_seed(7, "x", "y")


@pytest.mark.parametrize("bug", [True, False])
def test_dyn_graphs_match(bug):
    raw = loader.synthetic_od(T, N, 1)
    o, d = construct_dyn_g(raw, 0.64, 7, reproduce_d_bug=bug,
                           use_native=False)
    jo, jd = jax_dyn_g(raw, 0.64, 7, reproduce_d_bug=bug, use_native=False)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)


@pytest.mark.parametrize("norm", ["none", "minmax", "std"])
def test_preprocess_matches(norm):
    raw = loader.synthetic_od(T, N, 0)
    adj = loader.synthetic_adjacency(N, 0)
    ours = loader.preprocess_od(raw, adj, MPGCNConfig(norm=norm,
                                                      native_host="off"))
    ref = jax_loader.preprocess_od(raw, adj, JaxConfig(norm=norm,
                                                       native_host="off"))
    for k in ("OD", "adj", "O_dyn_G", "D_dyn_G"):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_windows_split_keys_match():
    od = np.arange(50 * 2, dtype=np.float32).reshape(50, 2)
    for drop in (True, False):
        x, y = windows.sliding_windows(od, 7, 3, drop)
        jx, jy = jax_windows.sliding_windows(od, 7, 3, drop)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    lens = windows.split_lengths(46, (6.4, 1.6, 2))
    assert lens == jax_windows.split_lengths(46, (6.4, 1.6, 2))
    for mode in windows.MODES:
        assert (windows.mode_offset(mode, lens)
                == jax_windows.mode_offset(mode, lens))
        np.testing.assert_array_equal(
            windows.dow_keys(mode, lens, 7),
            jax_windows.dow_keys(mode, lens, 7))


def _graph(seed=0, zero_row=None):
    g = np.random.default_rng(seed).random((N, N))
    if zero_row is not None:
        g[zero_row] = 0.0
    return g


@pytest.mark.parametrize("kernel_type,order", [
    ("localpool", 1), ("chebyshev", 2), ("chebyshev", 3),
    ("random_walk_diffusion", 2), ("dual_random_walk_diffusion", 2)])
@pytest.mark.parametrize("clamp", [False, True])
def test_compute_supports_match(kernel_type, order, clamp):
    adj = _graph(1, zero_row=3 if clamp else None).astype(np.float32)
    ours = kernels.compute_supports(adj, kernel_type, order,
                                    degree_clamp=clamp, device="cpu")
    ref = jax_kernels.compute_supports(jnp.asarray(adj), kernel_type, order,
                                       degree_clamp=clamp)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kernel_type,order", [
    ("localpool", 1), ("chebyshev", 2),
    ("random_walk_diffusion", 2), ("dual_random_walk_diffusion", 2)])
@pytest.mark.parametrize("lambda_max", [2.0, None])
def test_batch_supports_match(kernel_type, order, lambda_max):
    flow = np.stack([_graph(s) for s in range(4)]).astype(np.float32)
    ours = kernels.batch_supports(flow, kernel_type, order,
                                  lambda_max=lambda_max, device="cpu")
    ref = jax_kernels.batch_supports(jnp.asarray(flow), kernel_type, order,
                                     lambda_max=lambda_max)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_validate_graph_policies_match():
    g = _graph(2, zero_row=1)
    for policy in ("selfloop", "ignore"):
        np.testing.assert_array_equal(
            kernels.validate_graph(g, "chebyshev", "g", policy),
            jax_kernels.validate_graph(g, "chebyshev", "g", policy))
    with pytest.raises(ValueError, match=r"row\(s\) \[1\]"):
        kernels.validate_graph(g, "localpool", "g", "error")
    assert kernels.support_k("dual_random_walk_diffusion", 2) == 5


@pytest.mark.parametrize("branches", [2, 3])
def test_pipeline_matches(branches):
    kw = dict(synthetic_T=T, synthetic_N=N, num_branches=branches, seed=0)
    cfg = MPGCNConfig(**kw)
    data = loader.synthetic_dataset(cfg)
    ref = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    ours = DataPipeline(cfg, data, device="cpu")
    assert ours.mode_len == ref.mode_len and ours.num_nodes == N
    for mode in windows.MODES:
        a, b = ours.modes[mode], ref.modes[mode]
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.keys, b.keys)
    names = {"static": "static_supports", "o": "o_support_bank",
             "d": "d_support_bank", "poi": "poi_supports"}
    assert set(ours.banks) == {k for k, name in names.items()
                               if getattr(ref, name) is not None}
    for key, bank in ours.banks.items():
        assert bank.dtype == torch.float32 and bank.device.type == "cpu"
        np.testing.assert_allclose(bank.numpy(), getattr(ref, names[key]),
                                   rtol=0, atol=ATOL)
