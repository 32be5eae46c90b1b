"""The port's padded-CSR arm and the plain folded arm against the JAX
package on the CPU: CSR containers byte for byte (ids, values in f32 and
bf16, pad widths, shared pads), their helpers, ``analyze_support`` and
``recommend_format``, ``csr_spmm`` and its X gradient against the JAX
``csr_spmm`` (a ``lax.scan`` over the pad slots), the ``csr`` and
``folded`` BDGCN arms (static and dynamic supports, forward and W and X
gradients) against ``bdgcn_impl="csr"`` / ``"folded"``, the data
pipeline's CSR banks against the JAX trainer's bank build, and the whole
model on each arm against ``mpgcn_apply``.

Sizes: stacks of (3, 21, 21) to (7, 3, 30, 30) with an isolated node;
the BDGCN arms at K=3, B=2, N=12, C=4, H=5; the model at N=8, hidden 8,
seed 0 (a live head at these widths, asserted).

Tolerances, f32 on both sides in other summation orders: the SpMM and
its gradient rtol 1e-5 / atol 1e-5; the BDGCN arms forward rtol 1e-4 /
atol 1e-5, gradients rtol 1e-4 / atol 1e-4 (sums over B N^2 products);
the model forward rtol 1e-4 / atol 1e-5 (tests/test_torch_model.py's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data.pipeline import DataPipeline as JaxPipeline
from mpgcn_tpu.nn.mpgcn import init_mpgcn, mpgcn_apply
from mpgcn_tpu.sparse import formats as jax_formats
from mpgcn_tpu.sparse import kernels as jax_kernels
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import apply_density, synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.sparse import formats
from mpgcn_tpu_torch.sparse.kernels import csr_spmm
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils.convert import params_from_jax
from tests.torch_layer_common import (
    C,
    K,
    _layer_inputs,
    run_layer,
    sparse_stack,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SPMM_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _same_csr(ours, ref):
    assert isinstance(ours, formats.PaddedCSR)
    assert ours.n_cols == ref.n_cols and ours.shape == ref.shape
    assert ours.pad_width == ref.pad_width
    for a, b in ((ours.indices, ref.indices), (ours.values, ref.values)):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# --- the container -----------------------------------------------------------


@pytest.mark.parametrize("shape,density", [((3, 21, 21), 0.3),
                                           ((7, 3, 30, 30), 0.1),
                                           ((2, 5, 5), 1.0),
                                           ((3, 40, 40), 0.02)])
@pytest.mark.parametrize("payload", ["f32", "bf16"])
def test_csr_containers_match_jax_bytes(shape, density, payload):
    A = sparse_stack(np.random.default_rng(1), shape, density)
    ours = formats.pack_payload(formats.sparsify_support_stack(A, "csr"),
                                payload)
    ref = jax_formats.pack_payload(
        jax_formats.sparsify_support_stack(A, "csr"), payload)
    _same_csr(ours, ref)
    np.testing.assert_array_equal(
        formats.sparsify_support_stack(A, "csr").to_dense(),
        np.swapaxes(A, -1, -2))


@pytest.mark.parametrize("bucket,pad", [(8, None), (1, None), (4, None),
                                        (8, 24)])
def test_csr_from_dense_pads_match_jax(bucket, pad):
    A = sparse_stack(np.random.default_rng(2), (3, 30, 30), 0.2)
    _same_csr(formats.csr_from_dense(A, bucket=bucket, pad_width=pad),
              jax_formats.csr_from_dense(A, bucket=bucket, pad_width=pad))
    for lib in (formats, jax_formats):
        with pytest.raises(ValueError, match="pad_width"):
            lib.csr_from_dense(A, pad_width=1)


def test_csr_helpers_match_jax():
    A = sparse_stack(np.random.default_rng(3), (7, 3, 20, 20), 0.2)
    ours = formats.sparsify_support_stack(A, "csr")
    ref = jax_formats.sparsify_support_stack(A, "csr")
    assert formats.container_nbytes(ours) == \
        jax_formats.container_nbytes(ref)
    assert formats.dense_equiv_bytes(ours) == \
        jax_formats.dense_equiv_bytes(ref)
    assert formats.container_pad(ours) == jax_formats.container_pad(ref)
    keys = np.array([3, 0, 6, 3])
    _same_csr(ours[torch.from_numpy(keys)], ref[jnp.asarray(keys)])
    assert formats.pack_payload(ours, "f32") is ours
    for lib, c in ((formats, ours), (jax_formats, ref)):
        with pytest.raises(ValueError, match="int8"):
            lib.pack_payload(c, "int8")
    with pytest.raises(ValueError, match="csr"):
        formats.sparsify_support_stack(A, "coo")


@pytest.mark.parametrize("density", [0.0, 0.05, 0.25, 0.3, 1.0])
def test_analyze_support_and_recommend_match_jax(density):
    A = sparse_stack(np.random.default_rng(4), (3, 16, 16), density)
    assert formats.analyze_support(A) == jax_formats.analyze_support(A)
    for d in (density, 0.25, 0.26):
        for platform in ("cpu", "tpu", "gpu"):
            assert (formats.recommend_format(d, platform=platform)
                    == jax_formats.recommend_format(d, platform=platform))
    assert formats.SPARSE_DENSITY_DEFAULT == \
        jax_formats.SPARSE_DENSITY_DEFAULT


# --- the SpMM ----------------------------------------------------------------


@pytest.mark.parametrize("lead,p", [((3,), 0), ((2, 3), 0), ((2, 3), 1),
                                    ((2, 3), 2)])
def test_csr_spmm_and_dx_match_jax(lead, p):
    """X shared (p = 0) or one X per index of the first p leading dims;
    the JAX ``csr_spmm`` takes X shared or matching every leading dim, so
    its reference broadcasts X over the rest."""
    rng = np.random.default_rng(5)
    n, F = 17, 6
    A = sparse_stack(rng, lead + (n, n), 0.3)
    X = rng.normal(size=lead[:p] + (n, F)).astype(np.float32)
    dout = rng.normal(size=lead + (n, F)).astype(np.float32)
    ours = formats.csr_from_dense(A)
    ref = jax_formats.csr_from_dense(A)

    def jax_fn(x):
        xb = x if p in (0, len(lead)) else jnp.broadcast_to(
            x[..., None, :, :], lead + (n, F))
        return jax_kernels.csr_spmm(ref, xb)

    out_ref, vjp = jax.vjp(jax_fn, jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_()
    out = csr_spmm(ours, Xt)
    out.backward(torch.from_numpy(dout))
    assert tuple(out.shape) == lead + (n, F)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **SPMM_TOL)
    np.testing.assert_allclose(Xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dout))[0]),
                               **SPMM_TOL)


def test_csr_spmm_refuses_a_misfit_x():
    c = formats.csr_from_dense(np.eye(5, dtype=np.float32)[None])
    with pytest.raises(ValueError, match="does not fit"):
        csr_spmm(c, torch.zeros(4, 3))


def test_csr_spmm_bf16_values_promote_as_jax():
    rng = np.random.default_rng(6)
    A = sparse_stack(rng, (3, 9, 9))
    X = rng.normal(size=(9, 4)).astype(np.float32)
    ours = formats.pack_payload(formats.csr_from_dense(A), "bf16")
    ref = jax_formats.pack_payload(jax_formats.csr_from_dense(A), "bf16")
    for x_dtype, jx_dtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
        out = csr_spmm(ours, torch.from_numpy(X).to(x_dtype))
        want = jax_kernels.csr_spmm(ref, jnp.asarray(X, jx_dtype))
        assert str(out.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)


# --- the BDGCN arms ----------------------------------------------------------


@pytest.mark.parametrize("impl", ["csr", "folded"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_bdgcn_arm_matches_jax(impl, dynamic):
    (out, dW, dX), (ref, rW, rX) = run_layer(impl, dynamic)
    assert (ref != 0).mean() > 0.3
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(dW, rW, **GRAD_TOL)
    np.testing.assert_allclose(dX, rX, **GRAD_TOL)


@pytest.mark.parametrize("impl", ["csr", "folded"])
def test_bdgcn_arm_matches_the_einsum_arm(impl):
    (out, dW, dX), _ = run_layer(impl, True)
    (e_out, e_dW, e_dX), _ = run_layer("einsum", True)
    np.testing.assert_allclose(out, e_out, **FWD_TOL)
    np.testing.assert_allclose(dW, e_dW, **GRAD_TOL)
    np.testing.assert_allclose(dX, e_dX, **GRAD_TOL)


def test_folded_arm_checkpoints_its_groups():
    """The folded arm keeps no group temp for its backward (JAX: each
    group under ``jax.checkpoint``): autograd saves fewer elements than
    the same groups run without the checkpoint."""
    from mpgcn_tpu_torch.nn import bdgcn as port_bdgcn

    X, W, _, _, G = _layer_inputs(np.random.default_rng(8), False)
    Wt = torch.from_numpy(W).requires_grad_()

    def saved_elements(fn):
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
        return n[0]

    h1, G_dest, _ = port_bdgcn.origin_contract(torch.from_numpy(X),
                                               torch.from_numpy(G))
    Wr = Wt.reshape(K, K, C, -1)
    plain = saved_elements(lambda: sum(
        port_bdgcn._origin_group_static(h1[o], G_dest, Wr[o])
        for o in range(K)))
    folded = saved_elements(
        lambda: port_bdgcn.bdgcn_folded(Wt, h1, G_dest, K, C))
    assert folded < plain, (folded, plain)


# --- the bank build and the model --------------------------------------------


def test_pipeline_csr_banks_match_jax_bank_build():
    """The port's bank build on the csr arm against the JAX trainer's
    (trainer.py:173-197): one pad across banks, the same containers."""
    cfg = MPGCNConfig(synthetic_T=60, synthetic_N=20, pred_len=1)
    data = synthetic_dataset(cfg)
    apply_density(data, 0.1)
    pipe = DataPipeline(cfg, data, "cpu", bdgcn_impl="csr")
    assert pipe.bdgcn_impl == "csr"
    jp = JaxPipeline(JaxConfig(native_host="off", synthetic_T=60,
                               synthetic_N=20, pred_len=1), data)
    dense = {"static": jp.static_supports, "o": jp.o_support_bank,
             "d": jp.d_support_bank}
    banks = {k: jax_formats.sparsify_support_stack(v, "csr")
             for k, v in dense.items()}
    pad = max(jax_formats.container_pad(b) for b in banks.values())
    for k, v in dense.items():
        _same_csr(pipe.banks[k],
                  jax_formats.sparsify_support_stack(v, "csr", pad=pad))
    stats = pipe.support_stats()
    assert stats["impl"] == "csr"
    assert stats["resident_bytes"] == sum(
        formats.container_nbytes(b) for b in pipe.banks.values())
    with pytest.raises(ValueError, match="int8"):
        DataPipeline(cfg.replace(support_payload="int8"), data, "cpu",
                     bdgcn_impl="csr")


@pytest.fixture(scope="module")
def model_case():
    Nm, Hm = 8, 8
    kw = dict(synthetic_T=60, synthetic_N=Nm, hidden_dim=Hm, seed=0)
    cfg = MPGCNConfig(**kw).replace(num_nodes=Nm)
    data = synthetic_dataset(cfg)
    jp = JaxPipeline(JaxConfig(native_host="off", **kw), data)
    md = jp.modes["test"]
    x = np.ascontiguousarray(md.x[:4])
    keys = md.keys[:4]
    params = init_mpgcn(jax.random.PRNGKey(0), M=2, K=cfg.support_K,
                        input_dim=1, lstm_hidden_dim=Hm, lstm_num_layers=1,
                        gcn_hidden_dim=Hm, gcn_num_layers=3)
    dense = {"static": jp.static_supports, "o": jp.o_support_bank[keys],
             "d": jp.d_support_bank[keys]}
    return cfg, data, params, x, keys, dense


@pytest.mark.parametrize("impl", ["csr", "folded"])
def test_model_on_the_arm_matches_jax(model_case, impl):
    cfg, data, params, x, keys, dense = model_case
    if impl == "csr":
        jg = {k: jax_formats.sparsify_support_stack(v, "csr")
              for k, v in dense.items()}
    else:
        jg = {k: jnp.asarray(v) for k, v in dense.items()}
    ref = np.asarray(mpgcn_apply(params, jnp.asarray(x),
                                 [jg["static"], (jg["o"], jg["d"])],
                                 bdgcn_impl=impl, inference=True))
    assert (ref != 0).mean() > 0.1, "dead ReLU head: parity would be vacuous"
    model = MPGCN.from_config(cfg, device="cpu", lstm_impl="plain",
                              bdgcn_impl=impl)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    banks = DataPipeline(cfg, data, "cpu", bdgcn_impl=impl).banks
    out = model(torch.from_numpy(x), graphs_for(
        banks, torch.from_numpy(keys).long(), model.sources))
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
