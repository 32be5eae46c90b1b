"""The port's sparse (blocked-ELL) path against the JAX package on the CPU:
containers byte for byte, the plain ELL SpMM forward, dX and dBlocks
against the Pallas kernels (interpret mode) and ``jax.grad`` through them,
``bdgcn_sparse``, the ``auto`` dispatch, and the slice as a whole (two
training steps and a 7-step rollout of ``ModelTrainer(bdgcn_impl="ell")``
against the JAX ``ModelTrainer`` with ``bdgcn_impl="ell"`` from the same
init).

Sizes: the module tests use (8, 8) tiles over ragged N with several column
blocks; the slice runs at N=136 (two (8, 128) column blocks), banded
density 0.05, batch 2, hidden 8, from the JAX init at seed 10, which gives
both branches a live head (most seeds leave one dead at these widths).

Tolerances, f32 on both sides with different summation orders: the SpMMs
and their gradients rtol 1e-5 / atol 1e-5 (sums of a few hundred O(1)
products); bdgcn_sparse rtol 1e-5 / atol 1e-5; the slice's losses rtol
1e-5, parameters after two Adam steps rtol 1e-4 / atol 1e-5, the rollout
rtol 1e-4 / atol 1e-5.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.nn import pallas_bdgcn
from mpgcn_tpu.quant.int8 import QuantizedTensor as JaxQuantized
from mpgcn_tpu.sparse import formats as jax_formats
from mpgcn_tpu.sparse import kernels as jax_kernels
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import apply_density, synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.nn import cuda_bdgcn
from mpgcn_tpu_torch.quant.int8 import QuantizedTensor
from mpgcn_tpu_torch.service.serve import ServeEngine
from mpgcn_tpu_torch.sparse import cuda_ell
from mpgcn_tpu_torch.sparse.formats import (
    BlockedELL,
    container_nbytes,
    container_pad,
    dense_equiv_bytes,
    ell_from_dense,
    ell_pad_width,
    pack_payload,
    sparsify_support_stack,
)
from mpgcn_tpu_torch.sparse.kernels import (
    bdgcn_sparse,
    ell_spmm,
    flat_stack,
)
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SPMM_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-5)
PAYLOADS = ("f32", "bf16", "int8")
SLICE_N = 136
INIT_SEED = 10
SLICE_KW = dict(synthetic_T=60, synthetic_N=SLICE_N, hidden_dim=8,
                batch_size=2, seed=0, sparse_min_nodes=64)


def _stack(rng, shape, density=0.3):
    """A random sparse stack with a zero row (an isolated node)."""
    A = (rng.normal(size=shape) * (rng.random(shape) < density)).astype(
        np.float32)
    A[..., 1, :] = 0.0
    return A


def _bits(t) -> np.ndarray:
    """The bytes of a torch or JAX array (bf16 through its 16-bit view)."""
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _assert_same_container(ours: BlockedELL, ref):
    assert (ours.n_rows, ours.n_cols) == (ref.n_rows, ref.n_cols)
    np.testing.assert_array_equal(_bits(ours.block_cols),
                                  _bits(ref.block_cols))
    if isinstance(ref.blocks, JaxQuantized):
        assert isinstance(ours.blocks, QuantizedTensor)
        pairs = ((ours.blocks.q, ref.blocks.q),
                 (ours.blocks.scale, ref.blocks.scale))
    else:
        pairs = ((ours.blocks, ref.blocks),)
    for a, b in pairs:
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_bank_build(dense: dict, payload: str) -> dict:
    """The JAX trainer's bank build (trainer.py:186-197) on numpy stacks."""
    banks = {k: jax_formats.sparsify_support_stack(v, "ell")
             for k, v in dense.items()}
    pad = max(jax_formats.container_pad(b) for b in banks.values())
    return {k: jax_formats.pack_payload(
        b if jax_formats.container_pad(b) == pad
        else jax_formats.sparsify_support_stack(dense[k], "ell", pad=pad),
        payload) for k, b in banks.items()}


# --- containers --------------------------------------------------------------


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("shape,bc", [((3, 21, 21), 8), ((7, 3, 30, 30), 8),
                                      ((2, 16, 16), 16)])
def test_containers_match_jax_bytes(payload, shape, bc):
    A = _stack(np.random.default_rng(len(shape) + bc), shape)
    ours = pack_payload(ell_from_dense(A, br=8, bc=bc), payload)
    ref = jax_formats.pack_payload(
        jax_formats.ell_from_dense(A, br=8, bc=bc), payload)
    _assert_same_container(ours, ref)
    if payload == "int8":
        ref = jax_formats.BlockedELL(ref.block_cols, ref.blocks.dequantize(),
                                     ref.n_rows, ref.n_cols)
    np.testing.assert_array_equal(ours.to_dense(),
                                  np.asarray(ref.to_dense(), np.float32))


@pytest.mark.parametrize("payload", PAYLOADS)
def test_pipeline_banks_match_jax_bank_build(payload):
    """The pipeline's 'ell' banks, shared pad included, are the JAX bank
    build's containers of the same dense banks."""
    cfg = MPGCNConfig(pred_len=1, support_payload=payload, **SLICE_KW)
    data = synthetic_dataset(cfg)
    apply_density(data, 0.05)
    dense = DataPipeline(cfg.replace(support_payload="f32"), data, "cpu",
                         bdgcn_impl="einsum").banks
    pipe = DataPipeline(cfg, data, "cpu", bdgcn_impl="ell")
    ref = _jax_bank_build({k: v.numpy() for k, v in dense.items()}, payload)
    assert set(pipe.banks) == set(ref) == {"static", "o", "d"}
    pads = {b.pad_blocks for b in pipe.banks.values()}
    assert len(pads) == 1
    for k in ref:
        _assert_same_container(pipe.banks[k], ref[k])


@pytest.mark.parametrize("shape,density", [
    ((3, 40, 40), 0.05), ((2, 3, 136, 136), 0.02), ((3, 136, 136), 1.0),
    ((3, 200, 200), 0.0)])
def test_pad_width_is_the_pad_the_container_picks(shape, density):
    """``ell_pad_width`` gives the bank build its shared pad without
    packing: the MB of the port's and the JAX package's container."""
    A = _stack(np.random.default_rng(5), shape, density=density)
    ref = jax_formats.container_pad(
        jax_formats.sparsify_support_stack(A, "ell"))
    assert ell_pad_width(A) == ref
    assert container_pad(sparsify_support_stack(A, "ell")) == ref


def test_transposed_index_lists_each_populated_slot_once():
    A = _stack(np.random.default_rng(3), (2, 3, 37, 37), density=0.1)
    ell = ell_from_dense(A, br=8, bc=8)
    cols = ell.block_cols.numpy().reshape(6, -1)
    blocks = ell.blocks.numpy().reshape(6, cols.shape[1], -1)
    ptr = ell.t_ptr.numpy().reshape(6, -1)
    slot = ell.t_slot.numpy().reshape(6, -1)
    for s in range(6):
        populated = np.flatnonzero(blocks[s].any(-1))
        listed = slot[s, :ptr[s, -1]]
        assert sorted(listed) == sorted(populated)
        for c in range(ptr.shape[1] - 1):
            run = listed[ptr[s, c]:ptr[s, c + 1]]
            assert (cols[s, run] == c).all()
            assert list(run) == sorted(run)
    # bank[keys] gathers the index with the tiles
    keys = torch.tensor([1, 0, 1])
    sub = ell[keys]
    assert tuple(sub.t_ptr.shape[:2]) == (3, 3)
    np.testing.assert_array_equal(sub.to_dense(), A[[1, 0, 1]])


@pytest.fixture(scope="module")
def slice_banks():
    """The pipeline's 'ell' banks at the slice shape, per payload."""
    cfg = MPGCNConfig(pred_len=1, **SLICE_KW)
    data = synthetic_dataset(cfg)
    apply_density(data, 0.05)
    return {p: DataPipeline(cfg.replace(support_payload=p), data, "cpu",
                            bdgcn_impl="ell").banks for p in PAYLOADS}


@pytest.mark.parametrize("bank", ["static", "o", "d"])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_transposed_index_runs_list_populated_slots_by_row_block(
        slice_banks, payload, bank):
    """What the forward kernel relies on, for every bank the pipeline
    builds (O and D gathered by day key, as a batch reads them): within
    each column block's run, t_slot lists exactly that column block's
    populated slots (no pad slot, none twice), sorted by row block, so a
    row group's slots there are one sub-run. Populated means a non-zero
    f32 tile; every payload keeps the f32 bank's index and pad."""
    ref = slice_banks["f32"][bank]
    ell = slice_banks[payload][bank]
    if bank != "static":
        keys = torch.tensor([0, 3, 6, 3])
        ref, ell = ref[keys], ell[keys]
    for a, b in ((ell.block_cols, ref.block_cols), (ell.t_ptr, ref.t_ptr),
                 (ell.t_slot, ref.t_slot)):
        assert torch.equal(a, b)
    nb, mb = ref.block_cols.shape[-2:]
    cols = ref.block_cols.reshape(-1, nb * mb).numpy()
    populated = ref.blocks.reshape(cols.shape[0], nb * mb, -1).numpy().any(-1)
    tiles = ell.blocks.q if payload == "int8" else ell.blocks.float()
    stored = tiles.reshape(cols.shape[0], nb * mb, -1).numpy().any(-1)
    assert not (stored & ~populated).any(), "a pad slot holds a tile"
    ptr = ref.t_ptr.reshape(cols.shape[0], -1).numpy()
    slot = ref.t_slot.reshape(cols.shape[0], -1).numpy()
    assert ptr.shape[1] - 1 == -(-ref.n_cols // ref.blocks.shape[-1])
    for s in range(cols.shape[0]):
        assert ptr[s, 0] == 0 and (np.diff(ptr[s]) >= 0).all()
        for c in range(ptr.shape[1] - 1):
            run = slot[s, ptr[s, c]:ptr[s, c + 1]]
            expect = np.flatnonzero(populated[s] & (cols[s] == c))
            np.testing.assert_array_equal(run, expect)
            assert (np.diff(run // mb) >= 0).all()
        assert ptr[s, -1] == populated[s].sum()


def test_container_bytes_and_unported_format():
    A = _stack(np.random.default_rng(4), (3, 40, 40), density=0.05)
    f32 = sparsify_support_stack(A, "ell")
    q = pack_payload(f32, "int8")
    ref = jax_formats.pack_payload(jax_formats.sparsify_support_stack(A, "ell"),
                                   "int8")
    index = f32.t_ptr.numel() * 4 + f32.t_slot.numel() * 4
    assert container_nbytes(q) == jax_formats.container_nbytes(ref) + index
    assert dense_equiv_bytes(q) == jax_formats.dense_equiv_bytes(ref)
    with pytest.raises(ValueError, match="not ported"):
        sparsify_support_stack(A, "csr")
    with pytest.raises(ValueError, match="payload"):
        pack_payload(f32, "fp8")


# --- the ELL SpMM against the Pallas kernels ---------------------------------


def _pair(A, payload, br=8, bc=8):
    ours = pack_payload(ell_from_dense(A, br=br, bc=bc), payload)
    ref = jax_formats.pack_payload(
        jax_formats.ell_from_dense(A, br=br, bc=bc), payload)
    return ours, ref


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("per_sample", [False, True])
def test_ell_spmm_and_dx_match_pallas(payload, per_sample):
    """Forward and dX through ``ell_spmm`` (EllSpmmFn / EllSpmmQFn on the
    plain versions) against the Pallas kernels in interpret mode and
    ``jax.vjp`` through them: a (2, 3)-stacked operator over ragged N=21
    with three column blocks, X shared or one per leading index."""
    rng = np.random.default_rng(5)
    N, F = 21, 6
    A = _stack(rng, (2, 3, N, N))
    ours, ref = _pair(A, payload)
    X = rng.normal(size=(2, N, F) if per_sample else (N, F)).astype(
        np.float32)
    dout = rng.normal(size=(2, 3, N, F)).astype(np.float32)
    pallas = functools.partial(jax_kernels.ell_spmm, use_pallas=True)
    if per_sample:
        fn = lambda x: jax.vmap(pallas)(ref, x)
    else:
        fn = lambda x: pallas(ref, x)
    out_ref, vjp = jax.vjp(fn, jnp.asarray(X))
    (dx_ref,) = vjp(jnp.asarray(dout))

    Xt = torch.from_numpy(X).requires_grad_()
    out = ell_spmm(ours, Xt)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **SPMM_TOL)
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dx_ref),
                               **SPMM_TOL)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("per_sample", [False, True])
def test_ell_fwd_entry_with_index_matches_pallas(payload, per_sample):
    """``ell_fwd`` at the flattened signature the kernels take, with the
    transposed index the CUDA forward walks, against the Pallas forward in
    interpret mode: a (2, 3)-stacked operator over ragged N=29 (three
    row blocks of a partial row group, four column blocks), X shared or
    one per leading index."""
    rng = np.random.default_rng(9)
    N, F = 29, 7
    A = _stack(rng, (2, 3, N, N))
    ours, ref = _pair(A, payload)
    X = rng.normal(size=(2, N, F) if per_sample else (N, F)).astype(
        np.float32)
    pallas = functools.partial(jax_kernels.ell_spmm, use_pallas=True)
    out_ref = (jax.vmap(pallas)(ref, jnp.asarray(X)) if per_sample
               else pallas(ref, jnp.asarray(X)))
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ours)
    G = 2 if per_sample else 1
    out = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot,
                           torch.from_numpy(X).reshape(G, N, F), N, 6 // G,
                           scale)
    np.testing.assert_allclose(out.reshape(2, 3, N, F).numpy(),
                               np.asarray(out_ref), **SPMM_TOL)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_plain_entries_match_dense_oracle(payload):
    """The three plain entries at the flattened signature the kernels take,
    against dense numpy products of the dequantised operators."""
    rng = np.random.default_rng(6)
    N, F = 19, 4
    A = _stack(rng, (4, N, N))
    ell = pack_payload(ell_from_dense(A, br=8, bc=8), payload)
    dense = ell.to_dense()
    X = rng.normal(size=(2, N, F)).astype(np.float32)
    dout = rng.normal(size=(4, N, F)).astype(np.float32)
    scale = None
    tiles = ell.blocks
    if payload == "int8":
        tiles, scale = ell.blocks.q, ell.blocks.scale
    out = cuda_ell.ell_fwd(ell.block_cols, tiles, ell.t_ptr, ell.t_slot,
                           torch.from_numpy(X), N, 2, scale)
    np.testing.assert_allclose(
        out.numpy(), np.einsum("snm,smf->snf", dense, X[[0, 0, 1, 1]]),
        **SPMM_TOL)
    dx = cuda_ell.ell_bwd_dx(ell.block_cols, tiles, ell.t_ptr, ell.t_slot,
                             torch.from_numpy(dout), N, 2, scale)
    ref = np.einsum("snm,snf->smf", dense, dout).reshape(2, 2, N, F).sum(1)
    np.testing.assert_allclose(dx.numpy(), ref, **SPMM_TOL)


@pytest.mark.parametrize("payload", ["f32", "int8"])
def test_dx_plain_runs_in_float64_for_a_reference(payload):
    """Given float64 dout (and float64 tiles, or float64 scales beside the
    int8 codes), the plain dX sums in float64: the reference the card's
    dX is held to at the N=500 shape. It matches the float64 product of
    the dense operators, and its f32 run to f32 rounding."""
    rng = np.random.default_rng(64)
    N, F = 27, 5
    ell = pack_payload(ell_from_dense(_stack(rng, (3, N, N)), br=8, bc=16),
                       payload)
    dout = torch.from_numpy(rng.normal(size=(3, N, F)))
    if payload == "int8":
        tiles, scale = ell.blocks.q, ell.blocks.scale
        args = (tiles, dout, N, 3, scale.double())
        tiles64 = (tiles.double()
                   * scale.double().reshape(3, -1, 1, 1, 1)).numpy()
    else:
        tiles, scale = ell.blocks, None
        args = (tiles.double(), dout, N, 3, None)
        tiles64 = tiles.double().numpy()
    dx = cuda_ell.ell_bwd_dx_plain(ell.block_cols, *args)
    assert dx.dtype == torch.float64
    dense = np.zeros((3, 32, 32))  # (NB * 8, whole column blocks)
    for (s, i, j), c in np.ndenumerate(ell.block_cols.numpy()):
        dense[s, 8 * i:8 * i + 8, 16 * c:16 * c + 16] += tiles64[s, i, j]
    ref = np.einsum("snm,snf->mf", dense[:, :N, :N], dout.numpy())[None]
    np.testing.assert_allclose(dx.numpy(), ref, rtol=1e-12, atol=1e-12)
    dx32 = cuda_ell.ell_bwd_dx_plain(ell.block_cols, tiles, dout.float(), N,
                                     3, scale)
    assert dx32.dtype == torch.float32
    np.testing.assert_allclose(dx32.numpy(), ref, **SPMM_TOL)


def _band(N, width, shape):
    """A banded stack (|i - j| <= width, no wrap): with (8, 8) tiles the
    first and last row blocks meet one column block fewer than the rest,
    so they hold pad slots, which name column block 0."""
    d = np.abs(np.arange(N)[:, None] - np.arange(N)[None, :])
    A = np.random.default_rng(N).normal(size=shape).astype(np.float32)
    return A * (d <= width)


@pytest.mark.parametrize("case", [
    *[("ell-fwd", p) for p in PAYLOADS], *[("ell-dx", p) for p in PAYLOADS],
    *[(k, p, "tile") for k in ("ell-fwd", "ell-dx") for p in ("f32", "bf16")],
    ("ell-fwd", "int8", "scale"), ("ell-dx", "int8", "scale"),
    ("bdgcn-fwd", "h1"), ("bdgcn-fwd", "g"), ("bdgcn-bwd", "dout"),
    ("bdgcn-bwd", "h1")], ids="-".join)
def test_non_finite_pattern_matches_jax(case):
    """An Inf, a -Inf and a NaN in one operand: the port's plain versions
    give Inf or NaN in the same entries as the Pallas kernels in interpret
    mode, the pattern the card's kernels are held to. ELL forward: X holds
    them at a column that most of a populated tile's rows leave zero (0 x
    Inf is NaN) and in column block 0, which only pad slots name for the
    last row block; dX: dout holds them in that row block and in one
    without pad slots; both: populated tiles hold them, or the int8
    scales of sample 0's row blocks, the last (with a pad slot) among
    them, X one per sample for dX there; the folded BDGCN pair forward
    and backward."""
    kind, which, *where = case
    rng = np.random.default_rng(17)
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    if kind.startswith("ell"):
        N, F = 40, 6
        ours, ref = _pair(_band(N, 3, (2, 3, N, N)), which)
        if where == ["tile"]:
            # populated tiles (the containers take only finite operators):
            # A[0, 1, 10, 11], A[1, 0, 20, 22], A[1, 2, 33, 31]
            tiles = ours.blocks.clone()
            ref_tiles = np.array(ref.blocks)
            for (b0, b1, r, c), v in zip(
                    ((0, 1, 10, 11), (1, 0, 20, 22), (1, 2, 33, 31)),
                    (inf, -inf, nan)):
                j = int(np.flatnonzero(
                    ours.block_cols[b0, b1, r // 8].numpy() == c // 8)[0])
                at = (b0, b1, r // 8, j, r % 8, c % 8)
                tiles[at] = float(v)
                ref_tiles[at] = v
            ours = dataclasses.replace(ours, blocks=tiles)
            ref = dataclasses.replace(ref, blocks=jnp.asarray(ref_tiles))
        cols = ours.block_cols.reshape(-1, *ours.block_cols.shape[-2:])
        last = N // 8 - 1
        assert bool((cols[:, last] == 0).any())  # a pad slot on block 0
        assert not bool((cols[:, last, :2] == 0).any())
        per_sample = where == ["scale"]
        if per_sample:  # sample 0's row blocks: (0, 0) 4, (0, 1) 2, (0, 2) 0
            sc = ours.blocks.scale.numpy().copy()
            sc.reshape(-1)[[last, N // 8 + 2, 2 * (N // 8)]] = inf, -inf, nan
            ours = dataclasses.replace(ours, blocks=QuantizedTensor(
                ours.blocks.q, torch.from_numpy(sc)))
            ref = dataclasses.replace(ref, blocks=JaxQuantized(
                ref.blocks.q, jnp.asarray(sc)))
        pallas = functools.partial(jax_kernels.ell_spmm, use_pallas=True)
        fn = ((lambda x: jax.vmap(pallas)(ref, x)) if per_sample
              else (lambda x: pallas(ref, x)))
        X = rng.normal(size=(2, N, F) if per_sample else (N, F)).astype(
            np.float32)
        if kind == "ell-fwd":
            if not where:
                X[8, 1], X[2, 3], X[20, 4] = inf, -inf, nan
            ref_out = np.asarray(fn(jnp.asarray(X)))
            out = ell_spmm(ours, torch.from_numpy(X)).numpy()
            if not where:
                assert not np.isfinite(out[:, :, 8 * last:, 3]).any()
        else:
            dout = rng.normal(size=(2, 3, N, F)).astype(np.float32)
            if not where:
                dout[0, 1, 8 * last + 2, 1] = inf
                dout[1, 2, 12, 3] = -inf
                dout[0, 0, 27, 4] = nan
            _, vjp = jax.vjp(fn, jnp.asarray(X))
            (ref_out,) = vjp(jnp.asarray(dout))
            ref_out = np.asarray(ref_out)
            Xt = torch.from_numpy(X).requires_grad_()
            ell_spmm(ours, Xt).backward(torch.from_numpy(dout))
            out = Xt.grad.numpy()
            if not where:
                assert not np.isfinite(out[:8, 1]).any()  # the pad slot's
    else:
        K, B, N, C, H = 3, 2, 9, 4, 5
        h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
        g = (rng.random((B, K, N, N)) / N).astype(np.float32)
        w = (rng.normal(size=(K, K, C, H)) / 6).astype(np.float32)
        dout = rng.normal(size=(B, N, N, H)).astype(np.float32)
        bad = {"h1": h1, "g": g, "dout": dout}[which]
        flat = bad.reshape(-1)
        flat[[5, 70, 200]] = inf, -inf, nan
        args = [jnp.asarray(a) for a in (h1, g, w)]
        targs = [torch.from_numpy(a) for a in (h1, g, w)]
        if kind == "bdgcn-fwd":
            ref_out = np.asarray(pallas_bdgcn.folded_pair_project(
                *args, interpret=True))
            out = cuda_bdgcn.folded_pair_project_plain(*targs).numpy()
        else:
            refs = pallas_bdgcn._bwd_pallas(*args, jnp.asarray(dout),
                                            interpret=True)
            outs = cuda_bdgcn.folded_pair_project_bwd_plain(
                *targs, torch.from_numpy(dout))
            ref_out = np.concatenate([np.asarray(r).reshape(-1)
                                      for r in refs])
            out = np.concatenate([o.numpy().reshape(-1) for o in outs])
    mask = ~np.isfinite(out)
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(mask, ~np.isfinite(ref_out))


def test_dblocks_match_pallas_on_a_pad_free_container():
    """dBlocks through ``ell_spmm`` with tiles that require grad, against
    ``jax.grad`` through the Pallas kernels, on a container whose every row
    block stores every column block (pad slots pair with column block 0 in
    both packages, so only a pad-free container scatters back to dA)."""
    rng = np.random.default_rng(7)
    N, F = 16, 5
    A = rng.normal(size=(3, N, N)).astype(np.float32)
    ours, ref = _pair(A, "f32")
    assert ours.pad_blocks == 2
    X = rng.normal(size=(N, F)).astype(np.float32)
    dout = rng.normal(size=(3, N, F)).astype(np.float32)

    def loss(blocks):
        el = jax_formats.BlockedELL(ref.block_cols, blocks, N, N)
        y = jax_kernels.ell_spmm(el, jnp.asarray(X), use_pallas=True)
        return (y * dout).sum()

    dblk_ref = jax.grad(loss)(ref.blocks)
    blocks = ours.blocks.clone().requires_grad_()
    el = BlockedELL(ours.block_cols, blocks, ours.t_ptr, ours.t_slot, N, N)
    (dblk,) = torch.autograd.grad(
        (ell_spmm(el, torch.from_numpy(X)) * torch.from_numpy(dout)).sum(),
        blocks)
    np.testing.assert_allclose(dblk.numpy(), np.asarray(dblk_ref),
                               **SPMM_TOL)
    dA = np.einsum("snf,mf->snm", dout, X)
    np.testing.assert_allclose(
        BlockedELL(ours.block_cols, dblk, ours.t_ptr, ours.t_slot, N,
                   N).to_dense(), dA, **SPMM_TOL)


@pytest.mark.parametrize("S,NB,MB,x_div,F,sms", [
    (3, 63, 4, 3, 32000, 132),    # the pad-free N=500 container
    (6, 63, 2, 3, 16000, 132),    # per-sample X at N=500
    (3, 3, 3, 3, 5, 132),         # one step
    (1, 32, 16, 1, 96, 8),        # few SMs
    (2, 4, 2, 1, 1_000_000, 132)])  # long F: the step cap sets the chunks
def test_dblk_chunks_split_f_into_nonempty_bounded_chunks(S, NB, MB, x_div,
                                                          F, sms):
    """dBlocks splits F into chunks of whole 32-column steps: none empty
    (the kernel's per-chunk step ranges cover F exactly once), none over
    DBLK_MAX_STEPS steps (the f32 accumulators' add count), and no longer
    than the split that gives DBLK_WAVES blocks per SM asks for."""
    n = cuda_ell.dblk_chunks(S, NB, MB, x_div, F, sms)
    steps = -(-F // cuda_ell.DBLK_TF)
    per = -(-steps // n)
    ranges = [(c * per, min(steps, (c + 1) * per)) for c in range(n)]
    assert all(a < b for a, b in ranges) and ranges[-1][1] == steps
    assert per <= cuda_ell.DBLK_MAX_STEPS
    tiles = S // x_div * -(-x_div * NB * MB // cuda_ell.DBLK_SLOTS)
    want = max(-(-cuda_ell.DBLK_WAVES * sms // tiles),
               -(-steps // cuda_ell.DBLK_MAX_STEPS))
    assert per == -(-steps // min(steps, want))


def test_int8_backward_gives_no_tile_gradient():
    rng = np.random.default_rng(8)
    A = _stack(rng, (3, 12, 12))
    ell = pack_payload(ell_from_dense(A, br=8, bc=8), "int8")
    scale = ell.blocks.scale.clone().requires_grad_()
    el = BlockedELL(ell.block_cols, QuantizedTensor(ell.blocks.q, scale),
                    ell.t_ptr, ell.t_slot, 12, 12)
    X = torch.from_numpy(rng.normal(size=(12, 3)).astype(np.float32))
    X.requires_grad_()
    ell_spmm(el, X).sum().backward()
    assert X.grad is not None and scale.grad is None


# --- bdgcn_sparse -------------------------------------------------------------


@pytest.mark.parametrize("dynamic", [False, True])
def test_bdgcn_sparse_matches_jax(monkeypatch, dynamic):
    """The sparse folded BDGCN and its X and W gradients against the JAX
    package's, whose every SpMM goes through the Pallas kernels (interpret
    mode), over N=20 (three (8, 8) column blocks)."""
    monkeypatch.setattr(jax_kernels, "ell_spmm", functools.partial(
        jax_kernels.ell_spmm, use_pallas=True))
    rng = np.random.default_rng(9)
    K, B, N, C, H = 3, 2, 20, 4, 5
    X = rng.normal(size=(B, N, N, C)).astype(np.float32)
    W = (rng.normal(size=(K * K * C, H)) / 6).astype(np.float32)
    dout = rng.normal(size=(B, N, N, H)).astype(np.float32)
    if dynamic:
        Go, Gd = _stack(rng, (B, K, N, N)), _stack(rng, (B, K, N, N))
        mk = lambda A, f: f(np.swapaxes(A, -1, -2), br=8, bc=8)
        ours = (mk(Go, ell_from_dense), mk(Gd, ell_from_dense))
        ref = (mk(Go, jax_formats.ell_from_dense),
               mk(Gd, jax_formats.ell_from_dense))
    else:
        G = np.swapaxes(_stack(rng, (K, N, N)), -1, -2)
        ours = ell_from_dense(G, br=8, bc=8)
        ref = jax_formats.ell_from_dense(G, br=8, bc=8)
    out_ref, vjp = jax.vjp(lambda w, x: jax_kernels.bdgcn_sparse(w, x, ref),
                           jnp.asarray(W), jnp.asarray(X))
    dW_ref, dX_ref = vjp(jnp.asarray(dout))
    Wt = torch.from_numpy(W).requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    out = bdgcn_sparse(Wt, Xt, ours)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **SPMM_TOL)
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(dW_ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(dX_ref),
                               **SPMM_TOL)


# --- the dispatch and the slice ---------------------------------------------


def _slice_data(**kw):
    cfg = MPGCNConfig(**{"pred_len": 1, **SLICE_KW, **kw})
    data = synthetic_dataset(cfg)
    apply_density(data, 0.05)
    return cfg, data


def test_auto_resolves_by_density_and_size():
    cfg, data = _slice_data()
    pipe = DataPipeline(cfg, data, "cpu")
    assert pipe.bdgcn_impl == "ell" and 0.04 < pipe.support_density < 0.05
    assert DataPipeline(cfg.replace(sparse_min_nodes=256), data, "cpu",
                        ).bdgcn_impl == "kernel"
    assert DataPipeline(cfg.replace(sparse_density_threshold=0.01), data,
                        "cpu").bdgcn_impl == "kernel"
    ref = MPGCNConfig(synthetic_T=60, pred_len=1)  # N=47, dense
    assert DataPipeline(ref, synthetic_dataset(ref), "cpu").bdgcn_impl == \
        "kernel"
    with pytest.raises(ValueError, match="int8"):
        DataPipeline(cfg.replace(support_payload="int8"), data, "cpu",
                     bdgcn_impl="kernel")
    with pytest.raises(ValueError, match="bdgcn_impl"):
        DataPipeline(cfg, data, "cpu", bdgcn_impl="csr")


def test_config_sparse_fields_match_jax():
    ours, ref = MPGCNConfig(), JaxConfig()
    for name in ("support_payload", "sparse_density_threshold",
                 "sparse_min_nodes"):
        assert getattr(ours, name) == getattr(ref, name), name
    for bad in (dict(support_payload="fp8"),
                dict(sparse_density_threshold=1.5),
                dict(sparse_min_nodes=0)):
        with pytest.raises(ValueError):
            MPGCNConfig(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Two training steps and a 7-step rollout of the JAX trainer on its
    'ell' arm and of the port's, from the JAX init at INIT_SEED."""
    cfg, data = _slice_data()
    jt = JaxTrainer(JaxConfig(native_host="off", bdgcn_impl="ell",
                              od_storage="dense",
                              output_dir=str(tmp_path_factory.mktemp("j")),
                              pred_len=1, **{**SLICE_KW, "seed": INIT_SEED}),
                    data)
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    pt = ModelTrainer(cfg, data, device="cpu", bdgcn_impl="ell")
    pt.model.load_state_dict(params_from_jax(init))
    batches = list(pt.pipeline.batches("train", pad_to_full=True))[:2]
    x, _, keys = pt._tensors(batches[0])
    shares = [(float((h != 0).float().mean()),
               float((torch.relu(b.fc(h)) != 0).float().mean()))
              for b, h in zip(pt.model.branches, pt.model(
                  x, graphs_for(pt.banks, keys, pt.model.sources),
                  return_hidden=True)[1])]
    params, opt = jt.params, jt.opt_state
    losses_j, losses_p = [], []
    for b in batches:
        params, opt, loss = jt._train_step(
            params, opt, jt.banks, jnp.asarray(b.x), jnp.asarray(b.y),
            jnp.asarray(b.keys), b.size)
        losses_j.append(float(loss))
        losses_p.append(pt.train_step(b))
    md = pt.pipeline.modes["test"]
    xs, ks = np.ascontiguousarray(md.x[:2]), md.keys[:2]
    roll_j = np.asarray(jt._rollout(params, jt.banks, jnp.asarray(xs),
                                    jnp.asarray(ks), 7))
    return dict(pt=pt, init=params_from_jax(init), shares=shares,
                losses=(losses_j, losses_p), params_j=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, params)),
                roll=(roll_j, pt.predict(xs, ks, 7)))


def test_slice_trains_like_the_jax_ell_trainer(slice_runs):
    r = slice_runs
    assert r["pt"].bdgcn_impl == "ell"
    assert all(min(s) > 0.1 for s in r["shares"]), r["shares"]
    np.testing.assert_allclose(*r["losses"], **LOSS_TOL)
    for k, v in r["pt"].model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), r["params_j"][k].numpy(),
                                   err_msg=k, **PARAM_TOL)
        assert not torch.equal(v, r["init"][k]), k


def test_slice_rollout_matches_jax(slice_runs):
    roll_j, roll_p = slice_runs["roll"]
    assert roll_p.shape == (2, 7, SLICE_N, SLICE_N, 1)
    assert (roll_p != 0).mean() > 0.1
    np.testing.assert_allclose(roll_p, roll_j, **ROLLOUT_TOL)


def test_kernel_arm_backward_runs_the_ell_functions(slice_runs):
    pt = slice_runs["pt"]
    b = next(pt.pipeline.batches("train", pad_to_full=True))
    x, _, keys = pt._tensors(b)
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
    assert {"LSTMLayerFnBackward", "EllSpmmFnBackward"} <= names
    assert "PairProjectFnBackward" not in names


def test_serve_reports_the_resident_supports():
    cfg, data = _slice_data(pred_len=2)
    stats = {}
    for payload in ("f32", "int8"):
        eng = ServeEngine(cfg.replace(support_payload=payload), data,
                          ServeConfig(buckets=(1,)), device="cpu",
                          allow_fresh=True)
        try:
            md = eng.pipeline.modes["test"]
            t = eng.submit(md.x[0, ..., 0], int(md.keys[0]))
            assert t.wait(120) and t.ok, t.error
            assert t.pred.shape == (2, SLICE_N, SLICE_N, 1)
            stats[payload] = eng.stats()["support"]
        finally:
            eng.close()
        banks = eng.banks
        assert stats[payload]["resident_bytes"] == sum(
            container_nbytes(b) for b in banks.values())
    assert stats["f32"]["impl"] == stats["int8"]["impl"] == "ell"
    assert stats["f32"]["dense_f32_bytes"] == 4 * SLICE_N ** 2 * 3 * (1 + 14)
    assert stats["int8"]["reduction"] > 3 * stats["f32"]["reduction"]


def test_cli_runs_the_sparse_path_on_the_cpu(tmp_path, capsys):
    argv = ["-GPU", "cpu", "-data", "synthetic", "-bdgcn", "ell", "-sN",
            "24", "-sT", "60", "-hidden", "8", "-epoch", "1",
            "-support-payload", "int8", "-out", str(tmp_path)]
    hist = cli.main(argv)
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"][0])
    res = cli.main(argv + ["-mode", "test", "-pred", "2"])
    assert len(res["test"]["RMSE_by_horizon"]) == 2
    out = capsys.readouterr().out
    assert "bdgcn_impl=ell (requested 'ell')" in out
    assert "support_payload=int8" in out
    with pytest.raises(SystemExit):
        cli.main(["-GPU", "cpu", "-bdgcn", "csr"])
