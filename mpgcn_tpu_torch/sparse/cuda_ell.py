"""The ELL SpMM kernels: blocked-ELL forward, dX and dBlocks, on f32, bf16
or int8 tiles (counterpart of mpgcn_tpu/sparse/pallas_ell.py).

Every function here works on a flattened stack: ``cols`` (S, NB, MB)
int32, tiles (S, NB, MB, 8, BC) and, for the int8 payload, ``scale``
(S, NB, 1, 1, 1); ``X`` (G, n_cols, F) f32 with S = G * x_div, slice s
reading X[s // x_div] (one X shared by the stack when G = 1).
sparse/kernels.py ``ell_spmm`` flattens a container's leading dims to it.

On a CUDA tensor each entry launches its kernel of ``csrc/ell_spmm.cu``:

  * ``ell_fwd``: ``ell_fwd`` (f32 or bf16 tiles; replaces ``_fwd_kernel``)
    or ``ell_fwd_q`` (int8 codes; ``_fwd_kernel_q``), on the TF32 tensor
    cores, each block sharing the X slabs of a column block across a row
    group whose populated slots it finds in the transposed block index;
  * ``ell_bwd_dx``: ``ell_bwd_dx`` (``_bwd_dx_kernel``) or ``ell_bwd_dx_q``
    (``_bwd_dx_kernel_q``), on the TF32 tensor cores, each block summing
    one (BC x 128) tile of dX over its column block's slots in the
    container's transposed block index, in a fixed order, without
    atomics;
  * ``ell_bwd_dblk``: ``ell_bwd_dblk`` (``_bwd_dblk_kernel``), on the TF32
    tensor cores (wgmma), each block contracting the gathered dout rows of
    up to 16 slots on one column block against that block's X slab,
    staged once; F is split into chunks whose sums are added in a fixed
    order.

On a CPU tensor each runs its plain version, the same function in stock
PyTorch as sparse/kernels.py ``_ell_rows_jnp`` computes it: a loop over
the MB slots, each a gather of X's column blocks and a batched product
(int8 codes dequantised as ``codes.float() * scale`` first). There is no
fallback: a CUDA tensor the kernel does not take raises.

``EllSpmmFn`` and ``EllSpmmQFn`` are the autograd Functions (the custom
VJPs ``_ell_pallas`` and ``_ell_pallas_q``). ``EllSpmmFn.backward``
launches ``ell_bwd_dx`` for X, and ``ell_bwd_dblk`` only when the tiles
require grad; the int8 codes are data, so ``EllSpmmQFn`` returns dX only
(the scale gets a zero gradient, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn

from mpgcn_tpu_torch.native.build import CudaKernel

#: the tile height every container has, and the widest tile the kernels take
BR = 8
MAX_BC = 128
#: the kernels' payload codes (csrc/ell_spmm.cu ``Payload``)
_PAYLOAD_CODE = {torch.float32: 0, torch.bfloat16: 1}

ELL_FWD = CudaKernel("ell_spmm", "ell_fwd", n_ptrs=5, n_ints=9)
ELL_FWD_Q = CudaKernel("ell_spmm", "ell_fwd_q", n_ptrs=6, n_ints=8)
ELL_BWD_DX = CudaKernel("ell_spmm", "ell_bwd_dx", n_ptrs=5, n_ints=9)
ELL_BWD_DX_Q = CudaKernel("ell_spmm", "ell_bwd_dx_q", n_ptrs=6, n_ints=8)
ELL_BWD_DBLK = CudaKernel("ell_spmm", "ell_bwd_dblk", n_ptrs=6, n_ints=9)
#: dBlocks (csrc/ell_spmm.cu kDbSlots, kDbTF): slots per tile, F columns
#: per staged step; at most this many steps summed by one block (the rest
#: go to other F chunks), and blocks per SM to aim at (one is resident at
#: a time)
DBLK_SLOTS, DBLK_TF, DBLK_MAX_STEPS, DBLK_WAVES = 16, 32, 128, 2


# --- plain versions ---------------------------------------------------------


def _tile_values(blocks, scale, j):
    """Slot j's tiles (S, NB, BR, BC) in f32 (float64 tiles or scales: in
    float64, for a reference), int8 codes dequantised."""
    blk = blocks[:, :, j]
    if blk.dtype != torch.float64:
        blk = blk.float()
    if scale is not None:
        blk = blk * scale.reshape(scale.shape[0], scale.shape[1], 1, 1)
    return blk


def _col_blocked(X, bc: int):
    """X (G, n_cols, F) -> (G, NBc, BC, F), zero rows past n_cols."""
    G, n_cols, F = X.shape
    ncp = -(-n_cols // bc) * bc
    return Fn.pad(X, (0, 0, 0, ncp - n_cols)).reshape(G, ncp // bc, bc, F)


def _x_index(cols, j, x_div):
    """(group, column block) of each (s, i) for slot j."""
    S = cols.shape[0]
    g = torch.arange(S, device=cols.device)[:, None] // x_div
    return g, cols[:, :, j].long()


def ell_fwd_plain(cols, blocks, X, n_rows: int, x_div: int,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the forward: -> (S, n_rows, F) f32."""
    S, NB, MB = cols.shape
    Xb = _col_blocked(X, blocks.shape[-1])
    acc = X.new_zeros((S, NB, BR, X.shape[-1]))
    for j in range(MB):
        g, c = _x_index(cols, j, x_div)
        acc = acc + torch.einsum("snrc,sncf->snrf",
                                 _tile_values(blocks, scale, j), Xb[g, c])
    return acc.reshape(S, NB * BR, -1)[:, :n_rows]


def ell_bwd_dx_plain(cols, blocks, dout, n_cols: int, x_div: int,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of dX: dout (S, n_rows, F) -> (S // x_div, n_cols, F),
    each slot's blocks^T @ dout added into its column block."""
    S, NB, MB = cols.shape
    bc = blocks.shape[-1]
    nbc = -(-n_cols // bc)
    F = dout.shape[-1]
    d = Fn.pad(dout, (0, 0, 0, NB * BR - dout.shape[1])).reshape(
        S, NB, BR, F)
    dx = dout.new_zeros((S // x_div * nbc, bc, F))
    for j in range(MB):
        g, c = _x_index(cols, j, x_div)
        contrib = torch.einsum("snrc,snrf->sncf",
                               _tile_values(blocks, scale, j), d)
        dx.index_add_(0, (g * nbc + c).reshape(-1),
                      contrib.reshape(S * NB, bc, F))
    return dx.reshape(S // x_div, nbc * bc, F)[:, :n_cols]


def ell_bwd_dblk_plain(cols, X, dout, bc: int, x_div: int) -> torch.Tensor:
    """Plain version of dBlocks: -> (S, NB, MB, BR, bc) f32, pad slots
    included (they pair with column block 0)."""
    S, NB, MB = cols.shape
    F = X.shape[-1]
    Xb = _col_blocked(X, bc)
    d = Fn.pad(dout, (0, 0, 0, NB * BR - dout.shape[1])).reshape(
        S, NB, BR, F)
    out = []
    for j in range(MB):
        g, c = _x_index(cols, j, x_div)
        out.append(torch.einsum("snrf,sncf->snrc", d, Xb[g, c]))
    return torch.stack(out, dim=2)


# --- kernel launches --------------------------------------------------------


def _is_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.device.type == "cuda"


def _check_stack(name, cols, tiles, scale, n_cols: int, device,
                 t_index=None):
    """Raise on a stack the kernels do not take; returns (S, NB, MB, BC,
    payload code)."""
    if cols.ndim != 3 or tiles.ndim != 5:
        raise ValueError(f"{name}: expected cols (S, NB, MB) and tiles (S, "
                         f"NB, MB, {BR}, BC); got {tuple(cols.shape)} and "
                         f"{tuple(tiles.shape)}")
    S, NB, MB = cols.shape
    bc = tiles.shape[-1]
    if tuple(tiles.shape[:4]) != (S, NB, MB, BR) or not 1 <= bc <= MAX_BC:
        raise ValueError(f"{name}: tiles must be ({S}, {NB}, {MB}, {BR}, "
                         f"1..{MAX_BC}), got {tuple(tiles.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 cols, got {cols.dtype}")
    if scale is None:
        if tiles.dtype not in _PAYLOAD_CODE:
            raise TypeError(f"{name} takes float32 or bfloat16 tiles, got "
                            f"{tiles.dtype}")
        code = _PAYLOAD_CODE[tiles.dtype]
    else:
        if tiles.dtype != torch.int8 or scale.dtype != torch.float32 \
                or scale.numel() != S * NB:
            raise TypeError(f"{name} takes int8 codes and {S * NB} float32 "
                            f"scales, got {tiles.dtype} and {scale.dtype} "
                            f"{tuple(scale.shape)}")
        code = None
    nbc = -(-n_cols // bc)
    if not 1 <= MB <= nbc:
        raise ValueError(f"{name}: {MB} slots per row block for {nbc} "
                         f"column blocks")
    if t_index is not None:
        t_ptr, t_slot = t_index
        if (tuple(t_ptr.shape) != (S, nbc + 1)
                or tuple(t_slot.shape) != (S, NB * MB)
                or t_ptr.dtype != torch.int32
                or t_slot.dtype != torch.int32):
            raise ValueError(f"{name}: the transposed index must be int32 "
                             f"({S}, {nbc + 1}) and ({S}, {NB * MB}), got "
                             f"{tuple(t_ptr.shape)} and "
                             f"{tuple(t_slot.shape)}")
    for t in (cols, tiles, scale, *(t_index or ())):
        if t is not None and t.device != device:
            raise ValueError(f"{name}: inputs lie on different devices")
    return S, NB, MB, bc, code


def _check_dense(name, t, shape):
    """t must be a float32 tensor of ``shape`` (None matches any size)."""
    if (t.dtype != torch.float32 or t.ndim != len(shape)
            or any(w is not None and w != d for w, d in zip(shape, t.shape))):
        raise ValueError(f"{name} must be float32 of shape "
                         f"{tuple('*' if w is None else w for w in shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def ell_fwd(cols, blocks, t_ptr, t_slot, X, n_rows: int, x_div: int,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward: -> (S, n_rows, F). CPU tensors take the plain version,
    which computes every slot and needs no index; CUDA tensors launch
    ``ell_fwd`` (f32/bf16 tiles) or ``ell_fwd_q`` (int8 codes with
    ``scale``), which walk the transposed index (t_ptr, t_slot) and so
    read the populated slots only."""
    if not _is_cuda(X, "ELL SpMM"):
        return ell_fwd_plain(cols, blocks, X, n_rows, x_div, scale)
    _check_dense("ELL SpMM X", X, (None, None, None))
    S, NB, MB, bc, code = _check_stack("ELL SpMM", cols, blocks, scale,
                                       X.shape[1], X.device, (t_ptr, t_slot))
    if x_div < 1 or S % x_div:
        raise ValueError(f"ELL SpMM: x_div={x_div} does not divide S={S}")
    _check_dense("ELL SpMM X", X, (S // x_div, None, None))
    if not 1 <= n_rows <= NB * BR:
        raise ValueError(f"ELL SpMM: n_rows={n_rows} for {NB} row blocks")
    G, n_cols, F = X.shape
    out = torch.empty((S, n_rows, F), dtype=torch.float32, device=X.device)
    if F == 0:
        return out
    t_ptr, t_slot, blocks, X = (t.contiguous()
                                for t in (t_ptr, t_slot, blocks, X))
    dims = (S, NB, MB, bc, n_rows, n_cols, F, x_div)
    if scale is None:
        ELL_FWD.launch((t_ptr, t_slot, blocks, X, out), (code, *dims))
    else:
        ELL_FWD_Q.launch((t_ptr, t_slot, blocks, scale.contiguous(), X, out),
                         dims)
    return out


def ell_bwd_dx(cols, blocks, t_ptr, t_slot, dout, n_cols: int, x_div: int,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dX for the cotangent dout (S, n_rows, F): -> (S // x_div, n_cols, F).
    CPU tensors take the plain version; CUDA tensors launch ``ell_bwd_dx``
    or ``ell_bwd_dx_q``, which walk the transposed index (t_ptr, t_slot)."""
    if not _is_cuda(dout, "ELL SpMM dX"):
        return ell_bwd_dx_plain(cols, blocks, dout, n_cols, x_div, scale)
    S, NB, MB, bc, code = _check_stack("ELL SpMM dX", cols, blocks, scale,
                                       n_cols, dout.device, (t_ptr, t_slot))
    if x_div < 1 or S % x_div:
        raise ValueError(f"ELL SpMM dX: x_div={x_div} does not divide S={S}")
    _check_dense("ELL SpMM dX dout", dout, (S, None, None))
    n_rows, F = dout.shape[1:]
    if not 1 <= n_rows <= NB * BR:
        raise ValueError(f"ELL SpMM dX: {n_rows} dout rows for {NB} row "
                         f"blocks")
    dx = torch.empty((S // x_div, n_cols, F), dtype=torch.float32,
                     device=dout.device)
    if F == 0:
        return dx
    dims = (S, NB, MB, bc, n_rows, n_cols, F, x_div)
    t_ptr, t_slot, blocks = (t.contiguous() for t in (t_ptr, t_slot, blocks))
    if scale is None:
        ELL_BWD_DX.launch((t_ptr, t_slot, blocks, dout.contiguous(), dx),
                          (code, *dims))
    else:
        ELL_BWD_DX_Q.launch((t_ptr, t_slot, blocks, scale.contiguous(),
                             dout.contiguous(), dx), dims)
    return dx


def dblk_chunks(S: int, NB: int, MB: int, x_div: int, F: int,
                sms: int) -> int:
    """The F chunks of a dBlocks launch: enough blocks for DBLK_WAVES per
    SM over the slot tiles (about S NB MB / 16 of them), no block summing
    more than DBLK_MAX_STEPS steps, no chunk empty."""
    steps = -(-F // DBLK_TF)
    tiles = S // x_div * -(-x_div * NB * MB // DBLK_SLOTS)
    n = min(steps, max(-(-DBLK_WAVES * sms // tiles),
                       -(-steps // DBLK_MAX_STEPS)))
    return -(-steps // -(-steps // n))


def ell_bwd_dblk(cols, X, dout, bc: int, x_div: int) -> torch.Tensor:
    """dBlocks for the cotangent dout (S, n_rows, F): -> (S, NB, MB, 8, bc)
    f32. CPU tensors take the plain version; CUDA tensors launch
    ``ell_bwd_dblk``, with scratch for its F chunks' sums and tickets."""
    if not _is_cuda(X, "ELL SpMM dBlocks"):
        return ell_bwd_dblk_plain(cols, X, dout, bc, x_div)
    _check_dense("ELL SpMM dBlocks X", X, (None, None, None))
    if cols.ndim != 3 or cols.dtype != torch.int32 or not 1 <= bc <= MAX_BC:
        raise ValueError(f"ELL SpMM dBlocks: expected int32 cols (S, NB, MB) "
                         f"and 1 <= bc <= {MAX_BC}, got {cols.dtype} "
                         f"{tuple(cols.shape)} and bc={bc}")
    S, NB, MB = cols.shape
    if x_div < 1 or S % x_div:
        raise ValueError(f"ELL SpMM dBlocks: x_div={x_div} does not divide "
                         f"S={S}")
    _check_dense("ELL SpMM dBlocks X", X, (S // x_div, None, None))
    G, n_cols, F = X.shape
    _check_dense("ELL SpMM dBlocks dout", dout, (S, None, F))
    if not 1 <= dout.shape[1] <= NB * BR or not MB <= -(-n_cols // bc):
        raise ValueError(f"ELL SpMM dBlocks: {dout.shape[1]} dout rows for "
                         f"{NB} row blocks, {MB} slots for {n_cols} columns")
    if cols.device != X.device or dout.device != X.device:
        raise ValueError("ELL SpMM dBlocks: inputs lie on different devices")
    dblk = torch.empty((S, NB, MB, BR, bc), dtype=torch.float32,
                       device=X.device)
    if F == 0:
        return dblk.zero_()
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    n_chunks = dblk_chunks(S, NB, MB, x_div, F, sms)
    part = tickets = None
    if n_chunks > 1:
        part = torch.empty((n_chunks, *dblk.shape), dtype=torch.float32,
                           device=X.device)
        tiles = -(-x_div * NB * MB // DBLK_SLOTS)
        tickets = torch.zeros((S // x_div, tiles, -(-n_cols // bc)),
                              dtype=torch.int32, device=X.device)
    ELL_BWD_DBLK.launch((cols.contiguous(), X.contiguous(),
                         dout.contiguous(), dblk, part, tickets),
                        (S, NB, MB, bc, dout.shape[1], n_cols, F, x_div,
                         n_chunks))
    return dblk


# --- autograd ---------------------------------------------------------------


class EllSpmmFn(torch.autograd.Function):
    """(cols, blocks, t_ptr, t_slot, X) -> (S, n_rows, F) on f32 or bf16
    tiles, with the hand-written backward (the custom VJP ``_ell_pallas``).
    X is saved only when the tiles require grad (dBlocks needs it; dX does
    not).

    The transposed index leaves out pad slots, whose tiles are zero when
    the container is packed. dBlocks gives pad slots a cotangent like any
    slot (the JAX semantics), so a caller that updates the tiles must keep
    the pad tiles zero: the forward and dX kernels read only the indexed
    slots, the plain versions every slot."""

    @staticmethod
    def forward(ctx, cols, blocks, t_ptr, t_slot, X, n_rows, x_div):
        need_blk = ctx.needs_input_grad[1]
        ctx.save_for_backward(cols, blocks, t_ptr, t_slot,
                              X if need_blk else None)
        ctx.dims = (X.shape[1], x_div)
        return ell_fwd(cols, blocks, t_ptr, t_slot, X, n_rows, x_div)

    @staticmethod
    def backward(ctx, dout):
        cols, blocks, t_ptr, t_slot, X = ctx.saved_tensors
        n_cols, x_div = ctx.dims
        dX = dblk = None
        if ctx.needs_input_grad[4]:
            dX = ell_bwd_dx(cols, blocks, t_ptr, t_slot, dout, n_cols, x_div)
        if ctx.needs_input_grad[1]:
            dblk = ell_bwd_dblk(cols, X, dout, blocks.shape[-1],
                                x_div).to(blocks.dtype)
        return None, dblk, None, None, dX, None, None


class EllSpmmQFn(torch.autograd.Function):
    """The int8-payload twin (the custom VJP ``_ell_pallas_q``): codes and
    scales are data, so the backward gives dX only."""

    @staticmethod
    def forward(ctx, cols, codes, scale, t_ptr, t_slot, X, n_rows, x_div):
        ctx.save_for_backward(cols, codes, scale, t_ptr, t_slot)
        ctx.dims = (X.shape[1], x_div)
        return ell_fwd(cols, codes, t_ptr, t_slot, X, n_rows, x_div, scale)

    @staticmethod
    def backward(ctx, dout):
        cols, codes, scale, t_ptr, t_slot = ctx.saved_tensors
        n_cols, x_div = ctx.dims
        dX = None
        if ctx.needs_input_grad[5]:
            dX = ell_bwd_dx(cols, codes, t_ptr, t_slot, dout, n_cols, x_div,
                            scale)
        return None, None, None, None, None, dX, None, None
