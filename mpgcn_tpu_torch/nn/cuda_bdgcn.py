"""K-BDGCN and K-BDGCN-bwd: the fused folded BDGCN pair projection and its
backward (counterpart of mpgcn_tpu/nn/pallas_bdgcn.py).

``folded_pair_project`` computes all K^2 (destination contraction +
projection) pairs of the origin-contracted features without building the
K^2 feature bank. On a CUDA tensor it launches the hand-written kernel of
``csrc/bdgcn_pair_fwd.cu`` (replacing ``_fwd_kernel``); on a CPU tensor it
runs ``folded_pair_project_plain``, the same function in plain PyTorch.
There is no fallback: a CUDA tensor the kernel does not take raises.
Every support count K and width C, H >= 1 is taken. The forward projects
by Wr first; both entries run their products on the TF32 tensor cores with
split operands (``csrc/bdgcn_gemm.cuh``), through a scratch the wrapper
allocates: U (K, B, M, N, H) in the forward, Z of the same shape in the
backward.

Under autograd it goes through ``PairProjectFn``, whose backward
``folded_pair_project_bwd`` launches ``bdgcn_pair_bwd_f32`` of
``csrc/bdgcn_pair_bwd.cu`` (replacing ``_bwd_kernel``) for dh1 and dW: its
dW product is a cooperative launch whose blocks write per-block partials
and then, after a grid-wide barrier, sum them in a fixed order
(``cuda_lstm.dw_reduce_plain`` is that sum's plain version, as for the
LSTM BPTT). The JAX package sends small pair counts to an XLA einsum loop
instead of its backward kernel; this port has no such switch. The support
cotangent stays plain einsums (``_grad_g``), computed only when a support
requires grad, as the JAX package leaves it to XLA.

Both entries also take bf16 storage (``-dtype bfloat16``; the JAX kernels
in their bf16 dtype): h1, Gk, Wr, out, dout and dh1 in bf16, every product
summed in f32, the intermediate U (forward) and Z (backward) rounded to
bf16 as the JAX kernels round their pair temp, dW summed in f32 and then
cast. CUDA tensors launch ``bdgcn_pair_fwd_bf16`` / ``bdgcn_pair_bwd_bf16``:
the operands widened into f32 scratch, the same split-TF32 products, the
stored results rounded (a bf16 value splits into TF32 with a zero
remainder, so the products are those of the bf16 values). The plain
versions compute in f32 with the same rounding points.
"""

from __future__ import annotations

import functools

import torch

from mpgcn_tpu_torch.native.build import CudaKernel, query_int
from mpgcn_tpu_torch.nn.cuda_lstm import device_index, plain_dtype, store_round

#: rows of the dW product's smallest chunk: four 32-row staged slabs
_DW_ROWS_TILE = 128

BDGCN_PAIR_FWD = CudaKernel("bdgcn_pair_fwd", "bdgcn_pair_fwd_f32",
                            n_ptrs=5, n_ints=7)
BDGCN_PAIR_BWD = CudaKernel("bdgcn_pair_bwd", "bdgcn_pair_bwd_f32",
                            n_ptrs=8, n_ints=8)
BDGCN_PAIR_FWD_BF16 = CudaKernel("bdgcn_pair_fwd", "bdgcn_pair_fwd_bf16",
                                 n_ptrs=5, n_ints=7)
BDGCN_PAIR_BWD_BF16 = CudaKernel("bdgcn_pair_bwd", "bdgcn_pair_bwd_bf16",
                                 n_ptrs=8, n_ints=8)


def _dest(Gk: torch.Tensor, d: int, dyn: bool):
    """G_d and the einsum subscripts of its (c, e) axes."""
    return (Gk[:, d], "bce") if dyn else (Gk[0, d], "ce")


def folded_pair_project_plain(h1: torch.Tensor, Gk: torch.Tensor,
                              Wr: torch.Tensor, acc=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in its order.

    h1 (K, B, M, N, C) origin contractions; Gk (Bg, K, N, N) destination
    supports with Bg in {1, B}; Wr (K, K, C, H). Returns (B, M, N, H):
    out[b, m, e] = sum_{o, d} (h1[o, b, m]^T G_d)^T Wr[o, d], computed by
    Wr first, U_d = sum_o h1[o] Wr[o, d], then out = sum_d G_d^T U_d; in
    ``plain_dtype`` (cuda_lstm.py), U and out rounded to the storage."""
    S = h1.dtype
    if S != torch.float32 or acc is not None:
        A = plain_dtype(S, acc)
        U = store_round(torch.einsum("obmcl,odlh->dbmch", h1.to(A),
                                     Wr.to(A)), S)
        G = Gk.to(A)
        out = (torch.einsum("bdce,dbmch->bmeh", G, U) if Gk.shape[0] > 1
               else torch.einsum("dce,dbmch->bmeh", G[0], U))
        return store_round(out, S).to(S)
    U = torch.einsum("obmcl,odlh->dbmch", h1, Wr)
    if Gk.shape[0] > 1:
        return torch.einsum("bdce,dbmch->bmeh", Gk, U)
    return torch.einsum("dce,dbmch->bmeh", Gk[0], U)


def folded_pair_project_bwd_plain(h1, Gk, Wr, dout, acc=None):
    """Plain PyTorch version of ``bdgcn_pair_bwd_f32`` (and ``_bf16``) and
    its dW sum, in the kernel's order: Z_d = G_d dout, dh1[o] = sum_d Z_d
    Wr[o, d]^T, dW[o, d] = sum_{b, m} h1[o]^T Z_d. Returns (dh1 (K, B, M,
    N, C) in h1's dtype, dW (K, K, C, H) in ``plain_dtype``, unrounded).
    In bf16, Z and dh1 are rounded to bf16 as the kernel stores them. dW
    sums B M N products an entry, so it is summed in float64 and rounded
    once: on the H100 an f32 matrix product over the 500,000 rows of N =
    500 came within 4% of the dW tolerance from the float64 sum on its
    own, which left no room for the kernel's error."""
    S = h1.dtype
    A = plain_dtype(S, acc)
    h1, Gk, Wr, dout = (t.to(A) for t in (h1, Gk, Wr, dout))
    K = h1.shape[0]
    dyn = Gk.shape[0] > 1
    Z = []
    for d in range(K):
        g, gs = _dest(Gk, d, dyn)
        Z.append(store_round(torch.einsum(f"{gs},bmeh->bmch", g, dout), S))
    dh1 = torch.stack([sum(torch.einsum("bmch,lh->bmcl", Z[d], Wr[o, d])
                           for d in range(K)) for o in range(K)])
    dW = torch.stack([torch.stack([
        torch.einsum("bmcl,bmch->lh", h1[o].double(), Z[d].double())
        for d in range(K)]) for o in range(K)]).to(A)
    return store_round(dh1, S).to(S), dW


def _grad_g(h1, Gk, Wr, dout):
    """The support cotangent (plain einsums outside any kernel, as the JAX
    package's ``_grad_g`` leaves it to XLA)."""
    K = h1.shape[0]
    dyn = Gk.shape[0] > 1
    dG = torch.zeros_like(Gk)
    for o in range(K):
        for d in range(K):
            u = torch.einsum("bmeh,lh->bmel", dout, Wr[o, d])
            if dyn:
                dG[:, d] += torch.einsum("bmcl,bmel->bce", h1[o], u)
            else:
                dG[0, d] += torch.einsum("bmcl,bmel->ce", h1[o], u)
    return dG


def _is_cuda(h1: torch.Tensor, name: str) -> bool:
    if h1.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{h1.device}")
    return h1.device.type == "cuda"


def _check_cuda_args(h1, Gk, Wr, name: str = "K-BDGCN") -> None:
    for arg, t in (("h1", h1), ("Gk", Gk), ("Wr", Wr)):
        if t.dtype not in (torch.float32, torch.bfloat16) \
                or t.dtype != h1.dtype:
            raise TypeError(f"{name} takes float32 or bfloat16 tensors of "
                            f"one dtype, got {arg} {t.dtype} beside h1 "
                            f"{h1.dtype}")
        if t.device != h1.device:
            raise ValueError("h1, Gk and Wr lie on different devices")
    if h1.ndim != 5 or Gk.ndim != 4 or Wr.ndim != 4:
        raise ValueError(f"expected h1 (K, B, M, N, C), Gk (Bg, K, N, N), "
                         f"Wr (K, K, C, H); got {tuple(h1.shape)}, "
                         f"{tuple(Gk.shape)}, {tuple(Wr.shape)}")
    K, B, M, N, C = h1.shape
    if min(h1.shape) < 1 or Wr.shape[-1] < 1:
        raise ValueError(f"empty h1 {tuple(h1.shape)} or Wr "
                         f"{tuple(Wr.shape)}")
    if Gk.shape[0] not in (1, B) or tuple(Gk.shape[1:]) != (K, N, N):
        raise ValueError(f"Gk must be (1 or {B}, {K}, {N}, {N}), got "
                         f"{tuple(Gk.shape)}")
    if tuple(Wr.shape[:3]) != (K, K, C):
        raise ValueError(f"Wr must be ({K}, {K}, {C}, H), got "
                         f"{tuple(Wr.shape)}")
    if B > 65535 or M > 65535:
        raise ValueError(f"{name} grid takes B, M <= 65535, got B={B}, "
                         f"M={M}")


def _pair_project(h1, Gk, Wr):
    if not _is_cuda(h1, "K-BDGCN"):
        return folded_pair_project_plain(h1, Gk, Wr)
    _check_cuda_args(h1, Gk, Wr)
    K, B, M, N, C = h1.shape
    H = Wr.shape[-1]
    h1, Gk, Wr = h1.contiguous(), Gk.contiguous(), Wr.contiguous()
    out = torch.empty((B, M, N, H), dtype=h1.dtype, device=h1.device)
    dims = (K, B, M, N, C, H, Gk.shape[0])
    if h1.dtype == torch.float32:
        u = torch.empty((K, B, M, N, H), dtype=torch.float32,
                        device=h1.device)
        BDGCN_PAIR_FWD.launch((h1, Gk, Wr, out, u), dims)
    else:
        BDGCN_PAIR_FWD_BF16.launch(
            (h1, Gk, Wr, out, _bf16_scratch("bdgcn_pair_fwd", dims,
                                            h1.device)), dims)
    return out


def _bf16_scratch(source: str, dims, device) -> torch.Tensor:
    """The f32 scratch a bf16 entry of ``source`` takes at ``dims``."""
    k = query_int(source, f"{source}_bf16_scratch_k", dims, device)
    return torch.empty(k * 1024, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _max_dw_chunks(index: int, K: int, C: int, H: int) -> int:
    """The row chunks of the dW product at (K, C, H) whose work items
    (chunk, tile) fill about two rounds of the blocks card ``index`` holds
    at once (the dW kernel's occupancy at the shared memory it launches
    with)."""
    return query_int("bdgcn_pair_bwd", "bdgcn_pair_bwd_max_blocks",
                     (K, C, H), torch.device("cuda", index))


def bwd_blocks(rows: int, K: int, C: int, H: int, device) -> int:
    """Row chunks P of the dW-product launch (one dW partial each): about
    two rounds of the blocks the card holds at once over the tiles of
    (K C, K H) (``_max_dw_chunks``), never a chunk smaller than
    ``_DW_ROWS_TILE`` rows."""
    index = device_index(device)
    return max(1, min(-(-rows // _DW_ROWS_TILE),
                      _max_dw_chunks(index, K, C, H)))


def folded_pair_project_bwd(h1, Gk, Wr, dout):
    """Backward of the folded pairs for the cotangent dout (B, M, N, H):
    (dh1 (K, B, M, N, C), dW (K, K, C, H)), in h1's dtype (dW summed in
    f32, then cast). CPU tensors take the plain version; CUDA tensors
    launch ``bdgcn_pair_bwd_f32`` (or ``_bf16``), dW sum included."""
    dh1, dW, _ = folded_pair_project_bwd_partials(h1, Gk, Wr, dout)
    return dh1, dW.to(Wr.dtype)


def folded_pair_project_bwd_partials(h1, Gk, Wr, dout):
    """``folded_pair_project_bwd`` with the per-block dW partials
    (P, K, K, C, H) that its dW is the fixed-order sum of
    (``dw_reduce_plain(part)`` to the last bit); dW and the partials f32,
    before any cast. The plain version computes dW in one piece: on the
    CPU the partials are dW[None]."""
    if not _is_cuda(h1, "K-BDGCN-bwd"):
        dh1, dW = folded_pair_project_bwd_plain(h1, Gk, Wr, dout)
        return dh1, dW, dW[None]
    _check_cuda_args(h1, Gk, Wr, "K-BDGCN-bwd")
    K, B, M, N, C = h1.shape
    H = Wr.shape[-1]
    if (dout.dtype != h1.dtype or dout.device != h1.device
            or tuple(dout.shape) != (B, M, N, H)):
        raise ValueError(f"dout must be {h1.dtype} ({B}, {M}, {N}, {H}) on "
                         f"{h1.device}, got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    h1, Gk, Wr, dout = (t.contiguous() for t in (h1, Gk, Wr, dout))
    P = bwd_blocks(B * M * N, K, C, H, h1.device)
    dh1 = torch.empty_like(h1)
    part = torch.empty((P, K, K, C, H), dtype=torch.float32,
                       device=h1.device)
    dW = torch.empty((K, K, C, H), dtype=torch.float32, device=h1.device)
    dims = (K, B, M, N, C, H, Gk.shape[0])
    if h1.dtype == torch.float32:
        z = torch.empty((K, B, M, N, H), dtype=torch.float32,
                        device=h1.device)
        BDGCN_PAIR_BWD.launch((h1, Gk, Wr, dout, dh1, z, part, dW),
                              (*dims, P))
    else:
        BDGCN_PAIR_BWD_BF16.launch(
            (h1, Gk, Wr, dout, dh1,
             _bf16_scratch("bdgcn_pair_bwd", dims, h1.device), part, dW),
            (*dims, P))
    return dh1, dW, part


class PairProjectFn(torch.autograd.Function):
    """(h1, Gk, Wr) -> (B, M, N, H) with the hand-written backward (the
    counterpart of ``_pair_project``'s custom VJP). Saves h1, Gk and Wr
    only: the K^2 pair bank is never stored, the backward recomputes what
    it needs."""

    @staticmethod
    def forward(ctx, h1, Gk, Wr):
        ctx.save_for_backward(h1, Gk, Wr)
        return _pair_project(h1, Gk, Wr)

    @staticmethod
    def backward(ctx, dout):
        h1, Gk, Wr = ctx.saved_tensors
        need_h1, need_g, need_w = ctx.needs_input_grad
        dh1 = dW = None
        if need_h1 or need_w:
            dh1, dW = folded_pair_project_bwd(h1, Gk, Wr, dout)
        dG = _grad_g(h1, Gk, Wr, dout) if need_g else None
        return (dh1 if need_h1 else None), dG, (dW if need_w else None)


def folded_pair_project(h1: torch.Tensor, Gk: torch.Tensor,
                        Wr: torch.Tensor) -> torch.Tensor:
    """Fused folded BDGCN pairs: (K, B, M, N, C) -> (B, M, N, H). CPU
    tensors take the plain version; CUDA tensors launch the kernel. When
    autograd records (grad on and an input requires grad) the call goes
    through ``PairProjectFn`` and its backward kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h1, Gk, Wr)):
        return PairProjectFn.apply(h1, Gk, Wr)
    return _pair_project(h1, Gk, Wr)
