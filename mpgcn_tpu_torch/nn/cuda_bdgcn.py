"""K-BDGCN and K-BDGCN-bwd: the fused folded BDGCN pair projection and its
backward (counterpart of mpgcn_tpu/nn/pallas_bdgcn.py).

``folded_pair_project`` computes all K^2 (destination contraction +
projection) pairs of the origin-contracted features without building the
K^2 feature bank. On a CUDA tensor it launches the hand-written kernel of
``csrc/bdgcn_pair_fwd.cu`` (replacing ``_fwd_kernel``); on a CPU tensor it
runs ``folded_pair_project_plain``, the same function in plain PyTorch.
There is no fallback: a CUDA tensor the kernel does not take raises.
Every support count K and width C, H >= 1 is taken: past K = 5 or
C, H = 64 the entries launch their wide kernels (chunks of <= 64 and
support groups of <= 5) instead of the narrow ones.

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
"""

from __future__ import annotations

import functools

import torch

from mpgcn_tpu_torch.native.build import CudaKernel, query_int
from mpgcn_tpu_torch.nn.cuda_lstm import device_index

#: dW-partial blocks per SM: the partial buffer stays at about this many x
#: SMs x C x H floats, whatever the pair count
BWD_BLOCKS_PER_SM = 2
#: rows the dW-partial kernel stages per step (no chunk is made smaller)
_DW_ROWS_TILE = 32

BDGCN_PAIR_FWD = CudaKernel("bdgcn_pair_fwd", "bdgcn_pair_fwd_f32",
                            n_ptrs=4, n_ints=7)
BDGCN_PAIR_BWD = CudaKernel("bdgcn_pair_bwd", "bdgcn_pair_bwd_f32",
                            n_ptrs=8, n_ints=8)


def _dest(Gk: torch.Tensor, d: int, dyn: bool):
    """G_d and the einsum subscripts of its (c, e) axes."""
    return (Gk[:, d], "bce") if dyn else (Gk[0, d], "ce")


def folded_pair_project_plain(h1: torch.Tensor, Gk: torch.Tensor,
                              Wr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    h1 (K, B, M, N, C) origin contractions; Gk (Bg, K, N, N) destination
    supports with Bg in {1, B}; Wr (K, K, C, H). Returns (B, M, N, H):
    out[b, m, e] = sum_{o, d} (h1[o, b, m]^T G_d)^T Wr[o, d]."""
    K = h1.shape[0]
    dyn = Gk.shape[0] > 1
    out = None
    for o in range(K):
        for d in range(K):
            g, gs = _dest(Gk, d, dyn)
            t = torch.einsum(f"bmcl,{gs}->bmle", h1[o], g)
            p = torch.einsum("bmle,lh->bmeh", t, Wr[o, d])
            out = p if out is None else out + p
    return out


def folded_pair_project_bwd_plain(h1, Gk, Wr, dout):
    """Plain PyTorch version of ``bdgcn_pair_bwd_f32`` and its dW sum, in
    the kernel's order: Z_d = G_d dout, dh1[o] = sum_d Z_d Wr[o, d]^T,
    dW[o, d] = sum_{b, m} h1[o]^T Z_d. Returns (dh1 (K, B, M, N, C),
    dW (K, K, C, H))."""
    K = h1.shape[0]
    dyn = Gk.shape[0] > 1
    Z = []
    for d in range(K):
        g, gs = _dest(Gk, d, dyn)
        Z.append(torch.einsum(f"{gs},bmeh->bmch", g, dout))
    dh1 = torch.stack([sum(torch.einsum("bmch,lh->bmcl", Z[d], Wr[o, d])
                           for d in range(K)) for o in range(K)])
    dW = torch.stack([torch.stack([torch.einsum("bmcl,bmch->lh", h1[o], Z[d])
                                   for d in range(K)]) for o in range(K)])
    return dh1, dW


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
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 only, got {arg} "
                            f"{t.dtype}")
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
    out = torch.empty((B, M, N, H), dtype=torch.float32, device=h1.device)
    BDGCN_PAIR_FWD.launch((h1, Gk, Wr, out),
                          (K, B, M, N, C, H, Gk.shape[0]))
    return out


@functools.lru_cache(maxsize=None)
def _max_dw_chunks(index: int, K: int, C: int, H: int) -> int:
    """The most row chunks of the dW product card ``index`` takes at
    (K, C, H): bounded by what it holds at once for the kernel whose grid
    is chunks x K^2 blocks (C, H <= 64, K <= 5), not for the wide one."""
    return query_int("bdgcn_pair_bwd", "bdgcn_pair_bwd_max_blocks",
                     (K, C, H), torch.device("cuda", index))


def bwd_blocks(rows: int, K: int, C: int, H: int, device) -> int:
    """Row chunks P of the dW-product launch (one dW partial each): about
    a few blocks per SM over the K^2 pairs, never a chunk smaller than one
    staged row tile, and no more than the card takes at (K, C, H) (the
    launch is cooperative)."""
    index = device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    by_sm = -(-BWD_BLOCKS_PER_SM * sms // (K * K))
    return max(1, min(by_sm, -(-rows // _DW_ROWS_TILE),
                      _max_dw_chunks(index, K, C, H)))


def folded_pair_project_bwd(h1, Gk, Wr, dout):
    """Backward of the folded pairs for the cotangent dout (B, M, N, H):
    (dh1 (K, B, M, N, C), dW (K, K, C, H)). CPU tensors take the plain
    version; CUDA tensors launch ``bdgcn_pair_bwd_f32``, dW sum included."""
    return folded_pair_project_bwd_partials(h1, Gk, Wr, dout)[:2]


def folded_pair_project_bwd_partials(h1, Gk, Wr, dout):
    """``folded_pair_project_bwd`` with the per-block dW partials
    (P, K, K, C, H) that its dW is the fixed-order sum of
    (``dw_reduce_plain(part)`` to the last bit). The plain version computes
    dW in one piece: on the CPU the partials are dW[None]."""
    if not _is_cuda(h1, "K-BDGCN-bwd"):
        dh1, dW = folded_pair_project_bwd_plain(h1, Gk, Wr, dout)
        return dh1, dW, dW[None]
    _check_cuda_args(h1, Gk, Wr, "K-BDGCN-bwd")
    K, B, M, N, C = h1.shape
    H = Wr.shape[-1]
    if (dout.dtype != torch.float32 or dout.device != h1.device
            or tuple(dout.shape) != (B, M, N, H)):
        raise ValueError(f"dout must be float32 ({B}, {M}, {N}, {H}) on "
                         f"{h1.device}, got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    h1, Gk, Wr, dout = (t.contiguous() for t in (h1, Gk, Wr, dout))
    P = bwd_blocks(B * M * N, K, C, H, h1.device)
    dh1 = torch.empty_like(h1)
    z = torch.empty((K, B, M, N, H), dtype=torch.float32, device=h1.device)
    part = torch.empty((P, K, K, C, H), dtype=torch.float32,
                       device=h1.device)
    dW = torch.empty((K, K, C, H), dtype=torch.float32, device=h1.device)
    BDGCN_PAIR_BWD.launch((h1, Gk, Wr, dout, dh1, z, part, dW),
                          (K, B, M, N, C, H, Gk.shape[0], P))
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
