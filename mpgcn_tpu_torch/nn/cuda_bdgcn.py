"""K-BDGCN: the fused folded BDGCN pair projection (counterpart of the
forward of mpgcn_tpu/nn/pallas_bdgcn.py).

``folded_pair_project`` computes all K^2 (destination contraction +
projection) pairs of the origin-contracted features without building the
K^2 feature bank. On a CUDA tensor it launches the hand-written kernel of
``csrc/bdgcn_pair_fwd.cu`` (replacing ``_fwd_kernel``); on a CPU tensor it
runs ``folded_pair_project_plain``, the same function in plain PyTorch.
There is no fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

from mpgcn_tpu_torch.native.build import CudaKernel

#: channel and hidden widths the kernel takes (per-thread register tiles)
MAX_WIDTH = 64
#: support counts the kernel is instantiated for
MAX_K = 5

BDGCN_PAIR_FWD = CudaKernel("bdgcn_pair_fwd", "bdgcn_pair_fwd_f32",
                            n_ptrs=4, n_ints=7)


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
            if dyn:
                t = torch.einsum("bmcl,bce->bmle", h1[o], Gk[:, d])
            else:
                t = torch.einsum("bmcl,ce->bmle", h1[o], Gk[0, d])
            p = torch.einsum("bmle,lh->bmeh", t, Wr[o, d])
            out = p if out is None else out + p
    return out


def _check_cuda_args(h1, Gk, Wr) -> None:
    for name, t in (("h1", h1), ("Gk", Gk), ("Wr", Wr)):
        if t.dtype != torch.float32:
            raise TypeError(f"K-BDGCN takes float32 only, got {name} "
                            f"{t.dtype}")
        if t.device != h1.device:
            raise ValueError("h1, Gk and Wr lie on different devices")
    if h1.ndim != 5 or Gk.ndim != 4 or Wr.ndim != 4:
        raise ValueError(f"expected h1 (K, B, M, N, C), Gk (Bg, K, N, N), "
                         f"Wr (K, K, C, H); got {tuple(h1.shape)}, "
                         f"{tuple(Gk.shape)}, {tuple(Wr.shape)}")
    K, B, M, N, C = h1.shape
    H = Wr.shape[-1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K-BDGCN takes 1..{MAX_K} supports, got K={K}")
    if not (1 <= C <= MAX_WIDTH and 1 <= H <= MAX_WIDTH):
        raise ValueError(f"K-BDGCN takes channel and hidden widths "
                         f"1..{MAX_WIDTH}, got C={C}, H={H}")
    if Gk.shape[0] not in (1, B) or tuple(Gk.shape[1:]) != (K, N, N):
        raise ValueError(f"Gk must be (1 or {B}, {K}, {N}, {N}), got "
                         f"{tuple(Gk.shape)}")
    if tuple(Wr.shape[:3]) != (K, K, C):
        raise ValueError(f"Wr must be ({K}, {K}, {C}, H), got "
                         f"{tuple(Wr.shape)}")
    if B > 65535 or M > 65535:
        raise ValueError(f"K-BDGCN grid takes B, M <= 65535, got B={B}, "
                         f"M={M}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (h1, Gk, Wr)):
        raise RuntimeError("K-BDGCN is inference-only (no backward kernel "
                           "yet); call it under torch.no_grad()")


def folded_pair_project(h1: torch.Tensor, Gk: torch.Tensor,
                        Wr: torch.Tensor) -> torch.Tensor:
    """Fused folded BDGCN pairs: (K, B, M, N, C) -> (B, M, N, H). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if h1.device.type == "cpu":
        return folded_pair_project_plain(h1, Gk, Wr)
    if h1.device.type != "cuda":
        raise ValueError(f"K-BDGCN runs on cuda or cpu tensors, got "
                         f"{h1.device}")
    _check_cuda_args(h1, Gk, Wr)
    K, B, M, N, C = h1.shape
    H = Wr.shape[-1]
    h1, Gk, Wr = h1.contiguous(), Gk.contiguous(), Wr.contiguous()
    out = torch.empty((B, M, N, H), dtype=torch.float32, device=h1.device)
    BDGCN_PAIR_FWD.launch((h1, Gk, Wr, out),
                          (K, B, M, N, C, H, Gk.shape[0]))
    return out
