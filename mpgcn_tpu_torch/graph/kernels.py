"""Graph-support kernel factory in PyTorch (counterpart of
mpgcn_tpu/graph/kernels.py).

Turns an (N, N) flow or adjacency matrix -- or a (B, N, N) batch of them
-- into a stack of GCN support matrices, for the four kernel types of the
reference ``Adj_Processor`` (GCN.py:49-138). Every function works on any
leading batch dims, so ``batch_supports`` is ``compute_supports`` on a
batched input rather than a vmap. Supports are computed once per dataset,
on the device that serves them.
"""

from __future__ import annotations

import numpy as np
import torch

from mpgcn_tpu_torch.device import resolve_device

KERNEL_TYPES = (
    "localpool",
    "chebyshev",
    "random_walk_diffusion",
    "dual_random_walk_diffusion",
)

# kernels whose D^-1/2 A D^-1/2 normalization turns zero-degree nodes into
# inf/NaN supports unless the degree clamp maps them to exact zeros
SYMNORM_KERNELS = ("localpool", "chebyshev")


def validate_graph(adj, kernel_type: str, name: str, policy: str = "error",
                   degree_clamp: bool = False):
    """Load-time guard for graph rows that poison the support kernels
    (numpy). Non-finite rows poison every kernel type; zero-degree rows
    poison the SYMNORM_KERNELS unless the degree clamp is on.

    policy: "error" raises with the offending node indices; "selfloop"
    returns a cleaned copy (non-finite entries zeroed, then A[i, i] = 1 on
    dead rows); "ignore" returns the graph unchanged."""
    if policy == "ignore":
        return adj
    adj = np.asarray(adj)
    row_sum = adj.sum(axis=-1)
    bad_rows = ~np.isfinite(row_sum)
    if kernel_type in SYMNORM_KERNELS and (not degree_clamp
                                           or policy == "selfloop"):
        bad_rows |= row_sum == 0
    bad = (np.flatnonzero(bad_rows) if adj.ndim == 2
           else np.flatnonzero(bad_rows.any(axis=0)))
    if bad.size == 0:
        return adj
    if policy == "selfloop":
        cleaned = np.nan_to_num(adj, nan=0.0, posinf=0.0, neginf=0.0)
        dead = cleaned.sum(axis=-1) == 0
        if adj.ndim == 2:
            idx = np.flatnonzero(dead)
            cleaned[idx, idx] = 1.0
        else:
            b_idx, n_idx = np.nonzero(dead)
            cleaned[b_idx, n_idx, n_idx] = 1.0
        print(f"WARNING: {name}: dead/non-finite node row(s) {bad.tolist()} "
              f"cleaned (non-finite entries zeroed, self-loop added) for "
              f"the {kernel_type} kernel")
        return cleaned
    raise ValueError(
        f"{name} has zero-degree or non-finite node row(s) {bad.tolist()}: "
        f"these produce NaN supports under the {kernel_type} kernel. Set "
        f"isolated_nodes='selfloop' to auto-clean, or 'ignore' to reproduce "
        f"the reference's NaN propagation (GCN.py:102-114).")


def support_k(kernel_type: str, cheby_order: int) -> int:
    """Supports per graph (reference: Model_Trainer.py:24-36)."""
    if kernel_type == "localpool":
        if cheby_order != 1:
            raise ValueError("localpool needs cheby_order == 1")
        return 1
    if kernel_type in ("chebyshev", "random_walk_diffusion"):
        return cheby_order + 1
    if kernel_type == "dual_random_walk_diffusion":
        return 2 * cheby_order + 1
    raise ValueError(f"invalid kernel_type {kernel_type!r}: expected one of "
                     f"{KERNEL_TYPES}")


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def random_walk_normalize(A: torch.Tensor) -> torch.Tensor:
    """Row-normalize: P = D^-1 A with 1/0 -> 0 (reference: GCN.py:102-108)."""
    d = A.sum(dim=-1)
    d_inv = torch.where(d == 0, torch.zeros_like(d),
                        1.0 / torch.where(d == 0, torch.ones_like(d), d))
    return d_inv[..., :, None] * A


def symmetric_normalize(A: torch.Tensor,
                        degree_clamp: bool = False) -> torch.Tensor:
    """D^-1/2 A D^-1/2 (reference: GCN.py:110-114). degree_clamp maps
    d = 0 to d^-1/2 = 0, leaving rows with d > 0 unchanged."""
    d = A.sum(dim=-1)
    if degree_clamp:
        safe = torch.where(d > 0, d, torch.ones_like(d))
        d_inv_sqrt = torch.where(d > 0, safe ** -0.5, torch.zeros_like(d))
    else:
        d_inv_sqrt = d ** -0.5
    return d_inv_sqrt[..., :, None] * A * d_inv_sqrt[..., None, :]


def estimate_lambda_max(L: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Largest-|eigenvalue| estimate by power iteration, per matrix of a
    (..., N, N) batch; returns (...) floored at 1e-6."""
    n = L.shape[-1]
    v = torch.full(L.shape[:-1], 1.0 / float(np.sqrt(n)), dtype=L.dtype,
                   device=L.device)
    for _ in range(iters):
        w = (L @ v[..., None])[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    Lv = (L @ v[..., None])[..., 0]
    est = (torch.abs((v * Lv).sum(-1))
           / torch.clamp((v * v).sum(-1), min=1e-12))
    return torch.clamp(est, min=1e-6)


def rescale_laplacian(L: torch.Tensor, lambda_max: float | None = 2.0,
                      iters: int = 16) -> torch.Tensor:
    """Rescale L to [-1, 1] for Chebyshev input (reference: GCN.py:116-126)."""
    if lambda_max is None:
        lmax = estimate_lambda_max(L, iters)[..., None, None]
    else:
        lmax = lambda_max
    return (2.0 / lmax) * L - _eye_like(L)


def chebyshev_polynomials(x: torch.Tensor, order: int) -> torch.Tensor:
    """T_0..T_order of matrix x (any leading batch dims), stacked on axis
    -3 (reference: GCN.py:128-138)."""
    T = [_eye_like(x).expand(x.shape)]
    if order >= 1:
        T.append(x)
    for k in range(2, order + 1):
        T.append(2.0 * (x @ T[k - 1]) - T[k - 2])
    return torch.stack(T, dim=-3)


def compute_supports(
    adj,
    kernel_type: str,
    cheby_order: int,
    lambda_max: float | None = 2.0,
    lambda_max_iters: int = 16,
    degree_clamp: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Support stack in float32 on ``device``: (N, N) -> (K, N, N), and
    (B, N, N) -> (B, K, N, N) for a batch of graphs (reference:
    GCN.py:64-99)."""
    A = torch.as_tensor(np.asarray(adj) if not torch.is_tensor(adj) else adj,
                        dtype=torch.float32, device=resolve_device(device))
    order = cheby_order
    if kernel_type == "localpool":
        return (_eye_like(A) + symmetric_normalize(A, degree_clamp)
                ).unsqueeze(-3)
    if kernel_type == "chebyshev":
        L = _eye_like(A) - symmetric_normalize(A, degree_clamp)
        return chebyshev_polynomials(
            rescale_laplacian(L, lambda_max, lambda_max_iters), order)
    if kernel_type == "random_walk_diffusion":
        P = random_walk_normalize(A)
        return chebyshev_polynomials(P.transpose(-1, -2), order)
    if kernel_type == "dual_random_walk_diffusion":
        Pf = random_walk_normalize(A)
        Pb = random_walk_normalize(A.transpose(-1, -2))
        fwd = chebyshev_polynomials(Pf.transpose(-1, -2), order)
        bwd = chebyshev_polynomials(Pb.transpose(-1, -2), order)
        return torch.cat([fwd, bwd[..., 1:, :, :]], dim=-3)
    raise ValueError(f"invalid kernel_type {kernel_type!r}: expected one of "
                     f"{KERNEL_TYPES}")


def batch_supports(flow, kernel_type: str, cheby_order: int,
                   lambda_max: float | None = 2.0,
                   lambda_max_iters: int = 16,
                   degree_clamp: bool = False,
                   device="cuda") -> torch.Tensor:
    """Batched support stacks: (B, N, N) -> (B, K, N, N)."""
    if np.ndim(flow) != 3:
        raise ValueError(f"batch_supports expects (B, N, N), got shape "
                         f"{tuple(np.shape(flow))}")
    return compute_supports(flow, kernel_type, cheby_order, lambda_max,
                            lambda_max_iters, degree_clamp, device)


def pack_supports(stack, fmt: str, payload: str = "f32", pad=None):
    """A dense (..., K, N, N) support stack as a sparse container: sparsify
    into ``fmt`` ('csr' or 'ell') and pack its values as ``payload``
    ('f32', 'bf16' or 'int8'). The data pipeline's bank build comes
    through here. Returns CPU tensors."""
    from mpgcn_tpu_torch.sparse.formats import (
        pack_payload,
        sparsify_support_stack,
    )

    container = sparsify_support_stack(stack, fmt, pad=pad)
    return pack_payload(container, payload)
