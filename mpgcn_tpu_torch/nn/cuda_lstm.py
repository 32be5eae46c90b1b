"""K-LSTM: the fused inference LSTM layer (counterpart of the inference
half of mpgcn_tpu/nn/pallas_lstm.py).

``lstm_layer_infer`` runs one LSTM layer with zero initial state over a
time-major gate pre-activation tensor. On a CUDA tensor it launches the
hand-written kernel of ``csrc/lstm_infer.cu`` (``lstm_infer_last_f32``
replaces ``_make_last_kernel``, ``lstm_infer_collect_f32`` replaces
``_lstm_infer_kernel``); on a CPU tensor it runs
``lstm_layer_infer_plain``, the same function in plain PyTorch. There is
no fallback: a CUDA tensor the kernel does not take raises.

The input projection ``x @ W_ih^T + b`` stays a torch matmul outside the
kernel, as the JAX package leaves it to XLA (pallas_lstm.py:564).
"""

from __future__ import annotations

import torch

from mpgcn_tpu_torch.native.build import CudaKernel

#: hidden widths the kernel takes (w_hh^T must fit shared memory)
MAX_HIDDEN = 64

LSTM_INFER_LAST = CudaKernel("lstm_infer", "lstm_infer_last_f32",
                             n_ptrs=3, n_ints=3)
LSTM_INFER_COLLECT = CudaKernel("lstm_infer", "lstm_infer_collect_f32",
                                n_ptrs=3, n_ints=3)


def lstm_layer_infer_plain(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                           collect: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x_proj (T, R, 4H), w_hh_T
    (H, 4H) -> h_T (R, H), or every h_t (T, R, H) when ``collect``."""
    T, R, four_h = x_proj.shape
    H = four_h // 4
    h = x_proj.new_zeros((R, H))
    c = x_proj.new_zeros((R, H))
    hs = []
    for t in range(T):
        gates = x_proj[t] + h @ w_hh_T
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        if collect:
            hs.append(h)
    return torch.stack(hs) if collect else h


def _check_cuda_args(x_proj: torch.Tensor, w_hh_T: torch.Tensor) -> None:
    if x_proj.dtype != torch.float32 or w_hh_T.dtype != torch.float32:
        raise TypeError(f"K-LSTM takes float32 only, got x_proj "
                        f"{x_proj.dtype} and w_hh_T {w_hh_T.dtype}")
    if x_proj.ndim != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, R, 4H), got "
                         f"{tuple(x_proj.shape)}")
    H = x_proj.shape[-1] // 4
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"K-LSTM takes hidden widths 1..{MAX_HIDDEN}, "
                         f"got H={H}")
    if tuple(w_hh_T.shape) != (H, 4 * H):
        raise ValueError(f"w_hh_T must be ({H}, {4 * H}), got "
                         f"{tuple(w_hh_T.shape)}")
    if w_hh_T.device != x_proj.device:
        raise ValueError("x_proj and w_hh_T lie on different devices")
    if x_proj.shape[0] < 1 or x_proj.shape[1] < 1:
        raise ValueError(f"empty x_proj {tuple(x_proj.shape)}")
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or w_hh_T.requires_grad):
        raise RuntimeError("K-LSTM is inference-only (no backward kernel "
                           "yet); call it under torch.no_grad()")


def lstm_layer_infer(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                     collect: bool) -> torch.Tensor:
    """One inference LSTM layer: x_proj (T, R, 4H) -> (R, H) or (T, R, H).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x_proj.device.type == "cpu":
        return lstm_layer_infer_plain(x_proj, w_hh_T, collect)
    if x_proj.device.type != "cuda":
        raise ValueError(f"K-LSTM runs on cuda or cpu tensors, got "
                         f"{x_proj.device}")
    _check_cuda_args(x_proj, w_hh_T)
    T, R, four_h = x_proj.shape
    H = four_h // 4
    x_proj = x_proj.contiguous()
    w_hh_T = w_hh_T.contiguous()
    shape = (T, R, H) if collect else (R, H)
    out = torch.empty(shape, dtype=torch.float32, device=x_proj.device)
    kernel = LSTM_INFER_COLLECT if collect else LSTM_INFER_LAST
    kernel.launch((x_proj, w_hh_T, out), (T, R, H))
    return out


def lstm_last_step_fused(layers, x: torch.Tensor,
                         layer_fn=lstm_layer_infer) -> torch.Tensor:
    """Inference LSTM stack over batch-first sequences, last hidden state
    only: x (R, T, F) -> (R, H) (counterpart of
    ``lstm_last_step_fused(..., inference=True)``). Every layer but the
    last streams h_t (collect); the last writes h_T only. ``layers`` is a
    sequence of objects with ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``;
    ``layer_fn`` runs one layer (the kernel wrapper, or
    ``lstm_layer_infer_plain`` for the plain arm)."""
    # (T, R, F) view, so every projection comes out time-major (T, R, 4H)
    seq_t = x.transpose(0, 1)
    h = None
    for idx, layer in enumerate(layers):
        last = idx == len(layers) - 1
        x_proj = torch.matmul(seq_t, layer.w_ih.t()) + (layer.b_ih
                                                        + layer.b_hh)
        out = layer_fn(x_proj, layer.w_hh.t(), collect=not last)
        if last:
            h = out
        else:
            seq_t = out
    return h
