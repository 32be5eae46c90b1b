"""K-LSTM and K-LSTM-train: the fused LSTM layer (counterpart of
mpgcn_tpu/nn/pallas_lstm.py).

``lstm_layer_infer`` runs one LSTM layer with zero initial state over a
time-major gate pre-activation tensor. On a CUDA tensor it launches the
hand-written kernel of ``csrc/lstm_infer.cu`` (``lstm_infer_last_f32``
replaces ``_make_last_kernel``, ``lstm_infer_collect_f32`` replaces
``_lstm_infer_kernel``); on a CPU tensor it runs
``lstm_layer_infer_plain``, the same function in plain PyTorch. There is
no fallback: a CUDA tensor the kernel does not take raises. Every hidden
width H >= 1 is taken: where w_hh^T does not fit a block's shared memory
the forward entries launch their wide kernel (``csrc/lstm_wide.cuh``)
instead of the resident one, and the BPTT runs its products on the
split-TF32 engine of ``csrc/bdgcn_gemm.cuh`` (the gate recompute and
dW_hh^T each one product over every time step, only dh stepping through
time; see ``csrc/lstm_train.cu``).

The training path goes through ``LSTMLayerFn``: its forward
``lstm_layer_train`` stores hs and cs (``lstm_train_fwd_f32`` of
``csrc/lstm_train.cu`` replaces ``_lstm_fwd_kernel``), and its backward
``lstm_layer_bwd`` runs the reverse-time BPTT (``lstm_train_bwd_f32``
replaces ``_lstm_bwd_kernel``): one host call whose last (cooperative)
launch writes dW_hh^T partials and then, after a grid-wide barrier, sums
them in a fixed order (``dw_reduce_plain`` is that sum's plain version). The
JAX package sends small row counts to an XLA scan instead of its backward
kernel; this port has no such switch: a CUDA tensor always launches the
backward kernel.

The input projection ``x @ W_ih^T + b`` stays a torch matmul outside the
kernels, as the JAX package leaves it to XLA (pallas_lstm.py:564).
"""

from __future__ import annotations

import functools

import torch

from mpgcn_tpu_torch.native.build import CudaKernel, query_int

LSTM_INFER_LAST = CudaKernel("lstm_infer", "lstm_infer_last_f32",
                             n_ptrs=3, n_ints=3)
LSTM_INFER_COLLECT = CudaKernel("lstm_infer", "lstm_infer_collect_f32",
                                n_ptrs=3, n_ints=3)
LSTM_TRAIN_FWD = CudaKernel("lstm_train", "lstm_train_fwd_f32",
                            n_ptrs=4, n_ints=3)
LSTM_TRAIN_BWD = CudaKernel("lstm_train", "lstm_train_bwd_f32",
                            n_ptrs=10, n_ints=4)

#: resident BPTT blocks per SM: the blocks stride over the row tiles, so
#: the dW_hh^T partial buffer stays at about this many x SMs x H x 4H floats
BWD_BLOCKS_PER_SM = 2
#: at most this many bytes of dW_hh^T partials (P x H x 4H floats)
BWD_PARTIAL_BYTES = 1 << 30


def _gates(x_t, h, w_hh_T, H):
    gates = x_t + h @ w_hh_T
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


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
        i, f, g, o = _gates(x_proj[t], h, w_hh_T, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        if collect:
            hs.append(h)
    return torch.stack(hs) if collect else h


def lstm_layer_train_plain(x_proj: torch.Tensor, w_hh_T: torch.Tensor):
    """Plain PyTorch version of ``lstm_train_fwd_f32``: x_proj (T, R, 4H),
    w_hh_T (H, 4H) -> (hs, cs), each (T, R, H)."""
    T, R, four_h = x_proj.shape
    H = four_h // 4
    h = x_proj.new_zeros((R, H))
    c = x_proj.new_zeros((R, H))
    hs, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(x_proj[t], h, w_hh_T, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_layer_bwd_plain(x_proj, w_hh_T, hs, cs, dhs, dcs):
    """Plain PyTorch version of ``lstm_train_bwd_f32`` and its dW sum,
    step by step in reverse time as ``_cell_bwd`` computes it: the gates
    are recomputed from x_proj + h_{t-1} w_hh_T, dh and dc carried in f32.
    dhs, dcs (T, R, H) are the cotangents of hs and cs; None means zero.
    Returns (dx_proj (T, R, 4H), dw_hh_T (H, 4H))."""
    T, R, four_h = x_proj.shape
    H = four_h // 4
    zeros = x_proj.new_zeros((R, H))
    dh_next, dc_next = zeros, zeros
    dw = x_proj.new_zeros((H, four_h))
    dxp = []
    for t in reversed(range(T)):
        hp = hs[t - 1] if t > 0 else zeros
        cp = cs[t - 1] if t > 0 else zeros
        i, f, g, o = _gates(x_proj[t], hp, w_hh_T, H)
        tanh_c = torch.tanh(cs[t])
        dh = dh_next if dhs is None else dh_next + dhs[t]
        dc = dc_next if dcs is None else dc_next + dcs[t]
        d_o = dh * tanh_c
        dct = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dc_next = dct * f
        dgates = torch.cat([dct * g * i * (1.0 - i),
                            dct * cp * f * (1.0 - f),
                            dct * i * (1.0 - g * g),
                            d_o * o * (1.0 - o)], dim=-1)
        dh_next = dgates @ w_hh_T.t()
        dw = dw + hp.t() @ dgates
        dxp.append(dgates)
    return torch.stack(dxp[::-1]), dw


def dw_reduce_plain(part: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dW sum that ends both backward kernels
    (``lstm_train_bwd_f32`` and ``bdgcn_pair_bwd_f32``): the P partials
    (P, ...) summed in the kernels' fixed order, p = 0, 1, ..., P-1."""
    out = part[0].clone()
    for p in range(1, part.shape[0]):
        out += part[p]
    return out


def device_index(device) -> int:
    """The index of a CUDA device (the current one when it names none)."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _check_device(x_proj: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x_proj.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x_proj.device}")
    return x_proj.device.type == "cuda"


def _check_cuda_args(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                     name: str = "K-LSTM") -> None:
    if x_proj.dtype != torch.float32 or w_hh_T.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 only, got x_proj "
                        f"{x_proj.dtype} and w_hh_T {w_hh_T.dtype}")
    if x_proj.ndim != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, R, 4H), got "
                         f"{tuple(x_proj.shape)}")
    H = x_proj.shape[-1] // 4
    if tuple(w_hh_T.shape) != (H, 4 * H):
        raise ValueError(f"w_hh_T must be ({H}, {4 * H}), got "
                         f"{tuple(w_hh_T.shape)}")
    if w_hh_T.device != x_proj.device:
        raise ValueError("x_proj and w_hh_T lie on different devices")
    if x_proj.shape[0] < 1 or x_proj.shape[1] < 1:
        raise ValueError(f"empty x_proj {tuple(x_proj.shape)}")


def lstm_layer_infer(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                     collect: bool) -> torch.Tensor:
    """One inference LSTM layer: x_proj (T, R, 4H) -> (R, H) or (T, R, H).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _check_device(x_proj, "K-LSTM"):
        return lstm_layer_infer_plain(x_proj, w_hh_T, collect)
    _check_cuda_args(x_proj, w_hh_T)
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or w_hh_T.requires_grad):
        raise RuntimeError("K-LSTM is inference-only (the training path is "
                           "LSTMLayerFn); call it under torch.no_grad()")
    T, R, four_h = x_proj.shape
    H = four_h // 4
    x_proj = x_proj.contiguous()
    w_hh_T = w_hh_T.contiguous()
    shape = (T, R, H) if collect else (R, H)
    out = torch.empty(shape, dtype=torch.float32, device=x_proj.device)
    kernel = LSTM_INFER_COLLECT if collect else LSTM_INFER_LAST
    kernel.launch((x_proj, w_hh_T, out), (T, R, H))
    return out


def lstm_layer_train(x_proj: torch.Tensor, w_hh_T: torch.Tensor):
    """Training forward of one layer: x_proj (T, R, 4H) -> (hs, cs), each
    (T, R, H). CPU tensors take the plain version; CUDA tensors launch
    ``lstm_train_fwd_f32``."""
    if not _check_device(x_proj, "K-LSTM-train"):
        return lstm_layer_train_plain(x_proj, w_hh_T)
    _check_cuda_args(x_proj, w_hh_T, "K-LSTM-train")
    T, R, four_h = x_proj.shape
    H = four_h // 4
    x_proj = x_proj.contiguous()
    w_hh_T = w_hh_T.contiguous()
    hs = torch.empty((T, R, H), dtype=torch.float32, device=x_proj.device)
    cs = torch.empty_like(hs)
    LSTM_TRAIN_FWD.launch((x_proj, w_hh_T, hs, cs), (T, R, H))
    return hs, cs


@functools.lru_cache(maxsize=None)
def _max_bwd_blocks(index: int, H: int) -> int:
    """The largest P of the BPTT on card ``index`` at width H."""
    return query_int("lstm_train", "lstm_train_bwd_max_blocks", (H,),
                     torch.device("cuda", index))


def bwd_smem_bytes(index: int, H: int) -> int:
    """Dynamic shared memory a block of the resident BPTT takes at H."""
    return query_int("lstm_train", "lstm_train_bwd_smem", (H,),
                     torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def bwd_on_engine(index: int, H: int) -> bool:
    """True where the BPTT on card ``index`` runs its products on the
    split-TF32 engine at width H (the resident kernel's shared memory does
    not fit a block: H > 81 on the H100)."""
    return bool(query_int("lstm_train", "lstm_train_bwd_engine", (H,),
                          torch.device("cuda", index)))


def bwd_blocks(R: int, H: int, device) -> int:
    """P of the BPTT, never more than ``BWD_PARTIAL_BYTES`` of dW partials
    hold. The resident kernel: its blocks, a few per SM, never more than
    its row tiles (4 rows x max(1, 256 // H) thread rows) nor than the card
    holds at once (the launch is cooperative). The engine path: the dW
    product's depth chunks, which fill its cooperative grid about twice."""
    index = device_index(device)
    by_bytes = BWD_PARTIAL_BYTES // (16 * H * H)
    if bwd_on_engine(index, H):
        return max(1, min(by_bytes, _max_bwd_blocks(index, H)))
    tiles = -(-R // (max(1, 256 // H) * 4))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(1, min(tiles, BWD_BLOCKS_PER_SM * sms, by_bytes,
                      _max_bwd_blocks(index, H)))


def bwd_scratch(R: int, H: int, device):
    """The BPTT's scratch: the dh and dc carries (2, R, H) on the engine
    path, None on the resident one."""
    if not bwd_on_engine(device_index(device), H):
        return None
    return torch.empty((2, R, H), dtype=torch.float32, device=device)


def lstm_layer_bwd(x_proj, w_hh_T, hs, cs, dhs, dcs):
    """Backward of one layer: the cotangents dhs, dcs of (hs, cs) (None
    means zero) -> (dx_proj (T, R, 4H), dw_hh_T (H, 4H)). CPU tensors take
    the plain version; CUDA tensors call ``lstm_train_bwd_f32``, BPTT and
    dW sum in one host call."""
    return lstm_layer_bwd_partials(x_proj, w_hh_T, hs, cs, dhs, dcs)[:2]


def lstm_layer_bwd_partials(x_proj, w_hh_T, hs, cs, dhs, dcs):
    """``lstm_layer_bwd`` with the dW_hh^T partials (P, H, 4H) that its dW
    is the fixed-order sum of (``dw_reduce_plain(part)`` to the
    last bit). The plain version computes dW in one piece: on the CPU the
    partials are dW[None]."""
    if not _check_device(x_proj, "K-LSTM-train"):
        dxp, dw = lstm_layer_bwd_plain(x_proj, w_hh_T, hs, cs, dhs, dcs)
        return dxp, dw, dw[None]
    _check_cuda_args(x_proj, w_hh_T, "K-LSTM-train")
    T, R, four_h = x_proj.shape
    H = four_h // 4
    for name, t in (("hs", hs), ("cs", cs), ("dhs", dhs), ("dcs", dcs)):
        if t is None and name in ("dhs", "dcs"):
            continue
        if t.dtype != torch.float32 or t.device != x_proj.device:
            raise TypeError(f"K-LSTM-train backward takes float32 {name} on "
                            f"{x_proj.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (T, R, H):
            raise ValueError(f"{name} must be ({T}, {R}, {H}), got "
                             f"{tuple(t.shape)}")
    args = [None if t is None else t.contiguous()
            for t in (x_proj, w_hh_T, hs, cs, dhs, dcs)]
    P = bwd_blocks(R, H, x_proj.device)
    dxp = torch.empty_like(args[0])
    part = torch.empty((P, H, four_h), dtype=torch.float32,
                       device=x_proj.device)
    dw = torch.empty((H, four_h), dtype=torch.float32, device=x_proj.device)
    scratch = bwd_scratch(R, H, x_proj.device)
    LSTM_TRAIN_BWD.launch((*args, dxp, part, dw, scratch), (T, R, H, P))
    return dxp, dw, part


class LSTMLayerFn(torch.autograd.Function):
    """(x_proj, w_hh_T) -> (hs, cs) with the hand-written backward (the
    counterpart of ``_fused_layer``'s custom VJP). The residuals are x_proj,
    w_hh_T, hs and cs; a cotangent autograd leaves undefined (cs on the
    model path) reaches the kernel as a null pointer."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_T):
        hs, cs = lstm_layer_train(x_proj, w_hh_T)
        ctx.save_for_backward(x_proj, w_hh_T, hs, cs)
        ctx.set_materialize_grads(False)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        if dhs is None and dcs is None:
            return None, None
        x_proj, w_hh_T, hs, cs = ctx.saved_tensors
        return lstm_layer_bwd(x_proj, w_hh_T, hs, cs, dhs, dcs)


def lstm_layer_recorded(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                        collect: bool) -> torch.Tensor:
    """One training layer under autograd through ``LSTMLayerFn``, with the
    signature of ``lstm_layer_infer``: every h_t (T, R, H) when
    ``collect``, else h_T (R, H)."""
    hs, _ = LSTMLayerFn.apply(x_proj, w_hh_T)
    return hs if collect else hs[-1]


def lstm_last_step_fused(layers, x: torch.Tensor,
                         layer_fn=lstm_layer_infer) -> torch.Tensor:
    """LSTM stack over batch-first sequences, last hidden state only:
    x (R, T, F) -> (R, H) (counterpart of ``lstm_last_step_fused``).
    ``layers`` is a sequence of objects with ``w_ih``, ``w_hh``, ``b_ih``,
    ``b_hh``. ``layer_fn`` runs one layer (``lstm_layer_infer``,
    ``lstm_layer_recorded`` or ``lstm_layer_infer_plain``): every layer but
    the last streams h_t (collect); the last gives h_T only."""
    # (T, R, F) view, so every projection comes out time-major (T, R, 4H)
    seq_t = x.transpose(0, 1)
    for layer in layers[:-1]:
        x_proj = torch.matmul(seq_t, layer.w_ih.t()) + (layer.b_ih
                                                        + layer.b_hh)
        seq_t = layer_fn(x_proj, layer.w_hh.t(), collect=True)
    last = layers[-1]
    x_proj = torch.matmul(seq_t, last.w_ih.t()) + (last.b_ih + last.b_hh)
    return layer_fn(x_proj, last.w_hh.t(), collect=False)
