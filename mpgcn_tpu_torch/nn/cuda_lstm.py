"""K-LSTM and K-LSTM-train: the fused LSTM layer (counterpart of
mpgcn_tpu/nn/pallas_lstm.py).

``lstm_layer_infer`` runs one LSTM layer with zero initial state over a
time-major gate pre-activation tensor. On a CUDA tensor it launches the
hand-written kernel of ``csrc/lstm_infer.cu`` (``lstm_infer_last_f32``
replaces ``_make_last_kernel``, ``lstm_infer_collect_f32`` replaces
``_lstm_infer_kernel``); on a CPU tensor it runs
``lstm_layer_infer_plain``, the same function in plain PyTorch. There is
no fallback: a CUDA tensor the kernel does not take raises. Every hidden
width H >= 1 is taken: where w_hh does not fit a block's shared memory
the forward entries launch their wide kernel (``csrc/lstm_wide.cuh``:
split-TF32 tensor-core products over row tiles, h and c carried in device
memory, so the inference entries take a scratch, ``fwd_scratch``)
instead of the resident one (``csrc/lstm_fwd.cuh``), and the BPTT runs
its products on the split-TF32 engine of ``csrc/bdgcn_gemm.cuh`` (the
gate recompute and dW_hh^T each one product over every time step, only dh
stepping through time; see ``csrc/lstm_train.cu``).

``lstm_layer_infer_fused`` is the same layer from its input x (R, T, F),
F <= ``FUSED_MAX_F``: the same two entries form x_t @ W_ih^T + b in
registers (at F = 1 rounded exactly as the torch product and add round
it), so no x_proj goes through device memory; its plain version is
``lstm_layer_infer_fused_plain``.

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

Every entry also takes bf16 storage, as the JAX kernels take their bf16
dtype (``-dtype bfloat16``): x_proj (or x, w_ih, b), w_hh_T, the outputs,
hs, cs, their cotangents and dx_proj in bf16; the carries, gates and sums
in f32; h rounded to bf16 before each recurrent product (``_cell_step``);
dW_hh^T summed in f32 and then cast, as pallas_lstm.py:500, 543 casts it.
CUDA tensors launch the ``*_bf16`` instantiations of the same kernels
(``csrc/bf16.cuh``). The plain versions compute in f32 with the same
rounding points (``acc=torch.float64`` for a reference in float64).

The JAX package leaves the input projection ``x @ W_ih^T + b`` to XLA
(pallas_lstm.py:564). Here ``lstm_last_step_fused`` sends a layer of at
most ``FUSED_MAX_F`` input features on the inference kernel arm to the
fused form (the model's first layer, input_dim 1); every other layer, and
the training path (``LSTMLayerFn`` saves x_proj for the BPTT), take a
torch matmul outside the kernels.
"""

from __future__ import annotations

import functools

import torch

from mpgcn_tpu_torch.native.build import CudaKernel, query_int

LSTM_INFER_LAST = CudaKernel("lstm_infer", "lstm_infer_last_f32",
                             n_ptrs=7, n_ints=4)
LSTM_INFER_COLLECT = CudaKernel("lstm_infer", "lstm_infer_collect_f32",
                                n_ptrs=7, n_ints=4)
LSTM_TRAIN_FWD = CudaKernel("lstm_train", "lstm_train_fwd_f32",
                            n_ptrs=4, n_ints=3)
LSTM_TRAIN_BWD = CudaKernel("lstm_train", "lstm_train_bwd_f32",
                            n_ptrs=10, n_ints=4)
LSTM_INFER_LAST_BF16 = CudaKernel("lstm_infer", "lstm_infer_last_bf16",
                                  n_ptrs=7, n_ints=4)
LSTM_INFER_COLLECT_BF16 = CudaKernel("lstm_infer", "lstm_infer_collect_bf16",
                                     n_ptrs=7, n_ints=4)
LSTM_TRAIN_FWD_BF16 = CudaKernel("lstm_train", "lstm_train_fwd_bf16",
                                 n_ptrs=5, n_ints=3)
LSTM_TRAIN_BWD_BF16 = CudaKernel("lstm_train", "lstm_train_bwd_bf16",
                                 n_ptrs=10, n_ints=4)
#: the kernels of each storage type
KERNELS = {
    torch.float32: {"last": LSTM_INFER_LAST, "collect": LSTM_INFER_COLLECT,
                    "fwd": LSTM_TRAIN_FWD, "bwd": LSTM_TRAIN_BWD},
    torch.bfloat16: {"last": LSTM_INFER_LAST_BF16,
                     "collect": LSTM_INFER_COLLECT_BF16,
                     "fwd": LSTM_TRAIN_FWD_BF16, "bwd": LSTM_TRAIN_BWD_BF16},
}

#: the most input features the inference entries' fused form takes
#: (csrc/lstm_fwd.cuh kFusedMaxF)
FUSED_MAX_F = 4
#: resident BPTT blocks per SM: the blocks stride over the row tiles, so
#: the dW_hh^T partial buffer stays at about this many x SMs x H x 4H floats
BWD_BLOCKS_PER_SM = 2
#: at most this many bytes of dW_hh^T partials (P x H x 4H floats)
BWD_PARTIAL_BYTES = 1 << 30


def _gates(x_t, h, w_hh_T, H):
    gates = x_t + h @ w_hh_T
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


def plain_dtype(storage: torch.dtype, acc=None) -> torch.dtype:
    """The dtype a plain version computes in: ``acc`` when given, f32 for
    bf16 storage (the kernels' carries, gates and sums), else the
    storage's own."""
    if acc is not None:
        return acc
    return torch.float32 if storage == torch.bfloat16 else storage


def store_round(v: torch.Tensor, storage: torch.dtype) -> torch.Tensor:
    """v as a store of ``storage`` keeps it, in v's dtype: rounded to bf16
    (to nearest even) for bf16 storage, v itself otherwise."""
    if storage != torch.bfloat16:
        return v
    return v.to(torch.bfloat16).to(v.dtype)


def lstm_layer_infer_plain(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                           collect: bool, acc=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x_proj (T, R, 4H), w_hh_T
    (H, 4H) -> h_T (R, H), or every h_t (T, R, H) when ``collect``, in
    x_proj's dtype; computed in ``plain_dtype``, h rounded to the storage
    type before each recurrent product."""
    S = x_proj.dtype
    A = plain_dtype(S, acc)
    x_proj, w_hh_T = x_proj.to(A), w_hh_T.to(A)
    T, R, four_h = x_proj.shape
    H = four_h // 4
    h = x_proj.new_zeros((R, H))
    c = x_proj.new_zeros((R, H))
    hs = []
    for t in range(T):
        i, f, g, o = _gates(x_proj[t], h, w_hh_T, H)
        c = f * c + i * g
        h = store_round(o * torch.tanh(c), S)
        if collect:
            hs.append(h)
    return (torch.stack(hs) if collect else h).to(S)


def lstm_layer_infer_fused_plain(x: torch.Tensor, w_ih: torch.Tensor,
                                 b: torch.Tensor, w_hh_T: torch.Tensor,
                                 collect: bool, acc=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's fused form: x (R, T, F), w_ih
    (4H, F), b = b_ih + b_hh (4H,), w_hh_T (H, 4H) -> h_T (R, H), or every
    h_t (T, R, H) when ``collect``. The projection is the torch product and
    add that ``lstm_last_step_fused`` takes on the other arms; in bf16 the
    product and the sum are each rounded to bf16, as x_proj is stored."""
    S = x.dtype
    if S == torch.float32 and acc is None:
        x_proj = torch.matmul(x.transpose(0, 1), w_ih.t()) + b
    else:
        A = plain_dtype(S, acc)
        p = store_round(torch.matmul(x.transpose(0, 1).to(A),
                                     w_ih.t().to(A)), S)
        x_proj = store_round(p + b.to(A), S).to(S)
    return lstm_layer_infer_plain(x_proj, w_hh_T, collect, acc)


def lstm_layer_train_plain(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                           acc=None):
    """Plain PyTorch version of ``lstm_train_fwd_f32`` (and ``_bf16``):
    x_proj (T, R, 4H), w_hh_T (H, 4H) -> (hs, cs), each (T, R, H) in
    x_proj's dtype; c carried unrounded, h rounded to the storage type."""
    S = x_proj.dtype
    A = plain_dtype(S, acc)
    x_proj, w_hh_T = x_proj.to(A), w_hh_T.to(A)
    T, R, four_h = x_proj.shape
    H = four_h // 4
    h = x_proj.new_zeros((R, H))
    c = x_proj.new_zeros((R, H))
    hs, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(x_proj[t], h, w_hh_T, H)
        c = f * c + i * g
        h = store_round(o * torch.tanh(c), S)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs).to(S), torch.stack(cs).to(S)


def lstm_layer_bwd_plain(x_proj, w_hh_T, hs, cs, dhs, dcs, acc=None):
    """Plain PyTorch version of ``lstm_train_bwd_f32`` (and ``_bf16``)
    and its dW sum, step by step in reverse time as ``_cell_bwd`` computes
    it: the gates are recomputed from x_proj + h_{t-1} w_hh_T, dh and dc
    carried in f32. dhs, dcs (T, R, H) are the cotangents of hs and cs;
    None means zero. Returns (dx_proj (T, R, 4H) in x_proj's dtype,
    dw_hh_T (H, 4H) in ``plain_dtype``: summed unrounded)."""
    S = x_proj.dtype
    A = plain_dtype(S, acc)
    x_proj, w_hh_T, hs, cs = (t.to(A) for t in (x_proj, w_hh_T, hs, cs))
    dhs, dcs = (None if t is None else t.to(A) for t in (dhs, dcs))
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
    return torch.stack(dxp[::-1]).to(S), dw


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


def _check_dtype(name: str, **tensors) -> torch.dtype:
    """The one storage dtype of ``tensors``, float32 or bfloat16; raises
    on any other or on a mix."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= set(KERNELS):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype, got "
                        + ", ".join(f"{k} {t.dtype}"
                                    for k, t in tensors.items()))
    return dtypes.pop()


def _check_w_hh(w_hh_T: torch.Tensor, H: int, device, what: str) -> None:
    if tuple(w_hh_T.shape) != (H, 4 * H):
        raise ValueError(f"w_hh_T must be ({H}, {4 * H}), got "
                         f"{tuple(w_hh_T.shape)}")
    if w_hh_T.device != device:
        raise ValueError(f"{what} and w_hh_T lie on different devices")


def _check_cuda_args(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                     name: str = "K-LSTM") -> None:
    _check_dtype(name, x_proj=x_proj, w_hh_T=w_hh_T)
    if x_proj.ndim != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, R, 4H), got "
                         f"{tuple(x_proj.shape)}")
    _check_w_hh(w_hh_T, x_proj.shape[-1] // 4, x_proj.device, "x_proj")
    if x_proj.shape[0] < 1 or x_proj.shape[1] < 1:
        raise ValueError(f"empty x_proj {tuple(x_proj.shape)}")


def _check_fused_args(x, w_ih, b, w_hh_T) -> None:
    _check_dtype("K-LSTM", x=x, w_ih=w_ih, b=b, w_hh_T=w_hh_T)
    if x.ndim != 3 or not 1 <= x.shape[-1] <= FUSED_MAX_F:
        raise ValueError(f"x must be (R, T, F) with 1 <= F <= "
                         f"{FUSED_MAX_F}, got {tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")
    H = w_hh_T.shape[0]
    _check_w_hh(w_hh_T, H, x.device, "x")
    if tuple(w_ih.shape) != (4 * H, x.shape[-1]):
        raise ValueError(f"w_ih must be ({4 * H}, {x.shape[-1]}), got "
                         f"{tuple(w_ih.shape)}")
    if tuple(b.shape) != (4 * H,):
        raise ValueError(f"b must be ({4 * H},), got {tuple(b.shape)}")
    if w_ih.device != x.device or b.device != x.device:
        raise ValueError("x, w_ih and b lie on different devices")


def _no_grad_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("K-LSTM is inference-only (the training path is "
                           "LSTMLayerFn); call it under torch.no_grad()")


@functools.lru_cache(maxsize=None)
def fwd_on_wide(index: int, H: int) -> bool:
    """True where the forward entries on card ``index`` take their wide
    kernel at width H (the resident kernel's shared memory does not fit a
    block: H > 116 on the H100)."""
    return bool(query_int("lstm_infer", "lstm_fwd_wide", (H,),
                          torch.device("cuda", index)))


def fwd_scratch(R: int, H: int, device, collect: bool):
    """The inference entries' scratch: on the wide kernel, the f32 c carry
    and, for h_T only, a second h buffer, (1 if collect else 2, R, H);
    None on the resident kernel. The bf16 training forward takes the
    collect form (its c carry)."""
    if not fwd_on_wide(device_index(device), H):
        return None
    return torch.empty((1 if collect else 2, R, H), dtype=torch.float32,
                       device=device)


def _infer_launch(xp, x, w_ih, b, w_hh_T, collect, T, R, H, F):
    """Launch an inference entry: on x_proj (x, w_ih, b None, F = 0) or
    fused from x, w_ih, b (xp None)."""
    shape = (T, R, H) if collect else (R, H)
    out = torch.empty(shape, dtype=w_hh_T.dtype, device=w_hh_T.device)
    kernel = KERNELS[w_hh_T.dtype]["collect" if collect else "last"]
    scratch = fwd_scratch(R, H, w_hh_T.device, collect)
    kernel.launch((xp, w_hh_T, out, x, w_ih, b, scratch), (T, R, H, F))
    return out


def lstm_layer_infer(x_proj: torch.Tensor, w_hh_T: torch.Tensor,
                     collect: bool) -> torch.Tensor:
    """One inference LSTM layer: x_proj (T, R, 4H) -> (R, H) or (T, R, H).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _check_device(x_proj, "K-LSTM"):
        return lstm_layer_infer_plain(x_proj, w_hh_T, collect)
    _check_cuda_args(x_proj, w_hh_T)
    _no_grad_only(x_proj, w_hh_T)
    T, R, four_h = x_proj.shape
    return _infer_launch(x_proj.contiguous(), None, None, None,
                         w_hh_T.contiguous(), collect, T, R, four_h // 4, 0)


def lstm_layer_infer_fused(x: torch.Tensor, w_ih: torch.Tensor,
                           b: torch.Tensor, w_hh_T: torch.Tensor,
                           collect: bool) -> torch.Tensor:
    """One inference LSTM layer from its input: x (R, T, F), w_ih (4H, F),
    b = b_ih + b_hh (4H,), w_hh_T (H, 4H) -> (R, H) or (T, R, H), for
    1 <= F <= ``FUSED_MAX_F``. CPU tensors take the plain version; CUDA
    tensors launch the kernel's fused form."""
    if not _check_device(x, "K-LSTM"):
        return lstm_layer_infer_fused_plain(x, w_ih, b, w_hh_T, collect)
    _check_fused_args(x, w_ih, b, w_hh_T)
    _no_grad_only(x, w_ih, b, w_hh_T)
    R, T, F = x.shape
    return _infer_launch(None, x.contiguous(), w_ih.contiguous(),
                         b.contiguous(), w_hh_T.contiguous(), collect, T, R,
                         w_hh_T.shape[0], F)


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
    hs = torch.empty((T, R, H), dtype=x_proj.dtype, device=x_proj.device)
    cs = torch.empty_like(hs)
    if x_proj.dtype == torch.float32:
        LSTM_TRAIN_FWD.launch((x_proj, w_hh_T, hs, cs), (T, R, H))
    else:  # bf16: the wide kernel carries c in f32 scratch
        LSTM_TRAIN_FWD_BF16.launch(
            (x_proj, w_hh_T, hs, cs,
             fwd_scratch(R, H, x_proj.device, collect=True)), (T, R, H))
    return hs, cs


@functools.lru_cache(maxsize=None)
def _max_bwd_blocks(index: int, H: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """The largest P of the BPTT of storage ``dtype`` on card ``index`` at
    width H (the bf16 resident kernel is an instantiation of its own)."""
    symbol = ("lstm_train_bwd_max_blocks" if dtype == torch.float32
              else "lstm_train_bwd_max_blocks_bf16")
    return query_int("lstm_train", symbol, (H,), torch.device("cuda", index))


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


def bwd_blocks(R: int, H: int, device,
               dtype: torch.dtype = torch.float32) -> int:
    """P of the BPTT, never more than ``BWD_PARTIAL_BYTES`` of dW partials
    hold. The resident kernel: its blocks, a few per SM, never more than
    its row tiles (4 rows x max(1, 256 // H) thread rows) nor than the card
    holds at once (the launch is cooperative). The engine path: the dW
    product's depth chunks, which fill its cooperative grid about twice."""
    index = device_index(device)
    by_bytes = BWD_PARTIAL_BYTES // (16 * H * H)
    if bwd_on_engine(index, H):
        return max(1, min(by_bytes, _max_bwd_blocks(index, H, dtype)))
    tiles = -(-R // (max(1, 256 // H) * 4))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(1, min(tiles, BWD_BLOCKS_PER_SM * sms, by_bytes,
                      _max_bwd_blocks(index, H, dtype)))


def bwd_scratch(R: int, H: int, device, T: int = 1,
                dtype: torch.dtype = torch.float32):
    """The BPTT's f32 scratch on the engine path, None on the resident
    one: the dh and dc carries (2, R, H); in bf16 also the f32 dgates, hs
    and w_hh_T that its products read (``lstm_train_bwd_bf16_scratch_k``
    x 1024 floats)."""
    if not bwd_on_engine(device_index(device), H):
        return None
    if dtype == torch.float32:
        return torch.empty((2, R, H), dtype=torch.float32, device=device)
    k = query_int("lstm_train", "lstm_train_bwd_bf16_scratch_k", (T, R, H),
                  device)
    return torch.empty(k * 1024, dtype=torch.float32, device=device)


def lstm_layer_bwd(x_proj, w_hh_T, hs, cs, dhs, dcs):
    """Backward of one layer: the cotangents dhs, dcs of (hs, cs) (None
    means zero) -> (dx_proj (T, R, 4H), dw_hh_T (H, 4H)), both in x_proj's
    dtype (dW summed in f32, then cast). CPU tensors take the plain
    version; CUDA tensors call ``lstm_train_bwd_f32`` (or ``_bf16``), BPTT
    and dW sum in one host call."""
    dxp, dw, _ = lstm_layer_bwd_partials(x_proj, w_hh_T, hs, cs, dhs, dcs)
    return dxp, dw.to(w_hh_T.dtype)


def lstm_layer_bwd_partials(x_proj, w_hh_T, hs, cs, dhs, dcs):
    """``lstm_layer_bwd`` with the dW_hh^T partials (P, H, 4H) that its dW
    is the fixed-order sum of (``dw_reduce_plain(part)`` to the
    last bit); dW and the partials f32 (or float64 in a float64 plain
    run), before any cast. The plain version computes dW in one piece: on
    the CPU the partials are dW[None]."""
    if not _check_device(x_proj, "K-LSTM-train"):
        dxp, dw = lstm_layer_bwd_plain(x_proj, w_hh_T, hs, cs, dhs, dcs)
        return dxp, dw, dw[None]
    _check_cuda_args(x_proj, w_hh_T, "K-LSTM-train")
    T, R, four_h = x_proj.shape
    H = four_h // 4
    S = x_proj.dtype
    for name, t in (("hs", hs), ("cs", cs), ("dhs", dhs), ("dcs", dcs)):
        if t is None and name in ("dhs", "dcs"):
            continue
        if t.dtype != S or t.device != x_proj.device:
            raise TypeError(f"K-LSTM-train backward takes {S} {name} on "
                            f"{x_proj.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (T, R, H):
            raise ValueError(f"{name} must be ({T}, {R}, {H}), got "
                             f"{tuple(t.shape)}")
    args = [None if t is None else t.contiguous()
            for t in (x_proj, w_hh_T, hs, cs, dhs, dcs)]
    P = bwd_blocks(R, H, x_proj.device, S)
    dxp = torch.empty_like(args[0])
    part = torch.empty((P, H, four_h), dtype=torch.float32,
                       device=x_proj.device)
    dw = torch.empty((H, four_h), dtype=torch.float32, device=x_proj.device)
    scratch = bwd_scratch(R, H, x_proj.device, T, S)
    KERNELS[S]["bwd"].launch((*args, dxp, part, dw, scratch), (T, R, H, P))
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
    the last streams h_t (collect); the last gives h_T only. On the
    inference kernel arm (``lstm_layer_infer``) a layer of at most
    ``FUSED_MAX_F`` input features runs from its input through
    ``lstm_layer_infer_fused`` instead: the same kernel forms x_proj in
    registers."""
    # (T, R, F) view, so every projection comes out time-major (T, R, 4H)
    seq_t = x.transpose(0, 1)
    for i, layer in enumerate(layers):
        collect = i < len(layers) - 1
        b = layer.b_ih + layer.b_hh
        if (layer_fn is lstm_layer_infer
                and layer.w_ih.shape[1] <= FUSED_MAX_F):
            seq_t = lstm_layer_infer_fused(seq_t.transpose(0, 1), layer.w_ih,
                                           b, layer.w_hh.t(), collect)
        else:
            x_proj = torch.matmul(seq_t, layer.w_ih.t()) + b
            seq_t = layer_fn(x_proj, layer.w_hh.t(), collect=collect)
    return seq_t
