"""Weight-only int8 quantization (counterpart of mpgcn_tpu/quant/int8.py).

A ``QuantizedTensor`` is int8 codes and f32 per-channel scales, singleton
on every axis but the channel axis. Two users:

  * the int8 payload of a blocked-ELL support container (sparse/formats.py
    ``quantize_ell``): codes of the tiles' shape and one scale per row
    block, which the SpMM kernels dequantise at the operand read;
  * weight-only int8 inference (``-infer-precision int8``):
    ``quantize_params`` quantizes the LSTM gate matrices (``w_ih``,
    ``w_hh``, channel axis 0, the 4H gate rows) and the BDGCN projections
    (``W``, channel axis 1, the hidden columns); biases and the FC head
    stay f32. The model dequantizes such a tree first thing inside its
    forward (nn/mpgcn.py), so a captured rollout keeps only the codes and
    scales resident.

Scheme, per output channel c of a weight W:

    scale[c] = max|W[.., c, ..]| / 127       (1 for an all-zero channel)
    q        = clip(round(W / scale), -127, 127)   int8, ties to even
    deq      = q * scale                      (|W - deq| <= scale / 2)

computed on the host in numpy float32 exactly as the JAX package computes
it, so codes and scales are bitwise equal to its ``quantize_params``.
Trees are dicts keyed by the model's parameter names (``state_dict``).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 codes ``q`` and f32 ``scale``, singleton on every axis but the
    channel axis, so ``q * scale`` broadcasts back to the dense values."""

    q: torch.Tensor       # int8, the dense tensor's shape
    scale: torch.Tensor   # f32, singleton except the channel axis

    def __getitem__(self, key):
        """Slice the leading dims of codes and scales together (a bank
        gathered by day key slices like the dense tiles it replaces)."""
        return QuantizedTensor(self.q[key], self.scale[key])

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def dequantize(self) -> torch.Tensor:
        """The f32 dense tensor."""
        return self.q.float() * self.scale


def is_quantized(leaf) -> bool:
    return isinstance(leaf, QuantizedTensor)


def has_quantized(tree) -> bool:
    """Does the dict ``tree`` (None: no) hold a ``QuantizedTensor``?"""
    return tree is not None and any(is_quantized(v) for v in tree.values())


def _codes(w: np.ndarray, channel_axis: int):
    """(codes int8, scale f32) of one weight, as the JAX package's
    ``quantize_tensor`` computes them."""
    w_np = np.asarray(w).astype(np.float32)
    axes = tuple(a for a in range(w_np.ndim) if a != channel_axis % w_np.ndim)
    amax = np.max(np.abs(w_np), axis=axes, keepdims=True)
    if not np.isfinite(amax).all():
        raise ValueError(
            "quantize_tensor: weight has non-finite entries; quantizing "
            "would bake the poison into the container")
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w_np / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_tensor(w: torch.Tensor, channel_axis: int) -> QuantizedTensor:
    """Per-channel symmetric int8 quantization of one weight (module
    docstring); codes and scales on ``w``'s device."""
    q, scale = _codes(w.detach().float().cpu().numpy(), channel_axis)
    return QuantizedTensor(torch.from_numpy(q).to(w.device),
                           torch.from_numpy(scale).to(w.device))


#: parameter names that quantize, with their channel axis
_POLICY = ((re.compile(r"\.temporal\.layers\.\d+\.w_(ih|hh)$"), 0),
           (re.compile(r"\.spatial\.\d+\.W$"), 1))


def channel_axis(name: str):
    """The channel axis of a quantized parameter, None for one that stays
    dense (biases, the FC head)."""
    for pattern, axis in _POLICY:
        if pattern.search(name):
            return axis
    return None


def quantize_params(params: dict) -> dict:
    """Quantize a ``{name: tensor}`` parameter tree's inference weights
    (module docstring); every other entry passes through by reference."""
    out = {}
    for name, w in params.items():
        axis = channel_axis(name)
        out[name] = w if axis is None else quantize_tensor(w, axis)
    return out


@torch.no_grad()
def requantize_(qparams: dict, params: dict) -> None:
    """Quantize ``params`` again into ``qparams``'s storage, in place (its
    tensors keep their addresses, so a captured rollout that reads them
    stays valid); dense entries are copied."""
    for name, w in params.items():
        old = qparams[name]
        axis = channel_axis(name)
        if axis is None:
            if old is not w:
                old.copy_(w)
            continue
        q, scale = _codes(w.detach().float().cpu().numpy(), axis)
        old.q.copy_(torch.from_numpy(q))
        old.scale.copy_(torch.from_numpy(scale))


def dequantize_params(tree: dict) -> dict:
    """Every ``QuantizedTensor`` of ``tree`` replaced by its dense f32
    dequantization (other entries untouched)."""
    return {k: v.dequantize() if is_quantized(v) else v
            for k, v in tree.items()}


def quantization_error(params: dict, qparams: dict | None = None) -> dict:
    """The round-trip error of each quantized weight, max |W - deq(Q)|,
    beside its scale / 2 bound, and the tree's byte footprint before and
    after (the JAX package's ``quantization_error``)."""
    if qparams is None:
        qparams = quantize_params(params)
    per_layer = {}
    max_err = 0.0
    bytes_f32 = bytes_q = 0
    for name, w in params.items():
        w_np = w.detach().float().cpu().numpy()
        bytes_f32 += w_np.nbytes
        qt = qparams.get(name)
        if not is_quantized(qt):
            bytes_q += w_np.nbytes
            continue
        err = np.abs(w_np - qt.dequantize().cpu().numpy())
        bound = float(qt.scale.max()) / 2.0
        per_layer[name] = {
            "max_abs_error": float(err.max()),
            "bound_half_scale": bound,
            "rel_error": float(err.max() / (np.abs(w_np).max() or 1.0)),
        }
        max_err = max(max_err, float(err.max()))
        bytes_q += qt.nbytes
    return {
        "per_layer": per_layer,
        "max_abs_error": max_err,
        "quantized_leaves": len(per_layer),
        "param_bytes_f32": int(bytes_f32),
        "param_bytes_int8": int(bytes_q),
        "bytes_ratio": round(bytes_q / bytes_f32, 4) if bytes_f32 else 1.0,
    }
