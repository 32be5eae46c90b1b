"""int8 codes with per-channel f32 scales (counterpart of the
``QuantizedTensor`` half of mpgcn_tpu/quant/int8.py).

Here the only user is the int8 payload of a blocked-ELL support container
(sparse/formats.py ``quantize_ell``): codes of the tiles' shape and one
scale per row block, which the SpMM kernels dequantise at the operand
read. Weight-only int8 inference is not ported yet.
"""

from __future__ import annotations

import dataclasses

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
