"""Device selection shared by every entry point of the port.

Entry points take ``device="cuda"`` by default and run on the card. A
caller that wants the CPU (the tests, which check the port against the
JAX package) says so with ``device="cpu"``. Nothing falls back to the CPU
on its own: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch versions "
            f"of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: expected a "
                         f"'cuda' or 'cpu' device")
    return dev
