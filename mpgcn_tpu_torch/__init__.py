"""PyTorch/CUDA port of MPGCN for NVIDIA Hopper (H100).

A second package beside the JAX reference ``mpgcn_tpu``: it imports
``torch`` and never JAX or ``mpgcn_tpu``, keeping its own copies of what it
needs. Every TPU kernel on a ported path is a hand-written CUDA kernel
(``csrc/``) with a plain PyTorch version beside it; entry points run on the
card unless the caller passes ``device="cpu"``.
"""
