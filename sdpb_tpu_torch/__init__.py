"""sdpb_tpu_torch: the PyTorch/CUDA port of sdpb_tpu.

An arbitrary-precision primal-dual interior-point SDP solver (the
capabilities of SDPB) in the base-2^9 limb format, on one NVIDIA GPU:
plain tensor code in PyTorch, the sequential limb factorizations as
CUDA kernels written for Hopper (ops/limb_kernels.py), the O(n^3)
products through the exact integer CRT pipeline (ops/exact.py).  It
imports neither jax nor sdpb_tpu.
"""

__version__ = "0.1.0"
