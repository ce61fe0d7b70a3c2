"""PyTorch/CUDA port of the TPU-native CV training framework.

Same layout and module names as the JAX package it was ported from, so each
module's counterpart is easy to find. The port imports torch and never JAX;
every TPU kernel on a ported path is a hand-written Hopper kernel under
``csrc/`` with a plain PyTorch version beside it (``ops/kernels/``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
