"""PyTorch/CUDA port of the learned-index reproduction.

Mirrors ``src/repro`` module for module (same relative paths), so each
file here has an obvious twin in the JAX reference.  Plain tensor code
is PyTorch; the reference's Pallas kernels become hand-written CUDA
kernels for Hopper (``kernels/csrc``), each with a plain PyTorch twin
that the CPU tests run.

Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
