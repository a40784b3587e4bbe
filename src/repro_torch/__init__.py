"""PyTorch + CUDA port of the ParIS/MESSI data-series index.

Same module layout as the JAX package ``repro`` (its reference): each
module here has one counterpart there.  This package imports torch,
numpy and scipy only.  Slice 1 covers the main path: the in-memory
MESSI build and the block-major exact Euclidean k-NN, with the four
kernels on that path hand-written in CUDA for Hopper (``kernels/csrc``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
