"""PyTorch + CUDA port of the ParIS/MESSI data-series index.

Same module layout as the JAX package ``repro`` (its reference): each
module here has one counterpart there.  This package imports torch,
numpy and scipy only.  It covers the in-memory MESSI build, every device
search path of ``repro.core`` (block-major, query-major, flat ParIS, the
UCR scan, DTW, Cosine) and, in its LM wing, Hymba serving (``configs``,
``models``, ``train.step``, ``launch.serve``).  Each of the seven kernels
that ``repro`` wrote in Pallas is hand-written in CUDA for Hopper
(``kernels/csrc``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
