"""PyTorch + CUDA port of the ParIS/MESSI data-series index.

Same module layout as the JAX package ``repro`` (its reference): each
module here has one counterpart there.  This package imports torch,
numpy and scipy only.  It covers the in-memory MESSI build, every device
search path of ``repro.core`` (block-major, query-major, flat ParIS, the
UCR scan, DTW, Cosine), the on-disk index of ``repro.storage`` (the DSIX
file: ``storage.save_index`` / ``load_index`` / ``open_index``; the
staged, resumable out-of-core build: ``storage.pipeline_build`` /
``build_on_disk``; the cached block-major walk: ``storage.ooc_search``
and ``storage.SearchSession``) and, in its LM wing, Hymba serving
(``configs``, ``models``, ``train.step``, ``launch.serve``).  Every entry
point takes ``device=``, the card (``"cuda"``) unless the caller asks for
the CPU.  Each of the seven kernels that ``repro`` wrote in Pallas is
hand-written in CUDA for Hopper (``kernels/csrc``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
