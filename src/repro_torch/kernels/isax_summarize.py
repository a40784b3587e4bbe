"""CUDA kernel wrapper: fused z-norm + PAA + iSAX symbol quantization.

Replaces the TPU kernel ``src/repro/kernels/isax_summarize.py``
(``isax_summarize``), stage 1/2 of the paper's pipeline: the index
build summarizes every series once.

Bound on the H100: bytes — the (N, n) series are read once and the
work is a few operations a point (float64 where z-norm is on).  Design
(``csrc/isax_summarize.cu``): every lane on one (series, segment) pair,
two series a warp at w = 16; without z-norm each lane reads its segment
straight from device memory as 16-byte vectors (4-byte loads where n / w
is not a multiple of 4); with
z-norm a warp stages its series in shared memory and sums the mean and
variance in ``ref._lane_sum``'s order.  The symbol by binary search over
the breakpoint table, passed in from ``core.isax.breakpoints`` so the
bits match the plain version's.  The plain version is
``ref.isax_summarize_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core import isax
from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def isax_summarize(x: torch.Tensor, *, w: int = 16, card: int = 256,
                   normalize: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, n) f32 CUDA series -> (PAA (N, w) f32, symbols (N, w) int32)."""
    global launches
    n_series, n = x.shape
    if n % w:
        raise ValueError(f"series length {n} not divisible by w={w}")
    _build.check_tensor(x, "x", torch.float32, (n_series, n))
    bps = isax.breakpoints_on(card, x.device)
    paa = torch.empty((n_series, w), dtype=torch.float32, device=x.device)
    sax = torch.empty((n_series, w), dtype=torch.int32, device=x.device)
    lib = _build.library().lib
    with torch.cuda.device(x.device):
        status = lib.isax_summarize_launch(
            x.data_ptr(), bps.data_ptr(), paa.data_ptr(), sax.data_ptr(),
            n_series, n, w, bps.numel(), int(normalize),
            _build.stream_handle(x.device))
    _build.check_status(status, "isax_summarize")
    launches += 1
    return paa, sax
