"""CUDA kernel wrapper: Sakoe-Chiba banded squared DTW over a panel.

Replaces the TPU kernel ``src/repro/kernels/dtw_band.py``
(``dtw_band_panel``): the exact banded DTW cost of each query against a
shared (C, n) panel -> (Q, C), or against its own gathered (Q, M, n)
series -> (Q, M).  It runs on every DTW refine: stage A and the
query-major walk (gathered), the block-major and flat refines and the
full-scan check (shared).

Bound on the H100: fp32 operations, about 6 per band cell and
n(2r+1) - r(r+1) cells a pair.  Design (``csrc/dtw_band.cu``): one
thread per pair, only the band computed (the TPU kernel sweeps whole
anti-diagonals and masks), in one of two variants chosen by r alone:
for r <= 16 the band row and the candidate's window sit in registers
(one kernel instantiation per r), the candidates' rows are staged
through shared memory in coalesced tiles with ``cp.async``, and each
point is read from device memory once; for r > 16 the band row sits in
shared memory (the first design).  No FMA contraction: both variants
are bitwise equal to the plain ``ref.dtw_band_panel_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def dtw_band_panel(q: torch.Tensor, x: torch.Tensor, *, r: int) -> torch.Tensor:
    """q (Q, n); x (C, n) shared or (Q, M, n) gathered, f32 on CUDA ->
    (Q, C) or (Q, M) squared banded-DTW costs."""
    global launches
    if r < 0:
        raise ValueError(f"band r must be >= 0, got {r}")
    qn, n = q.shape
    gathered = x.ndim == 3
    m = x.shape[-2]
    _build.check_tensor(q, "q", torch.float32, (qn, n))
    _build.check_tensor(x, "x", torch.float32,
                        (qn, m, n) if gathered else (m, n), q.device)
    out = torch.empty((qn, m), dtype=torch.float32, device=q.device)
    lib = _build.library().lib
    with torch.cuda.device(q.device):
        status = lib.dtw_band_panel_launch(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), qn, m, n, r,
            int(gathered), _build.stream_handle(q.device))
    _build.check_status(status, "dtw_band_panel")
    launches += 1
    return out
