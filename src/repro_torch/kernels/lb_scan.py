"""CUDA kernel wrapper: iSAX lower-bound scan (the ParIS hot loop).

Replaces the TPU kernel ``src/repro/kernels/lb_scan.py`` (``lb_scan``):
squared MINDIST bounds of Q query PAAs against N planar region bounds,
out[q, i] = (n/w) * sum_seg max(0, lo - q, q - hi)^2.  On the main path
it ranks the block envelopes (``engine.ED.block_lb``).

Bound on the H100: bytes — planar lo/hi are read once and (Q, N) bounds
written once.  Design (``csrc/lb_scan.cu``): threads over the N axis so
the (w, N) loads and (Q, N) stores coalesce, the query tile's PAAs in
shared memory, the w terms summed in registers and then scaled, the
ragged edge masked in the kernel (no SENTINEL padding copy).  The plain
version is ``ref.lb_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def lb_scan(q_paa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
            n: int) -> torch.Tensor:
    """q_paa (Q, w); lo, hi (w, N) planar bounds, all f32 on CUDA ->
    (Q, N) squared lower bounds.  ``n`` is the raw series length."""
    global launches
    q_count, w = q_paa.shape
    n_items = lo.shape[1]
    dev = q_paa.device
    _build.check_tensor(q_paa, "q_paa", torch.float32, (q_count, w))
    _build.check_tensor(lo, "lo", torch.float32, (w, n_items), dev)
    _build.check_tensor(hi, "hi", torch.float32, (w, n_items), dev)
    out = torch.empty((q_count, n_items), dtype=torch.float32, device=dev)
    lib = _build.library().lib
    with torch.cuda.device(dev):
        status = lib.lb_scan_launch(
            q_paa.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            q_count, n_items, w, float(n) / float(w),
            _build.stream_handle(dev))
    _build.check_status(status, "lb_scan")
    launches += 1
    return out
