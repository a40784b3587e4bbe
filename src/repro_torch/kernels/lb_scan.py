"""CUDA kernel wrapper: iSAX lower-bound scan (the ParIS hot loop).

Replaces the TPU kernel ``src/repro/kernels/lb_scan.py`` (``lb_scan``):
squared MINDIST bounds of Q query PAAs against N planar region bounds,
out[q, i] = (n/w) * sum_seg max(0, lo - q, q - hi)^2.  On the main path
the flat ParIS schedule runs it over every series once a batch
(``engine.run_flat`` on ``flat_view``'s (w, Np) bounds, (100, 16, 10M)
at 10M series), and block ranking runs it over the block envelopes
(``engine.prepare``, ``engine.interval_planar_lb`` for DTW).

Bound on the H100: bytes, 1.576 ms at the flat shape (lo/hi read once,
(Q, N) written once).  Above it sits an issue floor of 1.91 ms (four
fp32 instructions a (q, i, seg) term at one warp instruction a clock on
each of the 528 schedulers; ~2.06 ms at the ~4.3 a term its SASS holds
with the loads), so instruction issue limits it.  Design
(``csrc/lb_scan.cu``): a block stages a column slice of lo/hi in shared
memory once and sweeps every query of its range against it (a wide N
reads lo/hi once whatever Q is); each thread holds a 4-query x 4-column
register tile fed by 16-byte shared loads; where every bound of a slice
has lo <= hi the term is taken as q - min(max(q, lo), hi), bitwise the
same square in one instruction fewer; 16-byte streaming stores where rows
are 16-byte aligned; a narrow N (the envelopes) splits the queries over
more blocks; the ragged edges are masked in the kernel (no SENTINEL
padding copy).  The plain version is ``ref.lb_scan_ref``.
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
