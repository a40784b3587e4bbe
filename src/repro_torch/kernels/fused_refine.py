"""CUDA kernel wrapper: fused lower-bound + distance + top-k select.

Replaces the TPU kernel ``src/repro/kernels/fused_refine.py``
(``fused_panel_topk``): one pass over a raw (C, n) block does what the
engine's ED ``panel_refine`` needs — per-series MINDIST from the planar
(w, C) bounds, the live mask ``(lb < thr) & (id >= 0)``, expanded-form
distances ``max(||q||^2 + ||x||^2 - 2 q.x, 0)`` for live lanes only, and
the (dist, id)-lex top-k of the live lanes, plus the per-query live-lane
count.  It runs on every block the main path refines.

Bound on the H100: bytes of the live rows when the filter prunes hard,
fp32 operations (2n per live pair, no tensor cores, never TF32) when it
does not.  Design (``csrc/fused_refine.cu``): one thread block per
query; the filter runs over 256-lane chunks, one warp computes each live
lane's distance from a coalesced row read, and the chunk's live pairs
are re-selected with the running top-k in shared memory, so only (Q, k)
pairs and (Q,) counts reach device memory.  Inactive queries
(thr = -inf) return at once.  The TPU kernel's bitwise agreement with
``batch_l2`` does not carry over: the card sums in another order, so
the kernel is held to the plain ``ref.fused_panel_topk_ref`` within a
tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def fused_panel_topk(q: torch.Tensor, q_paa: torch.Tensor, block: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor, ids: torch.Tensor,
                     thr: torch.Tensor, *, k: int, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (Q, n); q_paa (Q, w); block (C, n); lo/hi (w, C); ids (C,) int32;
    thr (Q,) effective bound (-inf disables a query), all on CUDA ->
    (sel_d (Q, k) f32, sel_id (Q, k) int32, n_live (Q,) int32)."""
    global launches
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    qn, w = q_paa.shape
    c = block.shape[0]
    dev = q.device
    _build.check_tensor(q, "q", torch.float32, (qn, n))
    _build.check_tensor(q_paa, "q_paa", torch.float32, (qn, w), dev)
    _build.check_tensor(block, "block", torch.float32, (c, n), dev)
    _build.check_tensor(lo, "lo", torch.float32, (w, c), dev)
    _build.check_tensor(hi, "hi", torch.float32, (w, c), dev)
    _build.check_tensor(ids, "ids", torch.int32, (c,), dev)
    _build.check_tensor(thr, "thr", torch.float32, (qn,), dev)
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    n_live = torch.empty((qn,), dtype=torch.int32, device=dev)
    lib = _build.library().lib
    with torch.cuda.device(dev):
        status = lib.fused_panel_topk_launch(
            q.data_ptr(), q_paa.data_ptr(), block.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), ids.data_ptr(), thr.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), n_live.data_ptr(), qn, c, n, w, k,
            float(n) / float(w), _build.stream_handle(dev))
    _build.check_status(status, "fused_panel_topk")
    launches += 1
    return out_d, out_i, n_live
