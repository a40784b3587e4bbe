"""CUDA kernel wrapper: fused lower-bound + distance + top-k select.

Replaces the TPU kernel ``src/repro/kernels/fused_refine.py``
(``fused_panel_topk``): one pass over a raw (C, n) block does what the
engine's ED ``panel_refine`` needs — per-series MINDIST from the planar
(w, C) bounds, the live mask ``(lb < thr) & (id >= 0)``, expanded-form
distances ``max(||q||^2 + ||x||^2 - 2 q.x, 0)`` for live pairs only, and
the (dist, id)-lex top-k of the live lanes, plus the per-query live-lane
count.  It runs on every block the main path refines.

Bound on the H100: bytes of the queries, the bounds and the live rows
when the filter prunes hard, fp32 operations (2n per live pair, no
tensor cores, never TF32) when it does not.  Design
(``csrc/fused_refine.cu``): the TPU kernel's (Q, C) tiling, one thread
block per 8 queries x 64 lanes (208 blocks at (100, 1024)); the filter
reads each bound once per query tile, only rows some query keeps are
staged, each thread forms one row's distances to two queries with fp32
FMAs, a warp per query ranks its slice's live pairs with no block
barrier, and the block that finishes a query tile last merges the
slices' sorted lists in the same launch.  The slices' lists go through a
scratch buffer allocated here; the tile counters are a zeroed buffer
kept per device and stream, which the kernel leaves at 0.  Inactive
queries (thr = -inf) keep no lane.  The TPU kernel's bitwise agreement
with ``batch_l2`` does not carry over: the card sums in another order,
so the kernel is held to the plain ``ref.fused_panel_topk_ref`` within a
tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()
# (device, stream handle) -> int32 tile counters, zero between launches
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tile_counters(lib, qn: int, dev: torch.device, stream: int
                   ) -> torch.Tensor:
    tiles = lib.fused_panel_topk_tiles(qn)
    buf = _counters.get((dev, stream))
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros((max(tiles, 16),), dtype=torch.int32, device=dev)
        _counters[(dev, stream)] = buf
    return buf


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
    scratch = torch.empty((lib.fused_panel_topk_scratch_words(qn, c, k),),
                          dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)
    counters = _tile_counters(lib, qn, dev, stream)
    with torch.cuda.device(dev):
        status = lib.fused_panel_topk_launch(
            q.data_ptr(), q_paa.data_ptr(), block.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), ids.data_ptr(), thr.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), n_live.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), qn, c, n, w, k, float(n) / float(w), stream)
    _build.check_status(status, "fused_panel_topk")
    launches += 1
    return out_d, out_i, n_live
