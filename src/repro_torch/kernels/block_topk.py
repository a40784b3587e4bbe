"""CUDA kernel wrapper: block-local (dist, id)-lexicographic top-k select.

Replaces the TPU kernel ``src/repro/kernels/block_topk.py``
(``block_topk`` with its ``select_topk``).  It reduces the stage-A seed
panel, every query-major trip's gathered panel, every flat chunk and
every DTW trip to (Q, k) before the frontier insert.

Bound on the H100: bytes — the (Q, C) panel is read once and (Q, k)
pairs written.  Design (``csrc/block_topk.cu``), for k <= 32 and
C <= 4,096: one block per row, one pass over the row into 64-bit order
keys held in registers (the distance's order bits with -0.0 taken as
+0.0, then the id); each warp's k-th smallest thread minimum bounds the
row's k-th key, the keys at or below the least such bound are ranked in
shared memory, and each output keeps its lane's own distance bits.
k > 32 or C > 4,096 takes the round kernel (k rounds of a block-wide
lex-min scan).  The kernel is chosen by k and C.  Selection is
integer-exact: bitwise equal to the plain ``ref.block_topk_ref``, ties
by id, with (INF, -1) past the row's lanes.

Contract (the engine's masking discipline): within a row ids >= 0 are
distinct, every lane with id < 0 carries d == INF, and no distance is
+inf or NaN (the engine masks with INF, float32's largest finite value).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def block_topk(d: torch.Tensor, ids: torch.Tensor, *, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """d (Q, C) f32 masked panel, ids (Q, C) int32, on CUDA ->
    ((Q, k) f32, (Q, k) int32)."""
    global launches
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    qn, c = d.shape
    _build.check_tensor(d, "d", torch.float32, (qn, c))
    _build.check_tensor(ids, "ids", torch.int32, (qn, c), d.device)
    out_d = torch.empty((qn, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=d.device)
    lib = _build.library().lib
    with torch.cuda.device(d.device):
        status = lib.block_topk_launch(
            d.data_ptr(), ids.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            qn, c, k, _build.stream_handle(d.device))
    _build.check_status(status, "block_topk")
    launches += 1
    return out_d, out_i
