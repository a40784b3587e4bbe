"""CUDA kernel wrapper: batched squared Euclidean distances.

Replaces the TPU kernel ``src/repro/kernels/batch_l2.py`` (``batch_l2``):
out[q, j] = max(||q||^2 + ||x_j||^2 - 2 q.x_j, 0) for a (Q, n) query
panel against (N, n) series.  It refines every chunk of the flat ParIS
scan, the shared panels of ``ED(lb_filter=False)`` and each chunk of the
UCR brute-force scan.

Bound on the H100: bytes (5.94 MB at the flat scan's (100, 4096, 256),
1.77 us), once the cross term runs on the tensor cores; fp32 operations
(2QNn) outside them.  Design (``csrc/batch_l2.cu``): the cross term as
a split-TF32 product on the tensor cores (each operand split into a TF32
high part and a TF32 remainder, three Hopper ``wgmma`` products, the
remainder-by-remainder term dropped), which keeps fp32 accuracy; a block
holds 32 series and up to 128 query rows (two warpgroups), so each series
row is read once; the series are staged and split once in shared memory,
the query fragments are read and split in registers; the row norms are
fp32 FMAs from the same values.  Never single-pass TF32, never cuBLAS.
Sums run in another order than the plain ``ref.batch_l2_ref``, so the
two agree within a tolerance, not bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def batch_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q (Q, n), x (N, n), f32 on CUDA -> (Q, N) squared distances."""
    global launches
    qn, n = q.shape
    n_items = x.shape[0]
    _build.check_tensor(q, "q", torch.float32, (qn, n))
    _build.check_tensor(x, "x", torch.float32, (n_items, n), q.device)
    out = torch.empty((qn, n_items), dtype=torch.float32, device=q.device)
    lib = _build.library().lib
    with torch.cuda.device(q.device):
        status = lib.batch_l2_launch(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                     qn, n_items, n,
                                     _build.stream_handle(q.device))
    _build.check_status(status, "batch_l2")
    launches += 1
    return out
