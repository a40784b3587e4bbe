"""Gradient compression: int8 quantization with error feedback.

The PyTorch counterpart of ``repro.train.compression``.  Each rank's
gradient leaf is quantized to int8 with a per-leaf absmax scale,
exchanged with an ``all_gather`` over a ``torch.distributed`` group (int8
on the wire, a quarter of fp32's bytes) and dequant-summed locally, in
place of the reference's all-gather over a mesh axis inside
``shard_map``.  The quantization residual feeds the next step's gradient
(error feedback), which keeps convergence intact.  As in the reference,
no int8 all-reduce is used: a collective reducing in int8 would
overflow.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import common


def quantize8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-leaf absmax int8 quantization. Returns (q, scale)."""
    s = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q, s


def dequant8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Quantize (g + err); the new residual is the next step's err."""
    gc = g.to(torch.float32) + err
    q, s = quantize8(gc)
    return q, s, gc - dequant8(q, s)


def init_error_state(params: dict) -> dict:
    return common.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def ddp_allreduce_int8(grads: dict, err: dict, group=None
                       ) -> tuple[dict, dict]:
    """Mean over the ranks of ``group`` of each rank's gradients, with an
    int8 wire format.  Every rank of the group calls it with its own
    ``grads`` and error state (trees of the same structure).  Returns
    (the mean gradient, the same on every rank; this rank's new error
    state)."""
    n = dist.get_world_size(group)
    err_of = dict(common.leaves(err))
    mean, new_err = {}, {}
    for path, g in common.leaves(grads):
        q, s, new_err[path] = compress_with_feedback(g, err_of[path])
        qs = [torch.empty_like(q) for _ in range(n)]
        ss = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(qs, q, group=group)             # int8 on the wire
        dist.all_gather(ss, s, group=group)
        tot = torch.tensordot(torch.stack(ss), torch.stack(qs).to(
            torch.float32), dims=([0], [0]))
        mean[path] = tot / n
    return common.with_leaves(grads, mean), common.with_leaves(err, new_err)
