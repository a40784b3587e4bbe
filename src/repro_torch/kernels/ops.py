"""Dispatch layer over the CUDA kernels and their plain PyTorch versions.

All core/ code calls these functions, never a kernel directly.  Each one
dispatches on the device of its input tensor and on nothing else:

  * a CUDA tensor launches the hand-written kernel (or the wrapper
    raises — there is no fallback);
  * a CPU tensor goes to the plain version in ``ref``.

  * a meta tensor (a count of a step's work, ``launch.op_analysis``)
    gets empty meta outputs of the result's shapes, and nothing runs.

There is no mode switch.  Code that wants a plain version on the card
(``chip_smoke.py``, the tests) calls it from ``ref`` by name.

While ``launch.op_analysis`` counts a call, ``_observer`` is its counter:
each call below is recorded there with its operands, from which the
count takes the kernel's work (``launch.roofline.kernel_work``), and the
operations that implement it (the plain version's, on the CPU) are kept
out of the count's totals, so a count reads the same whatever runs the
kernel.  Outside a count it is None and costs one test a call.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import batch_l2 as _batch_l2
from repro_torch.kernels import block_topk as _block_topk
from repro_torch.kernels import dtw_band as _dtw_band
from repro_torch.kernels import fused_refine as _fused_refine
from repro_torch.kernels import isax_summarize as _isax_summarize
from repro_torch.kernels import lb_scan as _lb_scan
from repro_torch.kernels import ref
from repro_torch.kernels._build import SSM_CKPT_STEPS
from repro_torch.kernels import ssm_scan as _ssm_scan
from repro_torch.kernels import ssm_scan_bwd as _ssm_scan_bwd

_KERNELS = {
    "isax_summarize": _isax_summarize,
    "lb_scan": _lb_scan,
    "block_topk": _block_topk,
    "fused_panel_topk": _fused_refine,
    "batch_l2": _batch_l2,
    "dtw_band_panel": _dtw_band,
    "ssm_scan": _ssm_scan,
    "ssm_scan_bwd": _ssm_scan_bwd,
}


_observer = None   # launch.op_analysis's counter while it counts a call


def _observed(name: str, **operands):
    """The context a kernel call runs in: recorded by the counter, if a
    count is on."""
    if _observer is None:
        return contextlib.nullcontext()
    return _observer.kernel_call(name, operands)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _empty(like: torch.Tensor, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def summarize(x: torch.Tensor, *, w: int, card: int, normalize: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, n) -> (paa (N, w), sax (N, w) int32)."""
    with _observed("isax_summarize", x=x, w=w, card=card,
                   normalize=normalize):
        if x.is_meta:
            return (_empty(x, x.shape[0], w),
                    _empty(x, x.shape[0], w, dtype=torch.int32))
        if _on_cuda(x):
            return _isax_summarize.isax_summarize(x, w=w, card=card,
                                                  normalize=normalize)
        return ref.isax_summarize_ref(x, w=w, card=card, normalize=normalize)


def lb_scan_planar(q_paa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   *, n: int) -> torch.Tensor:
    """q_paa (Q, w); lo/hi (w, N) -> (Q, N) squared lower bounds."""
    with _observed("lb_scan", q_paa=q_paa, lo=lo):
        if q_paa.is_meta:
            return _empty(q_paa, q_paa.shape[0], lo.shape[1])
        if _on_cuda(q_paa):
            return _lb_scan.lb_scan(q_paa, lo, hi, n=n)
        return ref.lb_scan_ref(q_paa, lo, hi, n=n)


def batch_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q (Q, n), x (N, n) -> (Q, N) squared distances."""
    with _observed("batch_l2", q=q, x=x):
        if q.is_meta:
            return _empty(q, q.shape[0], x.shape[0])
        if _on_cuda(q):
            return _batch_l2.batch_l2(q, x)
        return ref.batch_l2_ref(q, x)


def block_topk(d: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, id)-lexicographic top-k of a masked panel.

    d (Q, C) f32, ids (Q, C) int32 -> (sel_d (Q, k), sel_id (Q, k)).
    Contract: within a row ids >= 0 are distinct, every lane with id < 0
    carries d == INF, and no distance is +inf or NaN.  k may exceed C:
    the tail is (INF, -1).
    """
    with _observed("block_topk", d=d, k=k):
        if d.is_meta:
            return (_empty(d, d.shape[0], k),
                    _empty(d, d.shape[0], k, dtype=torch.int32))
        if _on_cuda(d):
            return _block_topk.block_topk(d, ids, k=k)
        return ref.block_topk_ref(d, ids, k)


def fused_panel_topk(q: torch.Tensor, q_paa: torch.Tensor, block: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor, ids: torch.Tensor,
                     thr: torch.Tensor, *, k: int, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused LB + distance + select over one raw block.

    q (Q, n), q_paa (Q, w), block (C, n), lo/hi (w, C) planar bounds,
    ids (C,) int32, thr (Q,) effective bound (-inf disables a query)
    -> (sel_d (Q, k), sel_id (Q, k), n_live (Q,) int32).
    """
    with _observed("fused_panel_topk", q=q, q_paa=q_paa, block=block, k=k):
        if q.is_meta:
            qn = q.shape[0]
            return (_empty(q, qn, k), _empty(q, qn, k, dtype=torch.int32),
                    _empty(q, qn, dtype=torch.int32))
        if _on_cuda(q):
            return _fused_refine.fused_panel_topk(q, q_paa, block, lo, hi,
                                                  ids, thr, k=k, n=n)
        return ref.fused_panel_topk_ref(q, q_paa, block, lo, hi, ids, thr,
                                        k=k, n=n)


def dtw_panel(q: torch.Tensor, x: torch.Tensor, *, r: int) -> torch.Tensor:
    """Banded squared-DTW panel. q (Q, n); x (C, n) shared -> (Q, C), or
    x (Q, M, n) gathered -> (Q, M)."""
    with _observed("dtw_band_panel", q=q, x=x, r=r):
        if q.is_meta:
            return _empty(q, q.shape[0], x.shape[-2])
        if _on_cuda(q):
            return _dtw_band.dtw_band_panel(q, x, r=r)
        return ref.dtw_band_panel_ref(q, x, r=r)


def _f32(*ts):
    """The scan kernels' operands in float32, the kernels' type (the
    plain versions compute in it too): a bf16 model's mixer hands them
    bf16."""
    return tuple(None if t is None else t.to(torch.float32) for t in ts)


def _scan_outputs(xc: torch.Tensor, bm: torch.Tensor):
    """Empty (y (B, S, D), h_last (B, D, N)) f32 like a scan's."""
    b, s, d = xc.shape
    return _empty(xc, b, s, d), _empty(xc, b, d, bm.shape[-1])


class _SSMScan(torch.autograd.Function):
    """``ssm_scan`` under autograd.  Its forward is the training launch,
    which also keeps the state before every 32 steps; its backward is the
    reverse scan from those states (the ``ssm_scan_bwd`` kernel on the
    card, ``ref.ssm_scan_bwd_ref`` on the CPU)."""

    @staticmethod
    def forward(ctx, xc, dt, bm, cm, a, h0):
        with _observed("ssm_scan", xc=xc, bm=bm, h0=h0, ckpt=True):
            if xc.is_meta:
                y, h_last = _scan_outputs(xc, bm)
                b, s, d = xc.shape
                ckpt = _empty(xc, b, -(-s // SSM_CKPT_STEPS), d, bm.shape[-1])
            elif _on_cuda(xc):
                y, h_last, ckpt = _ssm_scan.ssm_scan_with_checkpoints(
                    *_f32(xc, dt, bm, cm, a, h0))
            else:
                y, h_last, ckpt = ref.ssm_scan_with_checkpoints_ref(
                    xc, dt, bm, cm, a, h0)
        ctx.save_for_backward(xc, dt, bm, cm, a, ckpt)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        xc, dt, bm, cm, a, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(xc) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        with _observed("ssm_scan_bwd", xc=xc, bm=bm, dh_last=dh_last):
            if xc.is_meta:
                b, _, d = xc.shape
                n = bm.shape[-1]
                grads = (torch.empty_like(xc, dtype=torch.float32),
                         torch.empty_like(dt, dtype=torch.float32),
                         torch.empty_like(bm, dtype=torch.float32),
                         torch.empty_like(cm, dtype=torch.float32),
                         torch.empty_like(a, dtype=torch.float32),
                         _empty(xc, b, d, n))
            elif _on_cuda(xc):
                grads = _ssm_scan_bwd.ssm_scan_bwd(
                    *_f32(xc, dt, bm, cm, a, ckpt, dy, dh_last))
            else:
                grads = ref.ssm_scan_bwd_ref(xc, dt, bm, cm, a, ckpt, dy,
                                             dh_last)
        dxc, ddt, dbm, dcm, da, dh0 = grads
        return dxc, ddt, dbm, dcm, da, dh0 if ctx.has_h0 else None


def ssm_scan(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-SSM scan. xc, dt (B, S, D); bm, cm (B, S, N); a (D, N);
    h0 (B, D, N) or None -> (y (B, S, D), h_last (B, D, N)).

    Differentiable: when autograd records an operand, the call goes
    through ``_SSMScan`` (the training launch, then the reverse scan in
    the backward).  Otherwise (serving and decode run under
    ``torch.no_grad()``) it is the plain forward launch."""
    operands = (xc, dt, bm, cm, a, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in operands):
        return _SSMScan.apply(*operands)
    with _observed("ssm_scan", xc=xc, bm=bm, h0=h0):
        if xc.is_meta:
            return _scan_outputs(xc, bm)
        if _on_cuda(xc):
            return _ssm_scan.ssm_scan(*_f32(*operands))
        return ref.ssm_scan_ref(xc, dt, bm, cm, a, h0)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts()``, by kernel."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
