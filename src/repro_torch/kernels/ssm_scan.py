"""CUDA kernel wrapper: the fused selective-SSM forward scan.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan.py`` (``ssm_scan``),
the recurrence of Hymba's Mamba heads: every ``models.mamba.mamba_mix``
call (prefill, decode, the teacher-forced forward) is one launch.

    h_t = exp(dt_t A) h_{t-1} + dt_t xc_t B_t,   y_t = sum_n h_t C_t

Beside ``y`` it returns the last state ``h_last``, and starts from
``h0`` when one is given: the state that the TPU kernel keeps in VMEM,
which serving carries from the prefill into every decode step.

Bound on the H100: at the prefill shape, one exp per (b, t, d, n) on the
special-function units, just above the bytes (xc, dt and y).  Design
(``csrc/ssm_scan.cu``): a channel's states spread over G lanes, R = 4 a
lane, in registers; tiles of 32 time steps staged by ``cp.async``,
double-buffered; exp as ``ex2.approx`` of dt * (A * log2 e); each tile's y
reduce-scattered over the channel's lanes.  Any N >= 1: N is padded in
registers to a power of two (pad states add exactly 0), N > 32 runs in
passes of 32 states, and S = 1 (a decode step) takes a one-step tile.
Nothing of size (B, S, D, N) is ever written.  The plain version is
``ref.ssm_scan_ref``.

The training launch (``ssm_scan_with_checkpoints``) also stores the
state before every 32 steps, (B, ceil(S / 32), D, N), for the backward
kernel (``kernels/ssm_scan_bwd.py``); serving and decode launch without
it and store nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def _launch(xc, dt, bm, cm, a, h0, with_ckpt: bool):
    global launches
    b, s, d = xc.shape
    n = bm.shape[-1]
    _build.check_tensor(xc, "xc", torch.float32, (b, s, d))
    dev = xc.device
    _build.check_tensor(dt, "dt", torch.float32, (b, s, d), dev)
    _build.check_tensor(bm, "bm", torch.float32, (b, s, n), dev)
    _build.check_tensor(cm, "cm", torch.float32, (b, s, n), dev)
    _build.check_tensor(a, "a", torch.float32, (d, n), dev)
    if h0 is not None:
        _build.check_tensor(h0, "h0", torch.float32, (b, d, n), dev)
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((b, -(-s // _build.SSM_CKPT_STEPS), d, n),
                        dtype=torch.float32, device=dev)
            if with_ckpt else None)
    lib = _build.library().lib
    with torch.cuda.device(dev):
        status = lib.ssm_scan_launch(
            xc.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), b, s, d, n,
            _build.stream_handle(dev))
    _build.check_status(status, "ssm_scan")
    launches += 1
    return y, h_last, ckpt


def ssm_scan(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc, dt (B, S, D); bm, cm (B, S, N); a (D, N); h0 (B, D, N) or None
    (zeros), all f32 on CUDA -> (y (B, S, D), h_last (B, D, N))."""
    y, h_last, _ = _launch(xc, dt, bm, cm, a, h0, False)
    return y, h_last


def ssm_scan_with_checkpoints(xc: torch.Tensor, dt: torch.Tensor,
                              bm: torch.Tensor, cm: torch.Tensor,
                              a: torch.Tensor, h0: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``ssm_scan``'s training launch: also the state before every
    ``SSM_CKPT_STEPS`` (32) steps, ckpt (B, ceil(S / 32), D, N) (ckpt[:,
    0] is h0 or zeros), which ``ssm_scan_bwd`` recomputes each span from.
    -> (y, h_last, ckpt)."""
    return _launch(xc, dt, bm, cm, a, h0, True)
