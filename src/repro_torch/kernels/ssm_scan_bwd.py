"""CUDA kernel wrapper: the reverse (adjoint) scan of ``ssm_scan``.

Replaces no TPU kernel.  The reference's Pallas ``ssm_scan`` has no
backward; it trains Hymba by autodiff of the jnp chunked scan
(``src/repro/models/mamba.py:71``).  The port's training path runs the
forward kernel, so ``ops.ssm_scan``'s autograd ``Function`` launches this
kernel for the gradients of xc, dt, B, C, A and the initial state.

Bound on the H100, at Hymba's training shape (2, 1152, 1600, 16): the
bytes it must move, above its one exp a (b, t, d, n) on the
special-function units (a_t = exp(dt_t A), which the recomputed state
and the adjoint share).  Design (``csrc/ssm_scan_bwd.cu``), span-parallel:
the forward's training launch keeps the state before every 32 steps, so
every span of 32 steps recomputes its states on its own, and the adjoint
leaving a span downwards is P_j e_j + L_j of the adjoint e_j entering it,
with P_j and L_j from the span's own recompute.  One block takes one span
of a batch row's channels, all spans at once: it recomputes its states,
waits for span j + 1 to publish e_j (a flag through L2), publishes
e_{j-1}, and runs its adjoint in registers.  dx and ddt are reduced over
the states by shuffles and stored directly; dB and dC (sums over d) are
reduced over the warp by shuffles, over the block in shared memory and
over a cluster of 4 blocks through distributed shared memory, into one
partial a cluster; dA (a sum over b and t) is a running sum carried from
span to span.  A second kernel sums the partials in one fixed order.  An
atomic ticket only orders the blocks' starts (no block waits for one that
has not started); no sum uses an atomic: two runs give the same bits.
One call is one launch here, whatever kernels it runs on the card.  The
plain version is ``ref.ssm_scan_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # launches of the kernel since the last ops.reset_launch_counts()


def ssm_scan_bwd(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, a: torch.Tensor, ckpt: torch.Tensor,
                 dy: torch.Tensor, dh_last: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """xc, dt, dy (B, S, D); bm, cm (B, S, N); a (D, N); ckpt (B,
    ceil(S / 32), D, N) from ``ssm_scan_with_checkpoints``; dh_last (B, D,
    N) or None (zeros); all f32 on CUDA -> (dxc, ddt (B, S, D), dbm, dcm
    (B, S, N), da (D, N), dh0 (B, D, N))."""
    global launches
    b, s, d = xc.shape
    n = bm.shape[-1]
    _build.check_tensor(xc, "xc", torch.float32, (b, s, d))
    dev = xc.device
    spans = -(-s // _build.SSM_CKPT_STEPS)
    for name, t, shape in (("dt", dt, (b, s, d)), ("bm", bm, (b, s, n)),
                           ("cm", cm, (b, s, n)), ("a", a, (d, n)),
                           ("ckpt", ckpt, (b, spans, d, n)),
                           ("dy", dy, (b, s, d))):
        _build.check_tensor(t, name, torch.float32, shape, dev)
    if dh_last is not None:
        _build.check_tensor(dh_last, "dh_last", torch.float32, (b, d, n),
                            dev)
    lib = _build.library().lib
    f32 = dict(dtype=torch.float32, device=dev)
    dxc, ddt = torch.empty((b, s, d), **f32), torch.empty((b, s, d), **f32)
    dbm, dcm = torch.empty((b, s, n), **f32), torch.empty((b, s, n), **f32)
    da, dh0 = torch.empty((d, n), **f32), torch.empty((b, d, n), **f32)
    part = torch.empty(lib.ssm_scan_bwd_scratch(b, s, d, n, 0), **f32)
    run_a = torch.empty((b, d, n), **f32)
    ctrl = torch.empty(lib.ssm_scan_bwd_scratch(b, s, d, n, 1),
                       dtype=torch.int32, device=dev)
    ptr = lambda t: t.data_ptr()
    with torch.cuda.device(dev):
        status = lib.ssm_scan_bwd_launch(
            *map(ptr, (xc, dt, bm, cm, a, ckpt, dy)),
            None if dh_last is None else dh_last.data_ptr(),
            *map(ptr, (dxc, ddt, dbm, dcm, da, dh0, part, run_a, ctrl)),
            b, s, d, n, _build.stream_handle(dev))
    _build.check_status(status, "ssm_scan_bwd")
    launches += 1
    return dxc, ddt, dbm, dcm, da, dh0
