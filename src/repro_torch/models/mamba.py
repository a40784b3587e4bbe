"""Mamba-style selective SSM head (the SSM half of Hymba's hybrid layers).

The PyTorch counterpart of ``repro.models.mamba``.  Recurrence (per
channel c, state dim N):

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(dt_t * A_c),  b_t = dt_t * B_t * x_t
    y_t = <C_t, h_t> + D_c * x_c

``mamba_mix`` runs the recurrence as one ``ops.ssm_scan`` call, which on
the card is the hand-written kernel (``kernels/csrc/ssm_scan.cu``): the
(B, S, D, N) coefficients are never built.  The reference runs the same
recurrence as a chunked ``lax.associative_scan``.  Prefill, decode (S = 1,
from the cached state and conv history) and the teacher-forced forward
all take this one path.  ``mamba_naive`` is the plain sequential oracle
(tests and ``chip_smoke.py`` only).

``mamba_mix(..., tp=group)`` runs the mixer channel-parallel over a
model group of M ranks, in training and in serving: rank r holds
channels r·D/M .. (r+1)·D/M of ``conv``, ``w_dt``, ``dt_bias``,
``w_b``, ``w_c``, ``a_log``, ``d_skip`` and the rows of ``w_out``, and
of the state (``h`` (B, D/M, N), ``conv`` (B, K-1, D/M)).  Its block of ``w_in`` is
columns r·2D/M .. (r+1)·2D/M of the fused x|z, as the reference's
specs cut it (at M = 2 every x column on rank 0, every z column on
rank 1): x is projected onto that block, the (B, S, 2D) projection is
gathered over the group, and the rank takes its own channels of each
half.  ``B_t`` and ``C_t`` are sums over every channel: each rank's
partial sums are completed by one all-reduce.  Every rank's scan reads
the summed ``B_t``/``C_t`` for its own channels only, so its gradient
of them is a part too, and the backward all-reduces it as well
(``copy_to`` of ``reduce_from``).  The scan runs on the rank's
(B, S, D/M, N), under autograd its training launch and ``ssm_scan_bwd``
there, and the ``w_out`` rows' partial outputs end in one
``reduce_from``.  Every other leaf is the rank's channels, so its
gradient stays local; ``x`` enters through ``copy_to``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common, parallel


class MambaState(NamedTuple):
    h: torch.Tensor          # (B, d_inner, N) ssm state
    conv: torch.Tensor       # (B, K-1, d_inner) depthwise conv history


def param_specs(cfg, d_inner: int) -> dict:
    """One stacked Mamba head bank, the reference's names and layouts."""
    L, d, n, k = cfg.n_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    S = common.ParamSpec
    return {
        "w_in": S((L, d, 2 * d_inner), ("layers", "embed", "d_inner")),
        "conv": S((L, k, d_inner), ("layers", None, "d_inner"), scale=0.5),
        "w_dt": S((L, d_inner, 1), ("layers", "d_inner", None), scale=0.5),
        "dt_bias": S((L, d_inner), ("layers", "d_inner"), init="zeros"),
        "w_b": S((L, d_inner, n), ("layers", "d_inner", None), scale=0.5),
        "w_c": S((L, d_inner, n), ("layers", "d_inner", None), scale=0.5),
        "a_log": S((L, d_inner, n), ("layers", "d_inner", None),
                   init="value", value=0.0),
        "d_skip": S((L, d_inner), ("layers", "d_inner"), init="ones"),
        "w_out": S((L, d_inner, d), ("layers", "d_inner", "embed_out")),
    }


def _conv_causal(x: torch.Tensor, kernel: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, D); kernel (K, D); history (B, K-1, D)."""
    k = kernel.shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)                        # (B, S+K-1, D)
    out = xp[:, 0:x.shape[1], :] * kernel[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1], :] * kernel[i][None, None, :]
    return out


def _dt_bc(xc: torch.Tensor, p: dict, tp=None):
    """xc (B, S, D) -> dt (B, S, D), B_t, C_t (B, S, N), A (D, N).
    ``tp``: ``xc`` holds this rank's channels; B_t and C_t, sums over
    every channel, are completed by one all-reduce over the group, and
    so are their gradients, each rank's the part of its channels."""
    dt = F.softplus(xc * p["w_dt"][..., 0] + p["dt_bias"])
    bt = xc @ p["w_b"]
    ct = xc @ p["w_c"]
    if parallel.size(tp) > 1:
        n = bt.shape[-1]
        bc = parallel.reduce_from(torch.cat([bt, ct], dim=-1), tp)
        bt, ct = parallel.copy_to(bc, tp).split(n, dim=-1)
    a_mat = -torch.exp(p["a_log"].to(torch.float32))
    return dt, bt, ct, a_mat


def _ssm_coeffs(xc: torch.Tensor, p: dict):
    """xc (B, S, D) conv output -> (a, b, c_t) for the linear recurrence,
    a and b (B, S, D, N).  The plain oracle's form; the kernel path never
    builds them."""
    dt, bt, ct, a_mat = _dt_bc(xc, p)
    a = torch.exp(dt[..., None] * a_mat[None, None])
    b = (dt * xc)[..., None] * bt[:, :, None, :]
    return a.to(torch.float32), b.to(torch.float32), ct


def _mixer_in(xz: torch.Tensor, p: dict, d_inner: int,
              state: MambaState | None):
    """The conv over the x half of the projection ``xz`` (B, S, 2D)."""
    k = p["conv"].shape[0]
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    hist = (state.conv if state is not None
            else xz.new_zeros((xz.shape[0], k - 1, d_inner)))
    xc = F.silu(_conv_causal(xi, p["conv"], hist))
    tail = torch.cat([hist, xi], dim=1)[:, -(k - 1):]
    return xc, z, tail


def _mixer_out(y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor, p: dict,
               dtype: torch.dtype) -> torch.Tensor:
    y = y + p["d_skip"] * xc.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(dtype)
    return y @ p["w_out"]


def _channels(x: torch.Tensor, p: dict, d_inner: int, tp
              ) -> tuple[torch.Tensor, int]:
    """A channel-parallel rank's x|z projection: ``x`` onto its block of
    ``w_in``'s fused columns, the blocks gathered over ``tp``, then its
    own channels of the x half and of the z half.  -> ((B, S, 2·D/M),
    D/M)."""
    m, r = parallel.size(tp), dist.get_rank(tp)
    dl = d_inner // m
    w_in = p["w_in"]
    if w_in.shape[-1] != 2 * dl or p["conv"].shape[-1] != dl:
        raise ValueError(f"channel-parallel Mamba on {m} ranks takes "
                         f"{2 * dl} columns of w_in and {dl} channels of "
                         f"the rest, got {w_in.shape[-1]} and "
                         f"{p['conv'].shape[-1]}")
    xz = parallel.gather_acts(parallel.copy_to(x, tp) @ w_in, tp)
    return torch.cat([xz[..., r * dl:(r + 1) * dl],
                      xz[..., d_inner + r * dl:d_inner + (r + 1) * dl]],
                     dim=-1), dl


def mamba_mix(x: torch.Tensor, p: dict, *, d_inner: int,
              state: MambaState | None = None, tp=None
              ) -> tuple[torch.Tensor, MambaState]:
    """Full Mamba mixer. x (B, S, d_model) -> (B, S, d_model), final state.

    The recurrence is one ``ops.ssm_scan`` call from ``state.h`` (zeros
    without a state).  ``tp``: a model group over which the mixer runs
    channel-parallel (the module's docstring); ``state`` then holds this
    rank's channels, and so does the state returned."""
    if parallel.size(tp) > 1:
        xz, d_inner = _channels(x, p, d_inner, tp)
    else:
        xz = x @ p["w_in"]
    xc, z, tail = _mixer_in(xz, p, d_inner, state)
    dt, bt, ct, a_mat = _dt_bc(xc, p, tp)
    h0 = state.h if state is not None else None
    y, h_last = ops.ssm_scan(xc.contiguous(), dt.contiguous(),
                             bt.contiguous(), ct.contiguous(),
                             a_mat.contiguous(),
                             None if h0 is None else h0.contiguous())
    out = _mixer_out(y, xc, z, p, x.dtype)
    return parallel.reduce_from(out, tp), MambaState(h=h_last, conv=tail)


def mamba_naive(x: torch.Tensor, p: dict, *, d_inner: int,
                state: MambaState | None = None
                ) -> tuple[torch.Tensor, MambaState]:
    """Sequential oracle: the same math, a plain per-step loop over the
    materialised (B, S, D, N) coefficients."""
    b, s, _ = x.shape
    xc, z, tail = _mixer_in(x @ p["w_in"], p, d_inner, state)
    a, bb, ct = _ssm_coeffs(xc, p)
    h = (state.h.to(torch.float32) if state is not None
         else torch.zeros((b, d_inner, p["w_b"].shape[1]),
                          dtype=torch.float32, device=x.device))
    y = torch.empty((b, s, d_inner), dtype=torch.float32, device=x.device)
    ct = ct.to(torch.float32)
    for t in range(s):
        h = a[:, t] * h + bb[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, ct[:, t])
    return _mixer_out(y, xc, z, p, x.dtype), MambaState(h=h, conv=tail)


def init_state(batch: int, d_inner: int, n_state: int, k_conv: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = "cuda") -> MambaState:
    dev = resolve_device(device)
    return MambaState(
        h=torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros((batch, k_conv - 1, d_inner), dtype=dtype,
                         device=dev))
