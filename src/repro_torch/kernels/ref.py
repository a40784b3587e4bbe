"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, with ordinary tensor
operations, on any device.  ``ops`` takes them for CPU tensors; the
tests hold them against ``repro.kernels.ref``; ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.kernels._build import SSM_CKPT_STEPS

INF = float(torch.finfo(torch.float32).max)
PAD_ID_KEY = int(torch.iinfo(torch.int32).max)   # sort key for id < 0


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum (N, n) float64 along the last axis in the order of a warp that
    holds point j on lane j % 32: each lane adds its points in order, then
    the 32 lane sums meet in an xor butterfly (offsets 16, 8, 4, 2, 1).
    -> (N, 1)."""
    pad = (-v.shape[-1]) % 32
    if pad:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1)
    rows = v.reshape(v.shape[0], -1, 32)
    acc = torch.zeros_like(rows[:, 0])
    for r in range(rows.shape[1]):
        acc = acc + rows[:, r]
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, :1]


def isax_summarize_ref(x: torch.Tensor, *, w: int, card: int,
                       normalize: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Optional z-norm + PAA/SAX. (N, n) f32 -> PAA (N, w) f32, symbols (N, w) int32.

    Evaluated in float64 in the kernel's order (``csrc/isax_summarize.cu``):
    the mean and the population variance about it summed as one warp sums
    them, each point z-normed as (x - mean) / max(std, 1e-8), each window
    summed point by point and divided by its length, and the PAA rounded to
    float32 once.  Every step is one correctly rounded IEEE operation, so
    the kernel's PAA and symbols are bitwise these.
    """
    n = x.shape[-1]
    if n % w:
        raise ValueError(f"series length {n} not divisible by w={w}")
    xd = x.to(torch.float64)
    if normalize:
        mu = _lane_sum(xd) / n
        c = xd - mu
        sd = torch.sqrt(_lane_sum(c * c) / n)
        xd = (xd - mu) / torch.clamp(sd, min=1e-8)
    seg = n // w
    win = xd.reshape(xd.shape[0], w, seg)
    acc = torch.zeros_like(win[..., 0])
    for t in range(seg):
        acc = acc + win[..., t]
    p = (acc / seg).to(torch.float32)
    return p, isax.sax_from_paa(p, card)


def lb_scan_ref(q_paa: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, *,
                n: int) -> torch.Tensor:
    """Planar MINDIST lower bounds. q_paa (Q, w); lo/hi (w, N) -> (Q, N)
    squared bounds with the n/w scale factor."""
    w = q_paa.shape[1]
    qe = q_paa[:, :, None]
    d = torch.clamp(torch.maximum(lo[None] - qe, qe - hi[None]), min=0.0)
    return (float(n) / float(w)) * torch.sum(d * d, dim=1)


def batch_l2_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances. q (Q, n), x (N, n) -> (Q, N) f32.

    Expanded form ||q||^2 + ||x||^2 - 2 q.x, clamped at zero, evaluated in
    float64 and rounded once.  An fp32 expanded form lands a few ulps of
    ||q||^2 + ||x||^2 off the exact value, by an amount that depends on
    the order of its sums (XLA's and torch's CPU products differ); the
    plain version stays at the exact value, so it is within one such error
    of any fp32 evaluation, the kernel's and the reference's.
    """
    q = q.to(torch.float64)
    x = x.to(torch.float64)
    qq = torch.sum(q * q, dim=-1, keepdim=True)          # (Q, 1)
    xx = torch.sum(x * x, dim=-1)[None, :]               # (1, N)
    cross = q @ x.T                                      # (Q, N)
    return torch.clamp(qq + xx - 2.0 * cross, min=0.0).to(torch.float32)


def topk_by_dist_id(d: torch.Tensor, ids: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending (distance, id)-lexicographic top-k along the last axis.

    ids < 0 sort last among equal distances (keyed as INT32_MAX) and come
    back normalized to -1.  When k exceeds the candidate count the result
    is padded with (INF, -1).  Two stable sorts (by key, then by
    distance) give the lexicographic order; ``torch.topk`` does not order
    ties by id.
    """
    m = d.shape[-1]
    if k > m:
        pad = k - m
        d = torch.cat([d, torch.full(d.shape[:-1] + (pad,), INF,
                                     dtype=d.dtype, device=d.device)], -1)
        ids = torch.cat([ids, torch.full(ids.shape[:-1] + (pad,), -1,
                                         dtype=ids.dtype,
                                         device=ids.device)], -1)
    key = torch.where(ids >= 0, ids, PAD_ID_KEY)
    by_key = torch.argsort(key, dim=-1, stable=True)
    d_k = torch.gather(d, -1, by_key)
    order = torch.gather(by_key, -1,
                         torch.argsort(d_k, dim=-1, stable=True))[..., :k]
    sd = torch.gather(d, -1, order)
    si = torch.gather(ids, -1, order)
    return sd, torch.where(si >= 0, si, -1)


def block_topk_ref(d: torch.Tensor, ids: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, id)-lex top-k of a masked panel. d (Q, C) f32, ids (Q, C) int32.

    Contract: within a row ids >= 0 are distinct, and every lane with
    id < 0 carries d == INF.
    """
    return topk_by_dist_id(d, ids, k)


def signed_panel(qn: int, c: int, *, seed: int, device="cpu",
                 id_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A masked (Q, C) panel that holds to the ``block_topk`` contract and
    tests its order: ties of -0.0 and +0.0 and of negative distances, real
    lanes at INF, pad lanes (INF, -1) on a fifth of the lanes and, for
    Q > 1, an all-pad row.  Ids are distinct in a row, drawn from
    [id_offset, id_offset + 4C)."""
    rng = np.random.default_rng(seed)
    d = rng.choice(np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 3.0],
                            np.float32), (qn, c))
    d[rng.random((qn, c)) < 0.05] = INF
    ids = np.stack([rng.permutation(4 * c)[:c] for _ in range(qn)]
                   ).astype(np.int64) + id_offset
    pad = rng.random((qn, c)) < 0.2
    if qn > 1:
        pad[qn // 2] = True
    ids[pad], d[pad] = -1, INF
    return (torch.from_numpy(d).to(device),
            torch.from_numpy(ids.astype(np.int32)).to(device))


def fused_panel_topk_ref(q: torch.Tensor, q_paa: torch.Tensor,
                         block: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, ids: torch.Tensor,
                         thr: torch.Tensor, *, k: int, n: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LB filter + distance + select over one raw block, unfused.

    q (Q, n), q_paa (Q, w), block (C, n), lo/hi (w, C) planar bounds,
    ids (C,) int32, thr (Q,) effective pruning bound (-inf disables a
    query).  Returns the (dist, id)-lex top-k of the live lanes — dead
    lanes are (INF, -1) — plus the per-query live-lane count.
    """
    w = q_paa.shape[-1]
    qe = q_paa[:, :, None]                                    # (Q, w, 1)
    dd = torch.clamp(torch.maximum(lo[None] - qe, qe - hi[None]), min=0.0)
    # the w terms added in order, as the kernel does: torch.sum's order
    # differs between devices, and a bound that lands within a rounding
    # of thr would flip a lane's liveness
    acc = torch.zeros_like(dd[:, 0])
    for e in range(w):
        acc = acc + dd[:, e] * dd[:, e]
    lb = (n / w) * acc                                        # (Q, C)
    live = (lb < thr[:, None]) & (ids >= 0)[None, :]
    d = torch.where(live, batch_l2_ref(q, block), INF)
    idm = torch.where(live, ids[None, :], -1)
    sd, si = topk_by_dist_id(d, idm, k)
    return sd, si, torch.sum(live, dim=1, dtype=torch.int32)


def dtw_band_ref(a: torch.Tensor, b: torch.Tensor, r: int) -> torch.Tensor:
    """Exact squared DTW with Sakoe-Chiba band r. a (..., n) vs b (..., n),
    broadcast -> (...).

    The anti-diagonal DP of ``repro.kernels.ref.dtw_band_ref``, op for op:
    diagonal k holds cells (i, k - i), each diagonal depends on the two
    before it, cells off the band or off the matrix cost INF, and each
    cell is min(c + min(min(prev, shift(prev)), shift(prev2)), INF) with
    c = (a - b) * (a - b).  Pure elementwise arithmetic: the kernel that
    computes only the band gives the same bits.
    """
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    dev = a.device
    i_idx = torch.arange(n, device=dev)
    inf_col = torch.full(a.shape[:-1] + (1,), INF, dtype=torch.float32,
                         device=dev)

    def shift_down(d):                        # d[i] -> d[i-1]
        return torch.cat([inf_col, d[..., :-1]], dim=-1)

    prev = torch.full(a.shape, INF, dtype=torch.float32, device=dev)
    prev2 = prev
    for k in range(2 * n - 1):
        j = k - i_idx
        valid = (j >= 0) & (j < n) & ((i_idx - j).abs() <= r)
        diff = a - b[..., j.clamp(0, n - 1)]
        c = torch.where(valid, diff * diff, INF)
        best = torch.minimum(torch.minimum(prev, shift_down(prev)),
                             shift_down(prev2))
        cur = c + (best if k else 0.0)
        prev2, prev = prev, torch.clamp(cur, max=INF)   # keep INF from overflow
    return prev[..., n - 1]     # cell (n-1, n-1) lives on diag 2n-2 at i=n-1


def dtw_band_panel_ref(q: torch.Tensor, x: torch.Tensor, *, r: int
                       ) -> torch.Tensor:
    """Banded squared-DTW panel: q (Q, n) against a shared panel x (C, n)
    -> (Q, C), or against gathered x (Q, M, n) -> (Q, M)."""
    if x.ndim == 2:
        return dtw_band_ref(q[:, None, :], x[None, :, :], r)
    return dtw_band_ref(q[:, None, :], x, r)


def _scan_dtype(*ts) -> torch.dtype:
    """float64 if any operand is float64 (the gradient checks), else
    float32, the kernel's type."""
    return torch.float64 if any(t is not None and t.dtype == torch.float64
                                for t in ts) else torch.float32


def _scan_step(h, xc, dt, bm, a, t):
    """One step of the recurrence: (a_t, the state after step t)."""
    at = torch.exp(dt[:, t, :, None] * a[None])                   # (B, D, N)
    bt = (dt[:, t] * xc[:, t])[:, :, None] * bm[:, t, None, :]
    return at, at * h + bt


def ssm_scan_ref(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, a: torch.Tensor,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective-SSM scan, in the op order of
    ``repro.kernels.ref.ssm_scan_ref``: per step a_t = exp(dt_t * A),
    b_t = (dt_t * xc_t) * B_t, h = a_t * h + b_t, y_t = sum_n h * C_t.

    xc, dt (B, S, D); bm, cm (B, S, N); a (D, N) (the negative A =
    -exp(a_log)); h0 (B, D, N) or None (zeros) -> (y (B, S, D), h_last
    (B, D, N)), f32 (f64 if an operand is f64).  The coefficients are
    formed one step at a time, so nothing of size (B, S, D, N) is held.
    """
    y, h, _ = _scan(xc, dt, bm, cm, a, h0, keep=False)
    return y, h


def ssm_scan_with_checkpoints_ref(xc: torch.Tensor, dt: torch.Tensor,
                                  bm: torch.Tensor, cm: torch.Tensor,
                                  a: torch.Tensor,
                                  h0: torch.Tensor | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """``ssm_scan_ref`` that also keeps the state before every
    ``SSM_CKPT_STEPS`` steps: -> (y, h_last, ckpt (B, ceil(S / 32), D,
    N)), ckpt[:, 0] being h0 (or zeros)."""
    return _scan(xc, dt, bm, cm, a, h0, keep=True)


def _scan(xc, dt, bm, cm, a, h0, keep: bool):
    ft = _scan_dtype(xc, dt, bm, cm, a, h0)
    xc, dt, bm, cm, a = (t.to(ft) for t in (xc, dt, bm, cm, a))
    bsz, s, d = xc.shape
    h = (torch.zeros((bsz, d, bm.shape[-1]), dtype=ft, device=xc.device)
         if h0 is None else h0.to(ft))
    y = torch.empty((bsz, s, d), dtype=ft, device=xc.device)
    starts = []
    for t in range(s):
        if keep and t % SSM_CKPT_STEPS == 0:
            starts.append(h)
        _, h = _scan_step(h, xc, dt, bm, a, t)
        y[:, t] = torch.sum(h * cm[:, t, None, :], dim=-1)
    return y, h, torch.stack(starts, dim=1) if keep else None


def ssm_scan_bwd_ref(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, a: torch.Tensor, ckpt: torch.Tensor,
                     dy: torch.Tensor, dh_last: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, ...]:
    """The gradients of ``ssm_scan_ref`` given dy (B, S, D) and dh_last
    (B, D, N) or None (zeros), from the forward's states ckpt (B,
    ceil(S / 32), D, N) of ``ssm_scan_with_checkpoints_ref``: (dxc, ddt
    (B, S, D), dbm, dcm (B, S, N), da (D, N), dh0 (B, D, N)), in the
    operands' type (f32, or f64).

    The adjoint recursion, from the last step to the first:
      g_t = dy_t C_t + a_{t+1} g_{t+1}  (seeded from dh_last),
      dC_t = sum_d dy_t h_t,   dB_t = sum_d g_t dt_t x_t,
      dx_t = sum_n g_t dt_t B_t,
      ddt_t = sum_n g_t (x_t B_t + A a_t h_{t-1}),
      dA = sum_{b,t} g_t a_t dt_t h_{t-1},   dh0 = a_1 g_1.
    As the kernel does, each span of 32 steps' states is recomputed from
    its checkpoint on the way back: nothing of size (B, S, D, N) is held.
    """
    ft = _scan_dtype(xc, dt, bm, cm, a, ckpt, dy, dh_last)
    xc, dt, bm, cm, a, dy, ckpt = (t.to(ft) for t in
                                   (xc, dt, bm, cm, a, dy, ckpt))
    bsz, s, d = xc.shape
    g = (torch.zeros((bsz, d, bm.shape[-1]), dtype=ft, device=xc.device)
         if dh_last is None else dh_last.to(ft))
    dxc, ddt = torch.empty_like(xc), torch.empty_like(xc)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(bm)
    da = torch.zeros_like(a)
    for j in reversed(range(ckpt.shape[1])):
        t0 = j * SSM_CKPT_STEPS
        t1 = min(t0 + SSM_CKPT_STEPS, s)
        hs = [ckpt[:, j]]
        for t in range(t0, t1):
            hs.append(_scan_step(hs[-1], xc, dt, bm, a, t)[1])
        for t in reversed(range(t0, t1)):
            h_t, h_prev = hs[t - t0 + 1], hs[t - t0]
            at = torch.exp(dt[:, t, :, None] * a[None])
            g = g + dy[:, t, :, None] * cm[:, t, None, :]
            gdt = g * dt[:, t, :, None]
            dcm[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], h_t)
            dbm[:, t] = torch.einsum("bdn,bd->bn", gdt, xc[:, t])
            dxc[:, t] = torch.einsum("bdn,bn->bd", gdt, bm[:, t])
            ddt[:, t] = torch.sum(g * (xc[:, t, :, None] * bm[:, t, None, :]
                                       + a[None] * at * h_prev), dim=-1)
            da += torch.sum(gdt * at * h_prev, dim=0)
            g = at * g
    return dxc, ddt, dbm, dcm, da, g
