"""RWKV6 "Finch": attention-free time mixing with data-dependent decay.

The PyTorch counterpart of ``repro.models.rwkv``.  Per head (key/value
dims n = head_dim) the recurrence is

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t            (state n x n)
    out_t = r_t ( S_{t-1} + diag(u) k_t^T v_t )

with w_t = exp(-exp(ww_t)) in (0, 1) computed from the token itself and
u the current-token bonus.

Training and prefill use the closed form over chunks: with L the
inclusive cumsum of log w inside a chunk and Lx its exclusive version,
for j < t

    score[t, j] = sum_n r_t[n] k_j[n] exp(Lx_t[n] - L_j[n])     (<= 0 exponent)
    cross_t     = (r_t * exp(Lx_t)) @ S_0
    S_end       = diag(exp(L_end)) S_0 + sum_j diag(exp(L_end - L_j)) k_j^T v_j

Every exponent is a later-minus-earlier difference of cumsums of negative
logs, so it is <= 0 and nothing overflows; the (C, C, n) tensor keeps it
so, which is why chunks are short.

One difference from the reference, on purpose: when the sequence is no
multiple of the chunk the reference runs one chunk of the whole sequence,
a (B, S, S, H, n) tensor (about 275 GB at rwkv6-7b's widths for 2 x 2,050
tokens).  Here the sequence runs in chunks of ``chunk`` and one ragged
last chunk: the same closed form, the same values up to rounding.
``rwkv_naive_wkv`` is the sequential oracle.

Over a model group of M ranks, in training and in serving:
``time_mix(..., tp=group)`` runs by head.  Rank r holds heads r·H/M ..
(r+1)·H/M: the columns of ``w_r``, ``w_k``, ``w_v``, ``w_g``, the rows
of ``w_o``, ``bonus_u`` and the state ``s`` (B, H/M, n, n).  The token
shift, the mixes and the decay LoRA's first product run whole on every
rank; the decays are computed for the rank's columns only, and ``ln_x``
is used by those columns.  Those replicated leaves (``mix``,
``decay_base``, ``decay_a``, ``decay_b``, ``ln_x``) enter through
``copy_to``, as ``x`` does: each rank's heads give a part of their
gradients.  The ranks' ``w_o`` outputs meet in one ``reduce_from``.
``channel_mix(..., tp=group)`` runs by ``ff``: ``w_ck`` columns and
``w_cv`` rows give partial sums, of which one reduce-scatter leaves the
rank its d/M columns; the receptance gate runs there, on the rank's
``w_cr`` columns, and one all-gather restores the row, whose backward
keeps the rank's slice (``parallel.reduce_scatter``,
``gather_replicated``).  ``mix_c`` enters through ``copy_to``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import common, parallel


class RwkvState(NamedTuple):
    s: torch.Tensor        # (B, H, n, n) wkv state (f32)
    x_tm: torch.Tensor     # (B, d) last token seen by time mix
    x_cm: torch.Tensor     # (B, d) last token seen by channel mix


LORA = 64   # decay LoRA rank (rwkv6 uses 64 for 7B)
# the time mix's leaves that "model" does not cut: a rank by head uses
# them for its own heads, so its gradient of them is a part
TIME_REPLICATED = ("mix", "decay_base", "decay_a", "decay_b", "ln_x")


def param_specs(cfg) -> dict:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    n = cfg.rwkv_head_dim
    h = d // n
    S = common.ParamSpec
    return {
        # time mix
        "mix": S((L, 5, d), ("layers", None, "embed"), init="value",
                 value=0.5),
        "w_r": S((L, d, d), ("layers", "embed", "heads_x_dim")),
        "w_k": S((L, d, d), ("layers", "embed", "heads_x_dim")),
        "w_v": S((L, d, d), ("layers", "embed", "heads_x_dim")),
        "w_g": S((L, d, d), ("layers", "embed", "heads_x_dim")),
        "w_o": S((L, d, d), ("layers", "heads_x_dim", "embed_out")),
        "decay_base": S((L, d), ("layers", "embed"), init="value",
                        value=-5.0),
        "decay_a": S((L, d, LORA), ("layers", "embed", None), scale=0.1),
        "decay_b": S((L, LORA, d), ("layers", None, "embed"), scale=0.1),
        "bonus_u": S((L, h, n), ("layers", "kv_heads", None), init="zeros"),
        "ln_x": S((L, d), ("layers", "embed"), init="zeros"),
        # channel mix
        "mix_c": S((L, 2, d), ("layers", None, "embed"), init="value",
                   value=0.5),
        "w_ck": S((L, d, f), ("layers", "embed", "ff")),
        "w_cr": S((L, d, d), ("layers", "embed", "heads_x_dim"), scale=0.5),
        "w_cv": S((L, f, d), ("layers", "ff", "embed_out")),
        "ln1": S((L, d), ("layers", "embed"), init="zeros"),
        "ln2": S((L, d), ("layers", "embed"), init="zeros"),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x (B, S, d); last (B, d) -> the previous-token sequence (B, S, d)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _decays(xw: torch.Tensor, p: dict, cols: slice = slice(None)
            ) -> torch.Tensor:
    """Data-dependent log-decay of the columns ``cols``.  Returns log w
    (B, S, len(cols)), strictly < 0."""
    ww = p["decay_base"][cols] \
        + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"][:, cols]
    return -torch.exp(torch.clamp(ww.to(torch.float32), -12.0, 6.0))


def _group_norm(x: torch.Tensor, gamma: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Per-head layernorm over head_dim (rwkv's ln_x). x (B, S, H, n)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    xn = (x - mu) * torch.rsqrt(var + 1e-5)
    h = x.shape[2]
    g = (1.0 + gamma.to(torch.float32)).reshape(h, n)
    return xn * g[None, None]


def _chunk_wkv(r, k, v, logw, u, s0):
    """One chunk of the closed-form WKV.

    r, k, v, logw (B, C, H, n); u (H, n); s0 (B, H, n, n) f32.
    Returns (out (B, C, H, n) f32, s_end)."""
    c = r.shape[1]
    L = torch.cumsum(logw, dim=1)                      # inclusive
    Lx = L - logw                                      # exclusive
    # intra-chunk scores (B, H, Ct, Cj) over the strictly earlier tokens
    expo = Lx[:, :, None] - L[:, None, :]              # (B, Ct, Cj, H, n)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None, None]
    decay = torch.exp(torch.where(mask, expo, -torch.inf)).to(r.dtype)
    scores = torch.einsum("btjhn,btjhn->bhtj",
                          r[:, :, None] * k[:, None, :], decay)
    diag = torch.einsum("bthn,hn,bthn->bht", r, u.to(r.dtype), k)
    out = torch.einsum("bhtj,bjhn->bthn", scores, v).to(torch.float32)
    out = out + diag.permute(0, 2, 1)[..., None] * v.to(torch.float32)
    # cross-chunk: r_t * exp(Lx_t) against s0
    rx = r.to(torch.float32) * torch.exp(Lx)
    out = out + torch.einsum("bthn,bhnm->bthm", rx, s0)
    # state update
    kw = k.to(torch.float32) * torch.exp(L[:, -1:] - L)   # (B, C, H, n)
    s_end = s0 * torch.exp(L[:, -1])[..., None] \
        + torch.einsum("bthn,bthm->bhnm", kw, v.to(torch.float32))
    return out, s_end


def time_mix(x: torch.Tensor, p: dict, *, head_dim: int, chunk: int = 64,
             state: RwkvState | None = None, tp=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV6 attention replacement.  x (B, S, d) -> (out, s_end, last_x).

    The sequence runs in chunks of ``chunk`` tokens, the last one ragged
    when S is no multiple of it.  ``tp``: a model group over which it
    runs by head (the module's docstring); ``state.s`` and ``s_end``
    then hold this rank's heads."""
    b, s, d = x.shape
    n = head_dim
    m = parallel.size(tp)
    h = d // n // m                                    # this rank's heads
    col = 0 if m == 1 else dist.get_rank(tp) * h * n   # its first column
    if p["w_r"].shape[-1] != h * n:
        raise ValueError(f"time mix over {m} ranks takes {h} heads a "
                         f"rank, w_r holds {p['w_r'].shape[-1]} columns")
    x = parallel.copy_to(x, tp)
    p = {**p, **{k: parallel.copy_to(p[k], tp) for k in TIME_REPLICATED}}
    cols = slice(col, col + h * n)
    last = state.x_tm if state is not None else x.new_zeros((b, d))
    xs = _token_shift(x, last)
    mu = p["mix"]                                      # (5, d)
    xr, xk, xv, xw, xg = (_lerp(x, xs, mu[i]) for i in range(5))
    r = (xr @ p["w_r"]).reshape(b, s, h, n)
    k = (xk @ p["w_k"]).reshape(b, s, h, n)
    v = (xv @ p["w_v"]).reshape(b, s, h, n)
    g = xg @ p["w_g"]
    logw = _decays(xw, p, cols).reshape(b, s, h, n)

    st = (state.s if state is not None
          else torch.zeros((b, h, n, n), dtype=torch.float32,
                           device=x.device))
    c = min(chunk, s)
    outs = []
    for lo in range(0, s, c):
        hi = min(lo + c, s)
        o, st = _chunk_wkv(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                           logw[:, lo:hi], p["bonus_u"], st)
        outs.append(o)
    out = _group_norm(torch.cat(outs, dim=1), p["ln_x"][cols], n
                      ).reshape(b, s, h * n)
    out = (out * F.silu(g.to(torch.float32))).to(x.dtype)
    return parallel.reduce_from(out @ p["w_o"], tp), st, x[:, -1, :]


def channel_mix(x: torch.Tensor, p: dict, *,
                state: RwkvState | None = None, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 FFN. x (B, S, d) -> (out, last_x).  ``tp``: a model group
    over which ``w_ck`` holds this rank's ``ff`` columns, ``w_cv`` its
    rows and ``w_cr`` its d/M columns (the module's docstring)."""
    b, s, d = x.shape
    m = parallel.size(tp)
    if p["w_cr"].shape[-1] * m != d:
        raise ValueError(f"channel mix over {m} ranks takes {d // m} "
                         f"columns of w_cr, got {p['w_cr'].shape[-1]}")
    x = parallel.copy_to(x, tp)
    last = state.x_cm if state is not None else x.new_zeros((b, d))
    xs = _token_shift(x, last)
    mu = parallel.copy_to(p["mix_c"], tp)
    xk = _lerp(x, xs, mu[0])
    xr = _lerp(x, xs, mu[1])
    kk = torch.square(F.relu(xk @ p["w_ck"]))
    rr = torch.sigmoid((xr @ p["w_cr"]).to(torch.float32)).to(x.dtype)
    out = rr * parallel.reduce_scatter(kk @ p["w_cv"], tp)
    return parallel.gather_replicated(out, tp), x[:, -1, :]


def rwkv_layer(x: torch.Tensor, p: dict, *, head_dim: int, chunk: int = 64,
               state: RwkvState | None = None, tp=None, ffn_tp=None
               ) -> tuple[torch.Tensor, RwkvState]:
    """One full RWKV block: time mix + channel mix, pre-norm residual.
    ``tp`` / ``ffn_tp``: the model group of a time mix by head / a
    channel mix by ``ff`` (``state.s`` then holds this rank's heads)."""
    att, s_end, x_tm = time_mix(common.rmsnorm(x, p["ln1"]), p,
                                head_dim=head_dim, chunk=chunk, state=state,
                                tp=tp)
    x = x + att
    ffn, x_cm = channel_mix(common.rmsnorm(x, p["ln2"]), p, state=state,
                            tp=ffn_tp)
    return x + ffn, RwkvState(s=s_end, x_tm=x_tm, x_cm=x_cm)


def rwkv_naive_wkv(r, k, v, logw, u, s0):
    """Sequential oracle for the WKV recurrence.  Shapes as _chunk_wkv."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], logw[:, t]   # (B, H, n)
        kv = kt[..., :, None] * vt[..., None, :]                 # (B, H, n, n)
        att = s + u[None, :, :, None] * kv.to(torch.float32)
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, att.to(rt.dtype)))
        s = torch.exp(wt.to(torch.float32))[..., None] * s \
            + kv.to(torch.float32)
    return torch.stack(outs, dim=1).to(torch.float32), s
