"""Attention: chunked online-softmax for the teacher-forced forward and the
prefill, plus KV-cache decode (full cache and ring-buffer SWA cache).

The PyTorch counterpart of ``repro.models.attention``, in plain tensor
operations (matmul, softmax pieces, masks) with the reference's
structure:

  * the forward and the prefill never materialise (S, S) scores: a host
    loop over query chunks and an inner loop over KV chunks carry the
    running (max, denominator, accumulator) triple, merged per block;
  * GQA is computed grouped: queries reshaped to (B, S, KV, G, hd), so KV
    is never repeated in memory;
  * ``swa`` attention slices a ``window + Cq`` wide KV span per query
    chunk, O(S·W);
  * the causal path walks only the causally live block pairs, the
    reference's ``triangular=True`` schedule: a query chunk stops at the
    first KV chunk it cannot see.  A fully masked chunk merges to
    nothing, so this gives the values of the reference's rectangle sweep
    too;
  * decode attends one new token against the whole cache, in chunks, with
    a position mask; SWA decode reads a ring buffer of width ``window``.

Decode differs from the reference in one place, on purpose: the
reference's ``decode_attend`` takes ``sk // chunk`` whole chunks and so
never reads the cache slots past the last whole chunk (a 2,208-slot
cache with chunk 1,024 drops slots 2,048..2,207).  Here the last chunk
is ragged and every slot is attended, as the docstring of both promises:
keys at indices > pos are masked and nothing else is.
"""
from __future__ import annotations

import torch

NEG = -1.0e30


def _block_attn(q, k, v, mask, sm_scale):
    """One online-softmax block.

    q (B, Cq, KV, G, hd); k, v (B, Ck, KV, hd); mask broadcastable to
    (B, KV, G, Cq, Ck), bool.  Returns (scores_max (..., Cq), exp_sum,
    weighted_v) with leading dims (B, KV, G).
    """
    s = torch.einsum("bqkgh,bckh->bkgqc", q, k) * sm_scale
    s = torch.where(mask, s, NEG)
    m = torch.amax(s, dim=-1)                                  # (B,KV,G,Cq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype), v)
    return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def div_chunk(s: int, want: int) -> int:
    """Largest divisor of ``s`` that is <= ``want``."""
    c = min(want, s)
    while s % c:
        c -= 1
    return c


def _init_state(b, kvh, g, cq, hd, device):
    return (torch.full((b, kvh, g, cq), NEG, dtype=torch.float32,
                       device=device),
            torch.zeros((b, kvh, g, cq), dtype=torch.float32, device=device),
            torch.zeros((b, kvh, g, cq, hd), dtype=torch.float32,
                        device=device))


def _finish(l, o, dtype):
    """(B, KV, G, Cq, hd) accumulator -> (B, Cq, KV, G, hd) output."""
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, chunk: int = 512,
           q_offset: int = 0, sm_scale: float | None = None
           ) -> torch.Tensor:
    """Chunked attention.  q (B, Sq, H, hd); k, v (B, Sk, KVH, hd).

    ``q_offset``: absolute position of q[0] relative to k[0].
    ``window > 0`` = sliding-window (causal implied).  The chunk is the largest divisor of each length not above ``chunk``,
    as in the reference.  Returns (B, Sq, H, hd), q.dtype.
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    cq = div_chunk(sq, chunk)
    ck = div_chunk(sk, chunk)
    nq, nk = sq // cq, sk // ck
    qg = q.reshape(b, sq, kvh, g, hd)

    if window:
        return _attend_swa(qg, k, v, window=window, cq=cq,
                           q_offset=q_offset, scale=scale
                           ).reshape(b, sq, h, hd)

    dev = q.device
    outs = []
    for iq in range(nq):
        qi = qg[:, iq * cq:(iq + 1) * cq]
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        m0, l0, o0 = _init_state(b, kvh, g, cq, hd, dev)
        for ik in range(nk):
            if causal and ik * ck >= q_offset + (iq + 1) * cq:
                break                   # this and later chunks: all masked
            ki = k[:, ik * ck:(ik + 1) * ck]
            vi = v[:, ik * ck:(ik + 1) * ck]
            if causal:
                kpos = ik * ck + torch.arange(ck, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
            else:
                mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            m2, l2, o2 = _block_attn(qi, ki, vi, mask, scale)
            m0, l0, o0 = _merge(m0, l0, o0, m2, l2, o2)
        outs.append(_finish(l0, o0, q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd)


def _attend_swa(qg, k, v, *, window: int, cq: int, q_offset: int, scale):
    """Sliding-window attention: per query chunk, one KV span of width
    ``min(window + cq, Sk)`` starting at the earliest key any query of the
    chunk may see (clamped into the keys)."""
    b, sq, kvh, g, hd = qg.shape
    sk = k.shape[1]
    nq = sq // cq
    span = min(window + cq, sk)
    dev = qg.device
    outs = []
    for iq in range(nq):
        qi = qg[:, iq * cq:(iq + 1) * cq]
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        start = min(max(q_offset + iq * cq - window + 1, 0), sk - span)
        ki = k[:, start:start + span]
        vi = v[:, start:start + span]
        kpos = start + torch.arange(span, device=dev)
        mask = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window))
        _, l, o = _block_attn(qi, ki, vi, mask, scale)
        outs.append(_finish(l, o, qg.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, kvh * g, hd)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar position (int or 0-d tensor) or (B,) positions -> (B,) int64."""
    return torch.as_tensor(pos, device=device).to(torch.int64).expand(b)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos, *, window: int = 0,
                  chunk: int = 1024, sm_scale: float | None = None
                  ) -> torch.Tensor:
    """One-token decode. q (B, 1, H, hd); caches (B, S, KVH, hd).

    ``pos`` (int, scalar tensor or (B,)): index of the NEW token; keys at
    indices > pos are masked.  For ``window > 0`` the cache is a ring
    buffer of width ``window`` written at ``pos % window``; the mask
    handles the wrap-around.  The cache is read in chunks of ``chunk``
    slots, the last one ragged, partials merged by their log-sum-exp.
    """
    b, _, h, hd = q.shape
    sk, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    ck = min(chunk, sk)
    dev = q.device
    qg = q.reshape(b, 1, kvh, g, hd)
    posv = _pos_vector(pos, b, dev)
    m0, l0, o0 = _init_state(b, kvh, g, 1, hd, dev)
    for lo in range(0, sk, ck):
        hi = min(lo + ck, sk)
        slot = torch.arange(lo, hi, device=dev)
        if window:
            # slot s holds absolute position p iff p % window == s and
            # pos - window < p <= pos
            age = torch.remainder(posv[:, None] - slot[None, :], window)
            abs_pos = posv[:, None] - age
            valid = (abs_pos >= 0) & (abs_pos <= posv[:, None])
        else:
            valid = slot[None, :] <= posv[:, None]
        mask = valid[:, None, None, None, :]                    # (B,1,1,1,Ck)
        m2, l2, o2 = _block_attn(qg, k_cache[:, lo:hi], v_cache[:, lo:hi],
                                 mask, scale)
        m0, l0, o0 = _merge(m0, l0, o0, m2, l2, o2)
    return _finish(l0, o0, q.dtype).reshape(b, 1, h, hd)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos, *,
                 window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one new token's K/V (B, 1, KVH, hd) at position ``pos`` (ring
    slot ``pos % window`` if SWA).  Unlike the reference, which returns
    new arrays, the caches are written in place (a decode step then moves
    one token's K/V, not the cache) and returned."""
    b = k_new.shape[0]
    posv = _pos_vector(pos, b, k_cache.device)
    slot = torch.remainder(posv, window) if window else posv
    rows = torch.arange(b, device=k_cache.device)
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
