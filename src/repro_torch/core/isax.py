"""iSAX representation: PAA, symbols, region bounds, and lower-bound distances.

The PyTorch counterpart of ``repro.core.isax`` (Shieh & Keogh's iSAX as
used by ParIS/ParIS+/MESSI):
  * series are z-normalized,
  * PAA with ``w`` equal-length segments (paper fixes w=16),
  * symbols drawn from equiprobable N(0,1) regions (cardinality 256),
  * MINDIST lower bound:  LB(q, S)^2 = (n/w) * sum_seg max(0, lo-q, q-hi)^2.

Alongside the symbols the index keeps the decompressed region envelope
``bounds[..., 2]`` so the lower-bound kernels are plain arithmetic with
no gathers.  Region sentinels are large-but-finite so f32 arithmetic
stays inf/nan-free.  The breakpoint tables are scipy's float32 values,
computed on the host and moved to the device, so both packages (and the
CUDA kernels) quantize against the same bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Paper-fixed defaults.
W = 16          # number of PAA segments
CARD = 256      # per-segment cardinality (8 bits)
SENTINEL = 1.0e9  # finite stand-in for +/- infinity region edges


@functools.lru_cache(maxsize=None)
def breakpoints(card: int = CARD) -> np.ndarray:
    """The card-1 equiprobable N(0,1) breakpoints, ascending. float32."""
    from scipy.stats import norm   # here: its import takes seconds
    qs = np.arange(1, card) / card
    return norm.ppf(qs).astype(np.float32)


@functools.lru_cache(maxsize=None)
def region_tables(card: int = CARD) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) value tables indexed by symbol; edges use finite sentinels."""
    bps = breakpoints(card)
    lo = np.concatenate([[-SENTINEL], bps]).astype(np.float32)   # lo[s] = bps[s-1]
    hi = np.concatenate([bps, [SENTINEL]]).astype(np.float32)    # hi[s] = bps[s]
    return lo, hi


@functools.lru_cache(maxsize=None)
def breakpoints_on(card: int, device: torch.device) -> torch.Tensor:
    """``breakpoints(card)`` as a (card-1,) f32 tensor on ``device``."""
    return torch.from_numpy(breakpoints(card)).to(device)


@functools.lru_cache(maxsize=None)
def _region_tables_on(card: int, device: torch.device):
    lo, hi = region_tables(card)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


ZNORM_ROWS = 1 << 20   # rows a step of znorm: bounds its temporaries


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order, keepdim: the two halves
    added elementwise, log2(n) times (zero-padded to a power of two)."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x


def _znorm_rows(x: torch.Tensor, eps: float) -> torch.Tensor:
    n = x.shape[-1]
    d = x - _row_sum(x) / n
    sd = torch.sqrt(_row_sum(d * d) / n)
    return d / torch.clamp(sd, min=eps)


def znorm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize each series along the last axis (population std).

    The mean and the variance are sums in one fixed pairwise order of
    elementwise adds (``_row_sum``), not a library reduction: on the card
    a reduction's order changes with the number of rows a call holds (a
    call of a few rows rounds differently from one of millions).  So a
    row's bits depend on its own values only, and the build pipeline,
    which z-normalizes row ranges, writes the bits ``core.build`` writes
    from one call over every row.  Rows go ``ZNORM_ROWS`` at a time.
    """
    if x.ndim != 2 or x.shape[0] <= ZNORM_ROWS:
        return _znorm_rows(x, eps)
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], ZNORM_ROWS):
        out[i:i + ZNORM_ROWS] = _znorm_rows(x[i:i + ZNORM_ROWS], eps)
    return out


def paa(x: torch.Tensor, w: int = W) -> torch.Tensor:
    """Piecewise Aggregate Approximation: mean over n/w windows. (..., n) -> (..., w)."""
    n = x.shape[-1]
    if n % w:
        raise ValueError(f"series length {n} not divisible by w={w}")
    return torch.mean(x.reshape(*x.shape[:-1], w, n // w), dim=-1)


def sax_from_paa(paa_vals: torch.Tensor, card: int = CARD) -> torch.Tensor:
    """Quantize PAA values into symbols [0, card): the count of breakpoints
    <= the value.  The table is ascending, so a right-sided searchsorted
    gives exactly ``sum(paa >= bps)`` without the (..., card) intermediate."""
    bps = breakpoints_on(card, paa_vals.device)
    return torch.searchsorted(bps, paa_vals.contiguous(),
                              right=True).to(torch.int32)


def bounds_from_sax(sax: torch.Tensor, card: int = CARD) -> torch.Tensor:
    """Decompress symbols into their region [lo, hi]. (..., w) -> (..., w, 2)."""
    lo_t, hi_t = _region_tables_on(card, sax.device)
    s = sax.long()
    return torch.stack([lo_t[s], hi_t[s]], dim=-1)


def summarize(x: torch.Tensor, w: int = W, card: int = CARD,
              normalize: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """znorm -> (paa, sax, bounds) for a batch of series (..., n)."""
    if normalize:
        x = znorm(x)
    p = paa(x, w)
    s = sax_from_paa(p, card)
    return p, s, bounds_from_sax(s, card)


def paa_lb_sq(q_paa: torch.Tensor, s_paa: torch.Tensor, n: int
              ) -> torch.Tensor:
    """Squared PAA lower bound (n/w)*||q_paa - s_paa||^2 (tighter than
    MINDIST)."""
    w = q_paa.shape[-1]
    d = q_paa - s_paa
    return (n / w) * torch.sum(d * d, dim=-1)


def mindist_paa_bounds_sq(q_paa: torch.Tensor, bounds: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Squared MINDIST between query PAA (..., w) and region bounds (..., w, 2)."""
    lo = bounds[..., 0]
    hi = bounds[..., 1]
    d = torch.clamp(torch.maximum(lo - q_paa, q_paa - hi), min=0.0)
    w = q_paa.shape[-1]
    return (n / w) * torch.sum(d * d, dim=-1)


# ---------------------------------------------------------------------------
# iSAX word ordering: one sort by the bit-interleaved iSAX word (MSB of every
# segment first, then the next bit, ...) clusters exactly like a
# breadth-first iSAX tree.
# ---------------------------------------------------------------------------

def interleaved_keys(sax: torch.Tensor, w: int = W, bits: int = 8
                     ) -> tuple[torch.Tensor, ...]:
    """Pack the bit-interleaved iSAX word of each series into sort keys.

    sax: (..., w) int symbols (bits-wide).  Returns ceil(w*bits/32) keys,
    most-significant first, each holding a uint32 value widened to int64
    (torch's uint32 support is partial).
    """
    if w > 32:
        raise ValueError("w > 32 unsupported")
    per_key = max(1, 32 // w)           # bit-levels per 32-bit key
    s = sax.long()
    keys = []
    for k0 in range(0, bits, per_key):
        key = torch.zeros(sax.shape[:-1], dtype=torch.int64, device=sax.device)
        levels = min(per_key, bits - k0)
        for j in range(levels):
            level = k0 + j              # bit level (0 = MSB)
            bit = (s >> (bits - 1 - level)) & 1
            for seg in range(w):
                shift = (levels - 1 - j) * w + (w - 1 - seg)
                key = key | (bit[..., seg] << shift)
        keys.append(key)
    return tuple(keys)


def sort_order(sax: torch.Tensor, w: int = W, bits: int = 8) -> torch.Tensor:
    """Permutation sorting series (N, w) by their bit-interleaved iSAX word.

    A stable sort per key from the least significant upward: series with
    equal words keep input order, as ``jnp.lexsort`` does.
    """
    keys = interleaved_keys(sax, w, bits)
    perm = torch.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm
