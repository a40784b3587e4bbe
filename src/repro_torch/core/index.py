"""Block index construction — the in-memory ParIS/MESSI index.

The pointer-based iSAX tree of the paper becomes a two-level flat structure:

  level 1: fixed-capacity *blocks* (= leaves), formed by sorting series by
           their bit-interleaved iSAX word (the breadth-first tree order) and
           cutting the sorted sequence every ``capacity`` series;
  level 2: per-block *envelopes* (= leaf iSAX summaries): segment-wise
           [min lo, max hi] over the member series' symbol regions.

The envelope contains every member's region, so the envelope MINDIST is
<= every member's MINDIST <= the true distance: no false dismissals.
The raw series are permuted into block order so refinement reads one
contiguous (C, n) panel per block, and the per-series bounds are stored
planar (w, C) so the lower-bound kernels read them coalesced.

The layout, pads and sentinels are those of ``repro.core.index``, so an
index converts between the two packages array for array
(``repro_torch.interop``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

RAW_PAD = 1.0e4   # pad-series point value: squared distance >> any real one


class HostRawBlocks:
    """Host-side raw blocks of an index opened out-of-core.

    Wraps the (B, C, n) raw section of a persisted index, normally an
    ``np.memmap`` over the index file, so the cached walk
    (``storage.cache``) can fetch one block at a time while only the
    summaries and envelopes live on the device.
    """

    def __init__(self, blocks, path: str | None = None):
        self.blocks = blocks
        self.path = path

    @property
    def dtype(self) -> np.dtype:
        """On-disk dtype of the raw series (I/O accounting derives the
        itemsize from this, not from an assumed float32)."""
        return np.dtype(self.blocks.dtype)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one (C, n) raw block as stored on disk."""
        _, c, n = self.blocks.shape
        return c * n * self.dtype.itemsize

    def fetch(self, block_id: int) -> np.ndarray:
        """Read one (C, n) block into a fresh host array (the disk I/O).

        Called from the block cache's reader threads: read-only memmap
        slicing plus a fresh-array copy, so concurrent calls are safe.
        """
        return np.array(self.blocks[block_id])


@dataclasses.dataclass(frozen=True)
class BlockIndex:
    """The in-memory index, every tensor on one device."""
    raw: torch.Tensor   # (B, C, n) f32   z-normed series, block order, padded
    slo: torch.Tensor   # (B, w, C) f32   per-series region lower bounds
    shi: torch.Tensor   # (B, w, C) f32   per-series region upper bounds
    elo: torch.Tensor   # (w, B)  f32     block envelope lower bounds (planar)
    ehi: torch.Tensor   # (w, B)  f32     block envelope upper bounds (planar)
    ids: torch.Tensor   # (B, C) int32    original series ids (-1 = padding)
    n: int              # series length
    w: int
    card: int
    capacity: int
    n_real: int         # number of non-padding series
    # Out-of-core hook: set by storage.open_index, which leaves ``raw`` as
    # a zero-width (B, 0, n) placeholder and keeps the real blocks on
    # disk.  The in-memory search paths refuse such an index; the cached
    # walk (storage.ooc_search) streams blocks through HostRawBlocks.fetch.
    host_raw: HostRawBlocks | None = None

    @property
    def n_blocks(self) -> int:
        return self.raw.shape[0]

    @property
    def device(self) -> torch.device:
        return self.raw.device

    @property
    def device_resident(self) -> bool:
        """True when the raw series are on the device (the in-memory paths)."""
        return self.raw.shape[1] == self.capacity


def require_device_resident(index: BlockIndex) -> None:
    """Refuse an index opened out-of-core on an in-memory path."""
    if not index.device_resident:
        raise ValueError(
            "index raw series are not device-resident (opened out-of-core "
            "via storage.open_index); use storage.ooc_search or a "
            "storage.SearchSession, or storage.load_index for the "
            "in-memory paths")


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """ParIS view: the SAX-array scan needs no blocks, just planar bounds."""
    raw: torch.Tensor   # (Np, n) f32
    lo: torch.Tensor    # (w, Np) f32
    hi: torch.Tensor    # (w, Np) f32
    ids: torch.Tensor   # (Np,) int32 (-1 = padding)
    n: int
    w: int
    card: int
    n_real: int

    @property
    def device(self) -> torch.device:
        return self.raw.device


def block_layout(n_series: int, capacity: int) -> tuple[int, int, int]:
    """-> (cap, n_blocks, n_padded): how N series cut into fixed-capacity
    blocks."""
    cap = min(capacity, n_series)
    n_padded = n_series + (-n_series) % cap
    return cap, n_padded // cap, n_padded


def build(raw, *, w: int = isax.W, card: int = isax.CARD,
          capacity: int = 512, normalize: bool = True,
          ids: torch.Tensor | None = None,
          device: str | torch.device | None = "cuda") -> BlockIndex:
    """Build the block index from raw series (N, n), numpy or tensor, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, device=dev)
    n_series, n = raw.shape
    if ids is None:
        ids = torch.arange(n_series, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)

    xn = isax.znorm(raw) if normalize else raw.to(torch.float32)
    _, sax = ops.summarize(xn, w=w, card=card, normalize=False)
    order = isax.sort_order(sax, w)
    bounds = isax.bounds_from_sax(sax[order], card)           # (N, w, 2)
    del sax
    return assemble_blocks(xn[order], bounds, ids[order],
                           n=n, w=w, card=card, capacity=capacity)


def block_envelopes(slo: torch.Tensor, shi: torch.Tensor,
                    ids_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block envelopes from per-series bounds. -> (elo, ehi), (w, B).

    slo/shi (B, w, C), ids_b (B, C).  Pad members are identified by id < 0,
    NOT by sentinel values: a REAL series in the top (or bottom) symbol
    region legitimately carries a +/-SENTINEL edge, and excluding it would
    shrink the envelope below a member's region — a false dismissal.
    Blocks that are pure padding get a sentinel envelope (never selected).
    """
    real = (ids_b >= 0)[:, None, :]                           # (B, 1, C)
    elo = torch.where(real, slo, isax.SENTINEL).amin(dim=2).T     # (w, B)
    ehi = torch.where(real, shi, -isax.SENTINEL).amax(dim=2).T    # (w, B)
    any_real = (ids_b >= 0).any(dim=1)[None, :]                # (1, B)
    elo = torch.where(any_real, elo, isax.SENTINEL).contiguous()
    ehi = torch.where(any_real, ehi, isax.SENTINEL).contiguous()
    return elo, ehi


def assemble_blocks(xn: torch.Tensor, bounds: torch.Tensor, ids: torch.Tensor,
                    *, n: int, w: int, card: int, capacity: int) -> BlockIndex:
    """Cut iSAX-sorted series into fixed-capacity blocks (+ envelopes).

    Inputs are already in sorted (tree) order.
    """
    n_series = xn.shape[0]
    dev = xn.device
    cap, b, n_padded = block_layout(n_series, capacity)
    pad = n_padded - n_series
    if pad:
        xn = torch.cat(
            [xn, torch.full((pad, n), RAW_PAD, dtype=torch.float32,
                            device=dev)], dim=0)
        bounds = torch.cat(
            [bounds, torch.full((pad, w, 2), isax.SENTINEL,
                                dtype=torch.float32, device=dev)], dim=0)
        ids = torch.cat(
            [ids, torch.full((pad,), -1, dtype=torch.int32, device=dev)])

    raw_b = xn.reshape(b, cap, n)
    bounds_b = bounds.reshape(b, cap, w, 2)
    slo = bounds_b[..., 0].permute(0, 2, 1).contiguous()     # (B, w, C)
    shi = bounds_b[..., 1].permute(0, 2, 1).contiguous()
    ids_b = ids.reshape(b, cap).contiguous()
    elo, ehi = block_envelopes(slo, shi, ids_b)

    return BlockIndex(raw=raw_b.contiguous(), slo=slo, shi=shi, elo=elo,
                      ehi=ehi, ids=ids_b, n=n, w=w, card=card, capacity=cap,
                      n_real=n_series)


def flat_view(index: BlockIndex) -> FlatIndex:
    """Reinterpret the block index as a ParIS-style flat SAX array.  The
    raw series and ids are views; the planar bounds are one (w, B*C) copy
    each."""
    require_device_resident(index)
    b, c, n = index.raw.shape
    w = index.w
    lo = index.slo.permute(1, 0, 2).reshape(w, b * c).contiguous()
    hi = index.shi.permute(1, 0, 2).reshape(w, b * c).contiguous()
    return FlatIndex(raw=index.raw.reshape(b * c, n), lo=lo, hi=hi,
                     ids=index.ids.reshape(b * c), n=index.n, w=w,
                     card=index.card, n_real=index.n_real)


def build_flat(raw, *, w: int = isax.W, card: int = isax.CARD,
               normalize: bool = True,
               device: str | torch.device | None = "cuda") -> FlatIndex:
    """Build only the ParIS flat SAX array (no sort, as in the paper), on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, device=dev)
    n_series, n = raw.shape
    xn = isax.znorm(raw) if normalize else raw.to(torch.float32)
    _, sax = ops.summarize(xn, w=w, card=card, normalize=False)
    bounds = isax.bounds_from_sax(sax, card)                  # (N, w, 2)
    return FlatIndex(raw=xn, lo=bounds[..., 0].T.contiguous(),
                     hi=bounds[..., 1].T.contiguous(),
                     ids=torch.arange(n_series, dtype=torch.int32, device=dev),
                     n=n, w=w, card=card, n_real=n_series)
