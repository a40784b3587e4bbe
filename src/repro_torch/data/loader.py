"""Chunked, double-buffered ingestion — the ParIS+ I/O/compute overlap
(``repro.data.loader``).

Paper mapping: the Coordinator thread streams raw series from disk into
the raw-data buffer while IndexBulkLoading workers summarize the previous
batch, and ParIS+'s contribution is that the summarization hides behind
the I/O.  Here the ingress link is host RAM -> device memory and the
overlap comes from CUDA's asynchronous launches: chunk k+1 is read into a
pinned host buffer and its copy to the card enqueued without blocking
(``non_blocking=True``) before chunk k's summarize work is consumed.
``ChunkedLoader`` owns that staging; ``IncrementalBuilder`` is the
bulk-loading worker (one summarize kernel launch per chunk), with the
final sort and partition as the construction stage.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core import isax
from repro_torch.core.index import BlockIndex
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


class ChunkedLoader:
    """Iterate a host dataset in fixed-size chunks with one-chunk prefetch.

    ``source`` is a host ndarray (sliced lazily — the "file"), a callable
    ``(start, stop) -> np.ndarray`` (a reader), or a ``str | Path`` to a
    headerless row-major series file, which is np.memmap'd and needs
    ``length`` (points per series; see storage.format.SeriesStore).  The
    loader keeps at most two chunks in flight: the one the consumer holds
    and the one being staged to ``device`` — the paper's double buffer.
    On the card each chunk goes through one of two reusable pinned host
    buffers, and a buffer is refilled only after its last copy landed.
    """

    def __init__(self, source, n_series: int | None = None, *,
                 chunk: int = 1 << 16,
                 device: str | torch.device | None = "cuda",
                 length: int | None = None, dtype=np.float32):
        if isinstance(source, (str, os.PathLike)):
            if length is None:
                raise ValueError("length required for a file source")
            mm = np.memmap(source, dtype=np.dtype(dtype), mode="r")
            if mm.size % length:
                raise ValueError(f"{source}: size {mm.size} not a multiple "
                                 f"of series length {length}")
            mm = mm.reshape(-1, length)
            self._read = lambda a, b: mm[a:b]
            self.n_series = mm.shape[0] if n_series is None else n_series
        elif callable(source):
            if n_series is None:
                raise ValueError("n_series required for a callable source")
            self._read = source
            self.n_series = n_series
        else:
            self._read = lambda a, b: source[a:b]
            self.n_series = len(source) if n_series is None else n_series
        self.chunk = chunk
        self.device = resolve_device(device)
        self._pinned: list[torch.Tensor] = []    # two staging buffers (card)
        self._copied: list = [None, None]        # each buffer's last copy
        self._slot = 0

    def __len__(self) -> int:
        return (self.n_series + self.chunk - 1) // self.chunk

    def __iter__(self) -> Iterator[torch.Tensor]:
        nxt = self._stage(0)
        for start in range(self.chunk, self.n_series, self.chunk):
            cur, nxt = nxt, self._stage(start)   # enqueue the copy of k+1 ...
            yield cur                            # ... before k is consumed
        yield nxt

    def _stage(self, start: int) -> torch.Tensor:
        stop = min(start + self.chunk, self.n_series)
        host = np.asarray(self._read(start, stop), dtype=np.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(host))
        if not self._pinned:
            n = host.shape[1]
            self._pinned = [torch.empty((self.chunk, n), dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]
        slot, self._slot = self._slot, 1 - self._slot
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()     # its last copy has landed
        buf = self._pinned[slot][:stop - start]
        buf.numpy()[...] = host
        dev = buf.to(self.device, non_blocking=True)   # async: returns now
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._copied[slot] = done
        return dev


def summarize_chunk(chunk: torch.Tensor, *, w: int, card: int,
                    normalize: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One IndexBulkLoading step: (m, n) raw chunk -> (z-normed, sax).

    The single definition of the per-chunk summarize launch, shared by
    ``IncrementalBuilder`` (keeps both) and the pipeline's pass-1 run
    builder (storage/pipeline/runs.py, keeps only the sax words).  It is
    ``core.build``'s own sequence (``isax.znorm``, then
    ``ops.summarize(..., normalize=False)``) and every op is per row, so
    chunking or sharding the input changes no series' summary.
    """
    xn = isax.znorm(chunk) if normalize else chunk.to(torch.float32)
    _, sax = ops.summarize(xn, w=w, card=card, normalize=False)
    return xn, sax


class IncrementalBuilder:
    """ParIS+-style incremental index construction over a chunk stream.

    Per chunk (the IndexBulkLoading stage): z-normalize + summarize (one
    ``isax_summarize`` launch), enqueued asynchronously so it overlaps the
    staging of the next chunk.  ``finalize()`` (the IndexConstruction
    stage) concatenates, sorts by the interleaved iSAX word and cuts
    fixed-capacity blocks; the sort sees the global order, so the result
    is identical to a one-shot ``index.build`` on the full array.
    """

    def __init__(self, *, w: int = isax.W, card: int = isax.CARD,
                 capacity: int = 512, normalize: bool = True):
        self.w, self.card, self.capacity = w, card, capacity
        self.normalize = normalize
        self._raw: list[torch.Tensor] = []
        self._sax: list[torch.Tensor] = []
        self._count = 0

    def add_chunk(self, chunk: torch.Tensor) -> None:
        xn, sax = summarize_chunk(chunk, w=self.w, card=self.card,
                                  normalize=self.normalize)
        self._raw.append(xn)
        self._sax.append(sax)
        self._count += chunk.shape[0]

    def finalize(self) -> BlockIndex:
        if not self._raw:
            raise ValueError("no chunks added")
        raw = torch.cat(self._raw, dim=0)
        sax = torch.cat(self._sax, dim=0)
        return self._assemble(raw, sax)

    def _assemble(self, raw: torch.Tensor, sax: torch.Tensor) -> BlockIndex:
        # index.build's tail, on the precomputed summaries
        n_series, n = raw.shape
        ids = torch.arange(n_series, dtype=torch.int32, device=raw.device)
        order = isax.sort_order(sax, self.w)
        bounds = isax.bounds_from_sax(sax[order], self.card)
        return index_lib.assemble_blocks(
            raw[order], bounds, ids[order], n=n, w=self.w, card=self.card,
            capacity=self.capacity)


def build_streaming(source, *, chunk: int = 1 << 16, capacity: int = 512,
                    w: int = isax.W, card: int = isax.CARD,
                    normalize: bool = True, n_series: int | None = None,
                    device: str | torch.device | None = "cuda"
                    ) -> BlockIndex:
    """End-to-end ParIS+ pipeline on ``device`` (the card unless the
    caller asks for the CPU): overlapped ingest -> summarize -> build."""
    loader = ChunkedLoader(source, n_series, chunk=chunk, device=device)
    builder = IncrementalBuilder(w=w, card=card, capacity=capacity,
                                 normalize=normalize)
    for dev_chunk in loader:
        builder.add_chunk(dev_chunk)
    return builder.finalize()
