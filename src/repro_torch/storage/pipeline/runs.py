"""Pass 1 of the build pipeline: sorted summary runs
(``repro.storage.pipeline.runs``).

A *run* is the unit the ParIS+-style parallel bulk loader flushes: one
worker scans a contiguous shard [row_start, row_stop) of the source
``SeriesStore`` through the summarize kernel, locally sorts the shard's
summaries by the bit-interleaved iSAX word, and writes one standalone
``kind="run"`` DSIX file (format.write_arrays — atomic publish):

    keys (K, m) u4   the interleaved sort-key columns, in run order
    sax  (m, w) u2   the iSAX words, in run order
    ids  (m,)   i8   original source row ids, in run order

Runs are self-describing and independent: any subset of them k-way
merges (merge.py) into a global order.

Tie-breaking contract (the byte-identity linchpin): within a run the
local lexsort is STABLE over a shard scanned in source order, so rows
with equal keys appear in ascending source id; the merge breaks
cross-run key ties by source id as well.  Total order = (keys, id) —
identical to one global stable sort, hence to ``isax.sort_order`` on the
whole array.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.core import isax
from repro_torch.data.loader import (ChunkedLoader, IncrementalBuilder,
                                     summarize_chunk)
from repro_torch.storage import format as format_lib
from repro_torch.storage.format import SeriesStore

RUN_KIND = "run"


class SummaryBuilder(IncrementalBuilder):
    """Pass-1 worker state: an IncrementalBuilder that keeps summaries only.

    ``add_chunk`` runs the same znorm + summarize kernel launch, but drops
    the raw and z-normed chunks and keeps the sax words (uint16) and the
    interleaved sort keys (uint32) on the HOST — the summaries-resident
    half of the on-disk architecture: w+16 bytes per series, not 4n.
    """

    def __init__(self, **kw):
        super().__init__(**kw)
        if self.card > (1 << 16):
            raise ValueError("SummaryBuilder stores sax words as uint16; "
                             f"card={self.card} does not fit")
        self._keys: list[tuple[np.ndarray, ...]] = []

    def add_chunk(self, chunk: torch.Tensor) -> None:
        _, sax = summarize_chunk(chunk, w=self.w, card=self.card,
                                 normalize=self.normalize)
        keys = isax.interleaved_keys(sax, self.w)
        self._sax.append(sax.cpu().numpy().astype(np.uint16))
        self._keys.append(tuple(k.cpu().numpy().astype(np.uint32)
                                for k in keys))
        self._count += chunk.shape[0]

    def finalize(self):
        raise NotImplementedError(
            "SummaryBuilder holds no raw data; use the pipeline's pass 2 "
            "(storage/pipeline/driver.py)")

    def key_columns(self) -> tuple[np.ndarray, ...]:
        """The accumulated interleaved-key columns, most significant first."""
        if not self._keys:
            raise ValueError("no chunks added")
        return tuple(np.concatenate([c[i] for c in self._keys])
                     for i in range(len(self._keys[0])))

    def sort_order(self) -> np.ndarray:
        """Block-order permutation == isax.sort_order on the full array."""
        # np.lexsort: the last key is primary; stable ascending, as the
        # chain of stable argsorts in isax.sort_order
        return np.lexsort(tuple(reversed(self.key_columns()))) \
            .astype(np.int64)

    def sax_words(self) -> np.ndarray:
        return np.concatenate(self._sax, axis=0)


def build_run(store: SeriesStore, out_path: str | Path, *,
              row_start: int, row_stop: int, w: int, card: int,
              chunk: int, normalize: bool,
              device: str | torch.device | None = "cuda") -> Path:
    """Scan shard rows [row_start, row_stop) and write one sorted run file.

    Streams the shard through ``ChunkedLoader`` (double-buffered disk ->
    ``device`` staging), then sorts LOCALLY and publishes atomically.
    Thread-safe against other shards' workers: each run has its own
    loader, builder and temp file.
    """
    m = row_stop - row_start
    if m <= 0:
        raise ValueError(f"empty shard [{row_start}, {row_stop})")
    loader = ChunkedLoader(
        lambda a, b: store.read(row_start + a, row_start + b),
        n_series=m, chunk=chunk, device=device)
    builder = SummaryBuilder(w=w, card=card, normalize=normalize)
    for dev_chunk in loader:
        builder.add_chunk(dev_chunk)
    order = builder.sort_order()                      # local, stable
    keys = builder.key_columns()
    arrays = {
        "keys": np.stack([k[order] for k in keys]).astype("<u4"),
        "sax": builder.sax_words()[order].astype("<u2"),
        "ids": (row_start + order).astype("<i8"),
    }
    return format_lib.write_arrays(
        out_path, kind=RUN_KIND, arrays=arrays,
        extra={"rows": [int(row_start), int(row_stop)], "w": w,
               "card": card})


def open_run(path: str | Path) -> tuple[dict, dict]:
    """-> (meta, {keys, sax, ids}) memmaps — streamed by the merge."""
    return format_lib.open_arrays(path, kind=RUN_KIND, mmap=True)
