"""Out-of-core exact k-NN over an opened index file
(``repro.storage.ooc_search``).

The ParIS+ query answering architecture: iSAX summaries and block
envelopes live on the device, raw series stay on disk.  Per query batch:

  1. one envelope lower-bound kernel pass ranks every block;
  2. stage A seeds the shared top-k ``Frontier`` from each query's
     best-envelope block (those blocks are fetched — the only raw I/O a
     fully-pruned query ever costs);
  3. the block-major schedule runs at the host level: blocks in
     ascending min-over-queries lower-bound order, each surviving block
     refined by the shared ``engine.panel_refine``; the suffix-min
     stopping rule ends the walk as soon as no later block can improve
     any query's top-k.

The walk itself is ``core.engine.run_cached`` driven by a
``storage.cache.SearchSession``: every raw read — fetches and the
threshold-speculative prefetches alike — goes through a ``BlockCache``
(an id-keyed LRU of device-resident blocks behind a pool of reader
threads), so disk reads overlap device compute.  The walk is
metric-generic: ``metric=engine.DTW(r)`` is out-of-core DTW,
``metric=engine.Cosine()`` serves embeddings.  ``ooc_search`` below is
the one-shot form: a throwaway session with a small cache.

``IOStats.bytes_read`` against ``bytes_scan`` is the measurable form of
the paper's pruning claim: an indexed query answers exactly while
reading a small fraction of the raw bytes a scan would.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.frontier import SearchStats
from repro_torch.core.index import BlockIndex


class IOStats(NamedTuple):
    """Raw-byte I/O accounting for one out-of-core query batch."""
    bytes_read: int       # raw bytes actually fetched off disk
    bytes_scan: int       # raw bytes a full scan would read
                          #   (n_real * n * raw itemsize)
    blocks_fetched: int   # disk block reads (each block at most once/batch)
    blocks_total: int
    cache_hits: int = 0   # surviving blocks served from the device cache
    blocks_refined: int = 0  # distinct blocks the walk actually refined;
                             # fetched + hits - refined = speculative
                             # reads the threshold pruned before use

    @property
    def read_fraction(self) -> float:
        """bytes_read / bytes_scan — the pruning ratio, in bytes."""
        return self.bytes_read / max(self.bytes_scan, 1)


class OocSearchResult(NamedTuple):
    """The leading fields of search.SearchResult, plus I/O accounting;
    tensors on the index's device."""
    dist: torch.Tensor    # (Q, K) exact k-NN distances, ascending
    idx: torch.Tensor     # (Q, K) original ids; -1 = fewer than K real
    stats: SearchStats
    io: IOStats

    @property
    def nn_dist(self) -> torch.Tensor:
        return self.dist[..., 0]

    @property
    def nn_idx(self) -> torch.Tensor:
        return self.idx[..., 0]


def ooc_search(index: BlockIndex, queries, *, k: int = 1,
               lb_filter: bool = True, normalize_queries: bool = True,
               cache_blocks: int = 4, metric=None,
               pipeline_depth: int = 1, group_blocks: int = 1,
               readers: int = 2, telemetry: dict | None = None,
               device: str | torch.device | None = "cuda"
               ) -> OocSearchResult:
    """Exact k-NN for (Q, n) queries against an index opened out-of-core
    on ``device`` (the card unless the caller asks for the CPU).

    ``index`` must come from ``storage.open_index`` (or
    ``build_on_disk``): summaries on the device, raw behind
    ``index.host_raw``.  Result dist/idx are those of the in-memory
    block-major search on the same data — the streaming changes what is
    read, never what is answered.  ``metric`` picks the plan's metric
    (default ED).

    ``pipeline_depth`` / ``group_blocks`` / ``readers`` tune the walk
    (speculative reads in flight / blocks a dispatch / reader threads);
    every setting answers bit-identically (``engine.run_cached``).
    ``cache_blocks`` is raised to the ``pipeline_depth + group_blocks``
    floor the session requires.  The session and its cache live only for
    this call; hold a ``SearchSession`` to serve repeated traffic warm.
    ``telemetry`` (optional dict) receives the walk's host-side counters
    (``SearchSession.last_telemetry``) and the cache's ``demand_misses``.
    """
    from repro_torch.storage.cache import SearchSession
    with SearchSession(index,
                       cache_blocks=max(cache_blocks,
                                        pipeline_depth + group_blocks),
                       readers=readers, pipeline_depth=pipeline_depth,
                       group_blocks=group_blocks, device=device) as session:
        res = session.search(queries, k=k, lb_filter=lb_filter,
                             normalize_queries=normalize_queries,
                             metric=metric)
        if telemetry is not None:
            telemetry.update(session.last_telemetry,
                             demand_misses=session.cache.demand_misses)
        return res
