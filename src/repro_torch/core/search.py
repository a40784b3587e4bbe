"""MESSI-style exact k-NN query answering — the Euclidean face of the
engine (``repro.core.search``).

  Stage A  "search the tree for the query's leaf, compute real distances
           in it, store the minimum in BSF"       -> ``engine.prepare``
  Stage C  surviving leaves refined in lower-bound order under the
           k-th-best bound                        -> the ``block_major``
           schedule (each block once, suffix-min stopping table)
  per-series lower-bound filtering inside a leaf  -> the fused kernel of
           ``ED.panel_topk``
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.engine import ED, QueryPlan
from repro_torch.core.frontier import SearchStats
from repro_torch.core.index import BlockIndex


class SearchResult(NamedTuple):
    dist: torch.Tensor           # (Q, K) exact k-NN distances, ascending
    idx: torch.Tensor            # (Q, K) original ids; -1 = fewer than K real
    stats: SearchStats

    @property
    def nn_dist(self) -> torch.Tensor:
        """(Q,) nearest-neighbour distance (the k=1 column)."""
        return self.dist[..., 0]

    @property
    def nn_idx(self) -> torch.Tensor:
        """(Q,) nearest-neighbour id (the k=1 column)."""
        return self.idx[..., 0]


def search_block_major(index: BlockIndex, queries, *, k: int = 1,
                       lb_filter: bool = True,
                       initial_threshold: torch.Tensor | None = None,
                       deadline_blocks: int | None = None,
                       normalize_queries: bool = True,
                       device: str | torch.device | None = "cuda"
                       ) -> SearchResult:
    """Exact k-NN with the block-major schedule, on ``device`` (the card
    unless the caller asks for the CPU).

    Blocks are visited once each, in ascending min-over-queries lower-bound
    order; every visit is one (Q, C) panel against all still-active
    queries.  ``initial_threshold`` tightens the pruning bound (squared
    distance); ``deadline_blocks`` caps the walk (an anytime answer).
    """
    plan = QueryPlan(metric=ED(normalize=normalize_queries,
                               lb_filter=lb_filter),
                     schedule="block_major", k=k,
                     deadline_blocks=deadline_blocks)
    return engine.run(index, queries, plan, initial_threshold, device=device)
