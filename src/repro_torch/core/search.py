"""MESSI-style exact k-NN query answering — the Euclidean face of the
engine (``repro.core.search``).

  Stage A  "search the tree for the query's leaf, compute real distances
           in it, store the minimum in BSF"       -> ``engine.prepare``
  Stage C  "surviving leaves go into priority queues ordered by lower
           bound; workers pop, stop a queue when its head's LB >= BSF"
                                                  -> the ``query_major``
           schedule (``search``); ``block_major`` is the batched order
           (each block once, suffix-min stopping table)
  per-series lower-bound filtering inside a leaf  -> ``ED(lb_filter=True)``
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.engine import ED, QueryPlan
from repro_torch.core.frontier import Frontier, SearchStats
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


def refine_panel(q: torch.Tensor, q_paa: torch.Tensor, front: Frontier,
                 stats: SearchStats, block: torch.Tensor, ids_b: torch.Tensor,
                 lo: torch.Tensor | None, hi: torch.Tensor | None,
                 active: torch.Tensor, thr: torch.Tensor, *, n: int, w: int,
                 lb_filter: bool) -> tuple[Frontier, SearchStats]:
    """The ED specialization of ``engine.panel_refine``."""
    qs = engine.QueryState(q=q, aux=(q_paa,))
    return engine.panel_refine(ED(lb_filter=lb_filter), qs, front, stats,
                               block, ids_b, lo, hi, active, thr, n=n, w=w)


def search(index: BlockIndex, queries, *, k: int = 1,
           blocks_per_iter: int = 4, lb_filter: bool = True,
           initial_threshold: torch.Tensor | None = None,
           deadline_blocks: int | None = None,
           normalize_queries: bool = True,
           device: str | torch.device | None = "cuda") -> SearchResult:
    """Exact k-NN with the paper's query-major schedule, on ``device``.

    Each query refines its own next-best ``blocks_per_iter`` blocks per
    trip, until every query's next block lower bound reaches its k-th
    best distance.  ``initial_threshold`` tightens the pruning bound
    (squared distance); ``deadline_blocks`` caps the refined blocks per
    query (an anytime answer); ``normalize_queries=False`` is the
    prepared-vector path (``core.vector``).
    """
    plan = QueryPlan(metric=ED(normalize=normalize_queries,
                               lb_filter=lb_filter),
                     schedule="query_major", k=k,
                     blocks_per_iter=blocks_per_iter,
                     deadline_blocks=deadline_blocks)
    return engine.run(index, queries, plan, initial_threshold, device=device)


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
