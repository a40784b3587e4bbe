"""DTW similarity search, the paper's §V extension (``repro.core.dtw``):
"no changes are required in the index structure: we can index a dataset
once, and then use this index to answer both Euclidean and DTW
similarity search queries".

The machinery lives in ``core/engine.py`` as the ``DTW(r)`` metric
adapter; this module keeps the public faces:

  * exact banded DTW (``dtw_band``) and the LB_Keogh family
    (``query_envelope``, ``lb_keogh``);
  * the index-level bound ``envelope_block_lb``: envelope-widened region
    MINDIST keeps no-false-dismissal, so the SAME BlockIndex answers DTW
    queries;
  * ``search_dtw``, a ``DTW(r)`` plan on the query-major schedule, and
    ``search_dtw_flat``, the same metric on the ParIS flat scan.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.engine import (DTW, QueryPlan, dtw_band, lb_keogh,  # noqa: F401
                                     query_envelope)
from repro_torch.core.index import BlockIndex, FlatIndex
from repro_torch.core.search import SearchResult


def envelope_block_lb(index: BlockIndex, u_paa: torch.Tensor,
                      l_paa: torch.Tensor) -> torch.Tensor:
    """(Q, B) squared lower bound of DTW against any series in each block:
    the MINDIST between the interval [l_paa, u_paa] and the block envelope
    [elo, ehi]."""
    return engine.interval_planar_lb(u_paa, l_paa, index.elo, index.ehi,
                                     n=index.n)


def search_dtw(index: BlockIndex, queries, *, r: int, k: int = 1,
               blocks_per_iter: int = 2, deadline_blocks: int | None = None,
               device: str | torch.device | None = "cuda") -> SearchResult:
    """Exact DTW k-NN using the unchanged Euclidean BlockIndex, on
    ``device``.

    Pruning is against the k-th best DTW distance so far (squared).  Work
    stats keep DTW's convention (``DTW.finalize_stats``):
    ``series_refined == lb_series == blocks_visited * capacity``.
    ``deadline_blocks`` caps refined blocks per query (None = exact).
    """
    plan = QueryPlan(metric=DTW(r=r), schedule="query_major", k=k,
                     blocks_per_iter=blocks_per_iter,
                     deadline_blocks=deadline_blocks)
    return engine.run(index, queries, plan, device=device)


def search_dtw_flat(index: FlatIndex, queries, *, r: int, k: int = 1,
                    block_index: BlockIndex | None = None,
                    chunk: int = 4096, deadline_blocks: int | None = None,
                    device: str | torch.device | None = "cuda"
                    ) -> SearchResult:
    """Exact DTW k-NN on the ParIS flat schedule (DTW x flat), on
    ``device``: one interval-to-region MINDIST pass over every series,
    then chunked banded-DP refinement under the k-th best bound.
    ``block_index`` (optional, from the same build) enables stage-A
    seeding; ``deadline_blocks`` caps refined CHUNKS (None = exact)."""
    plan = QueryPlan(metric=DTW(r=r), schedule="flat", k=k, chunk=chunk,
                     deadline_blocks=deadline_blocks)
    return engine.run_flat(index, queries, plan, block_index, device=device)
