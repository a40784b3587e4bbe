"""ParIS/ParIS+-style query answering: the flat SAX-array lower-bound scan
(``repro.core.paris``).

Paper mapping: "lower bound calculation workers compute the lower bound
distances between the query and the iSAX summary of EACH data series in
the dataset (stored in the SAX array), and prune ... the series that are
not pruned are stored in a candidate list, which real distance
calculation workers consume in parallel".  Here the LB scan over the
whole array is one ``lb_scan`` kernel pass, and the candidate list is a
host loop over chunks, each refined with ``batch_l2`` + ``block_topk``
against the running top-k frontier (the ``flat`` schedule of
``engine.run_flat``).  No ordering, no envelopes: the structural contrast
with MESSI (``search.py``) is the paper's.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.engine import ED, QueryPlan
from repro_torch.core.index import BlockIndex, FlatIndex, flat_view
from repro_torch.core.search import SearchResult


def search_flat(index: FlatIndex, queries, *, k: int = 1,
                block_index: BlockIndex | None = None,
                initial_threshold: torch.Tensor | None = None,
                chunk: int = 4096,
                device: str | torch.device | None = "cuda") -> SearchResult:
    """Exact k-NN via the ParIS algorithm, on ``device``. queries (Q, n).

    ``block_index`` (optional) enables the paper's approximate phase:
    stage-A seeding from the best-envelope block; without it the scan
    starts from an empty frontier.
    """
    plan = QueryPlan(metric=ED(), schedule="flat", k=k, chunk=chunk)
    return engine.run_flat(index, queries, plan, block_index,
                           initial_threshold, device=device)


def search_paris(index: BlockIndex, queries, *, k: int = 1,
                 chunk: int = 4096,
                 initial_threshold: torch.Tensor | None = None,
                 device: str | torch.device | None = "cuda") -> SearchResult:
    """The ParIS algorithm against a BlockIndex's flat view, seeded from
    the block index."""
    return search_flat(flat_view(index), queries, k=k, block_index=index,
                       chunk=chunk, initial_threshold=initial_threshold,
                       device=device)
