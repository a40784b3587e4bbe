"""Generic high-dimensional vector search, the paper's §V application
(``repro.core.vector``): a d-dim embedding is a 'series' of length d.

Z-normalization is OFF (embeddings are not shift/scale invariant);
unit-normalization gives cosine search, since ||a - b||^2 = 2 - 2 cos(a, b)
on the unit sphere, so the exact Euclidean top-k IS the exact cosine top-k.
The preparation is ``engine.prep_vectors`` / the ``Cosine`` metric.
"""
from __future__ import annotations

import torch

from repro_torch.core import index as index_lib
from repro_torch.core.engine import Cosine, prep_vectors  # noqa: F401 (re-export)
from repro_torch.core.index import BlockIndex
from repro_torch.core.search import SearchResult
from repro_torch.core.search import search as _search
from repro_torch.device import resolve_device


def build_vector_index(embs, *, w: int = 16, card: int = 256,
                       capacity: int = 512, unit_norm: bool = True,
                       device: str | torch.device | None = "cuda"
                       ) -> BlockIndex:
    """embs (N, d) with d divisible by w, on ``device``."""
    embs = torch.as_tensor(embs, device=resolve_device(device))
    return index_lib.build(prep_vectors(embs, unit_norm), w=w, card=card,
                           capacity=capacity, normalize=False,
                           device=device)


def search_vectors(index: BlockIndex, queries, *, k: int = 1,
                   unit_norm: bool = True,
                   device: str | torch.device | None = "cuda",
                   **kw) -> SearchResult:
    """Exact k-NN over the vector index. queries (Q, d) -> (Q, K) results,
    on the query-major schedule (a ``Cosine(unit_norm=...)`` plan)."""
    q = prep_vectors(torch.as_tensor(queries, device=resolve_device(device)),
                     unit_norm)
    return _search(index, q, k=k, normalize_queries=False, device=device,
                   **kw)


def cosine_scores(res: SearchResult, dim: int) -> torch.Tensor:
    """(Q, K) cosine similarities from a unit-norm search result,
    descending: the index holds sqrt(dim)-scaled unit vectors, so
    d^2 = dim * (2 - 2 cos).  Empty slots (idx == -1) map to -1."""
    cos = 1.0 - res.dist.to(torch.float32) ** 2 / (2.0 * dim)
    return torch.where(res.idx >= 0, cos, -1.0)
