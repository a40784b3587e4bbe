"""UCR-Suite-style brute-force scan, the paper's serial-scan baseline
(``repro.core.ucr``).

A full batched-L2 sweep over the raw array through the ``batch_l2``
kernel: no lower bounds, no pruning.  It carries the same top-k Frontier
as the index paths, so its (Q, K) result is the exact k-NN answer by
construction, and the tests use it as their oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core import frontier as frontier_lib
from repro_torch.core import isax
from repro_torch.core.frontier import INF, SearchStats
from repro_torch.core.search import SearchResult
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def search_scan(raw, queries, *, k: int = 1, chunk: int = 4096,
                normalize: bool = True, ids: torch.Tensor | None = None,
                device: str | torch.device | None = "cuda") -> SearchResult:
    """Exact k-NN by full scan, on ``device``. raw (N, n); queries (Q, n).

    A host loop over chunks of ``chunk`` series, with no host sync: each
    chunk is z-normalized on its own (z-norm is per series, so this is
    the whole array's z-norm without a second copy of it), measured with
    ``batch_l2`` and folded into the frontier.  The last chunk is ragged
    rather than padded; padding lanes would never enter the top-k.
    """
    dev = resolve_device(device)
    raw = torch.as_tensor(raw, device=dev)
    n_series = raw.shape[0]
    setup = frontier_lib.prepare(torch.as_tensor(queries, device=dev), k,
                                 normalize=normalize)
    q = setup.q
    qn = q.shape[0]
    if ids is None:
        ids = torch.arange(n_series, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)

    c = min(chunk, n_series)
    nchunks = -(-n_series // c)
    front = setup.frontier
    for s in range(0, n_series, c):
        x = raw[s:s + c]
        x = isax.znorm(x) if normalize else x.to(torch.float32)
        ids_k = ids[s:s + c]
        d = torch.where(ids_k[None, :] >= 0, ops.batch_l2(q, x), INF)
        # ids are globally unique and each chunk is seen once, so the
        # duplicate mask is unnecessary on this path
        front = frontier_lib.insert_batch(
            front, d, ids_k[None, :].expand(qn, -1), assume_unique=True)

    stats = SearchStats(
        blocks_visited=torch.full((qn,), nchunks, dtype=torch.int32,
                                  device=dev),
        series_refined=torch.full((qn,), n_series, dtype=torch.int32,
                                  device=dev),
        lb_series=torch.zeros((qn,), dtype=torch.int32, device=dev),
        iters=torch.tensor(nchunks, dtype=torch.int32, device=dev),
    )
    return SearchResult(dist=frontier_lib.result_dists(front),
                        idx=front.ids, stats=stats)
