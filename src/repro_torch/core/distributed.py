"""Sharded index build and the two-round query protocol on
``torch.distributed`` (``repro.core.distributed``).

The paper's worker threads become ranks of a process group.  Every rank is
symmetric: the dataset is range-sharded over the ranks, each rank builds
its own ``BlockIndex`` shard on its own (the paper's "workers process
distinct subtrees ... no need for synchronization"), and query answering
is the two-round shared-frontier protocol, the k-NN generalization of the
paper's shared BSF, around an ``engine.QueryPlan`` (any metric, either
ordered schedule):

  round 1: every rank seeds its approximate top-k frontier (stage A),
           then an ``all_reduce(MIN)`` of the k-th-best distance (one
           scalar a query).  The min over shards of the local k-th best
           bounds the GLOBAL k-th-NN distance from above (one shard
           already holds k candidates at least that good), so it is a
           valid shared pruning threshold on every rank;
  round 2: every rank resumes its round-1 state and runs the exact
           ordered walk seeded with that threshold, producing its local
           top-k; an ``all_gather`` of the (Q, K) frontiers and a merge
           (``frontier.all_gather_merge``) give the same global top-k on
           every rank.

The functions here are SPMD: every rank of ``group`` (None: the default
group) calls them with its own shard and the same queries.  The kernels
run on the index's device; the messages, (Q,) thresholds and (Q, K)
frontiers, travel on the device the group's backend takes
(``frontier.comm_device``: the card for NCCL, the host for gloo), copied
there and back explicitly.  ``search_sharded_ooc`` runs the same two
rounds at the host level over out-of-core shards in one process (one
``storage.SearchSession`` a shard) and needs no collective.

Communication a query batch: one (Q,) all-reduce and one (Q, K) all-gather
(plus the counters' sums), independent of the dataset size.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import engine, ucr
from repro_torch.core import frontier as frontier_lib
from repro_torch.core.frontier import Frontier, SearchStats, comm_device
from repro_torch.core.index import BlockIndex, build
from repro_torch.core.search import SearchResult
from repro_torch.device import resolve_device
from repro_torch.storage.ooc_search import IOStats, OocSearchResult


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced over the group, back on ``t``'s device.  Always a new
    tensor: ``t`` may be a view into a frontier (``threshold()``), which
    an in-place reduce would overwrite."""
    buf = t.to(comm_device(group)).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def _merged(res, group) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-k of every rank's (Q, K) result: (dist, idx)."""
    front = frontier_lib.all_gather_merge(Frontier(res.dist, res.idx), group)
    return front.dists, front.ids


def build_sharded(local_raw, offset: int, *, group=None, w: int = 16,
                  card: int = 256, capacity: int = 512,
                  normalize: bool = True,
                  device: str | torch.device | None = "cuda") -> BlockIndex:
    """This rank's index shard over its own rows (m, n), which are rows
    ``offset .. offset + m`` of the global (N, n) dataset.

    The dataset is range-sharded in rank order: every rank holds N / D
    rows (N divisible by the world size D) and rank r the r-th range,
    checked with one small all-gather.  Each shard's series keep their
    GLOBAL ids, so answers do not depend on the world size.
    """
    dev = resolve_device(device)
    local_raw = torch.as_tensor(local_raw, device=dev)
    shard_n = local_raw.shape[0]
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = torch.tensor([shard_n, offset], dtype=torch.int64,
                        device=comm_device(group))
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    sizes, offsets = torch.stack(parts).cpu().T.tolist()
    n_series = sum(sizes)
    if n_series % world:
        raise ValueError(f"N={n_series} must be divisible by the world "
                         f"size {world}")
    if sizes != [shard_n] * world or offsets != [r * shard_n
                                                 for r in range(world)]:
        raise ValueError(
            f"rank {rank}: the ranks must hold equal ranges in rank order, "
            f"got sizes {sizes} at offsets {offsets}")
    ids = torch.arange(offset, offset + shard_n, dtype=torch.int32,
                       device=dev)
    return build(local_raw, w=w, card=card, capacity=min(capacity, shard_n),
                 normalize=normalize, ids=ids, device=dev)


# a BlockIndex's arrays -> the axis that runs over its blocks
_BLOCK_AXIS = {"raw": 0, "slo": 0, "shi": 0, "elo": 1, "ehi": 1, "ids": 0}


def gather_index(local_index: BlockIndex, *, group=None) -> dict:
    """The whole index of a sharded build, on every rank as host arrays:
    each rank's shard concatenated in rank order along the block axis
    (``interop.ARRAYS``' names and layouts), and "meta" = [n, w, card,
    capacity, n_real summed].  It holds no trace of the world size that
    built it, so ``train.Checkpointer`` saves it on one world size and
    ``index_shard`` cuts it for another (an elastic reshard), as the
    reference's checkpoint of a globally sharded index restores onto a
    mesh of another size."""
    mine = {name: getattr(local_index, name).cpu().numpy()
            for name in _BLOCK_AXIS}
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, (mine, local_index.n_real), group=group)
    out = {name: np.concatenate([p[name] for p, _ in parts], axis=axis)
           for name, axis in _BLOCK_AXIS.items()}
    out["meta"] = np.array([local_index.n, local_index.w, local_index.card,
                            local_index.capacity,
                            sum(n_real for _, n_real in parts)], np.int64)
    return out


def index_shard(arrays: dict, *, group=None,
                device: str | torch.device | None = "cuda") -> BlockIndex:
    """This rank's shard of a whole index (``gather_index``'s arrays, e.g.
    restored from a checkpoint) on ``group``: its blocks split evenly in
    rank order.  The world size must divide the block count.  Ids stay
    global, so ``search_sharded`` over the shards answers as over the
    whole index."""
    dev = resolve_device(device)
    n, w, card, capacity, _ = (int(v) for v in arrays["meta"])
    blocks = arrays["ids"].shape[0]
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if blocks % world:
        raise ValueError(f"{blocks} blocks do not split over {world} ranks")
    per = blocks // world
    part = {name: np.take(arrays[name], range(rank * per, (rank + 1) * per),
                          axis=axis) for name, axis in _BLOCK_AXIS.items()}
    tensors = {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for name, a in part.items()}
    return BlockIndex(**tensors, n=n, w=w, card=card, capacity=capacity,
                      n_real=int((part["ids"] >= 0).sum()))


def search_sharded(local_index: BlockIndex, queries, *, group=None,
                   k: int = 1, blocks_per_iter: int = 4,
                   lb_filter: bool = True,
                   deadline_blocks: int | None = None,
                   schedule: str = "block_major", metric=None,
                   device: str | torch.device | None = "cuda"
                   ) -> SearchResult:
    """Exact global k-NN over every rank's shard; the same (Q, n) queries
    on every rank, the same result on every rank.

    The two-round protocol around an ``engine.QueryPlan``: ``schedule``
    is "block_major" (the batched default) or "query_major" (the
    paper-faithful priority order); ``metric`` overrides the default
    z-normed ``ED(lb_filter=...)`` (``engine.Cosine()`` for a sharded
    vector index built with ``normalize=False``, ``engine.DTW(r)``).
    ``stats`` are summed over ranks (``iters``: the max).
    """
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, device=dev)
    m = engine.ED(lb_filter=lb_filter) if metric is None else metric
    plan = engine.QueryPlan(metric=m, schedule=schedule, k=k,
                            blocks_per_iter=blocks_per_iter,
                            deadline_blocks=deadline_blocks)
    # round 1: local stage A -> the global k-th best
    prep = engine.prepare(m, local_index, queries, k)
    thr_g = _all_reduce(prep.front.threshold(), dist.ReduceOp.MIN, group)
    # round 2: resume round 1 (no second prep, ranking or stage A),
    # seeded with the global threshold
    res = engine.run(local_index, queries, plan, initial_threshold=thr_g,
                     prepared=prep, device=dev)
    dist_g, idx_g = _merged(res, group)
    st = res.stats
    counts = _all_reduce(torch.stack([st.blocks_visited, st.series_refined,
                                      st.lb_series]),
                         dist.ReduceOp.SUM, group)
    stats = SearchStats(blocks_visited=counts[0], series_refined=counts[1],
                        lb_series=counts[2],
                        iters=_all_reduce(st.iters, dist.ReduceOp.MAX,
                                          group))
    return SearchResult(dist=dist_g, idx=idx_g, stats=stats)


def search_sharded_scan(local_raw, offset: int, queries, *, group=None,
                        k: int = 1, chunk: int = 4096,
                        device: str | torch.device | None = "cuda"
                        ) -> SearchResult:
    """Distributed UCR-Suite-p brute force (baseline and oracle): each
    rank scans its rows ``offset .. offset + m``, then the same merge."""
    dev = resolve_device(device)
    local_raw = torch.as_tensor(local_raw, device=dev)
    m = local_raw.shape[0]
    ids = torch.arange(offset, offset + m, dtype=torch.int32, device=dev)
    res = ucr.search_scan(local_raw, queries, k=k, chunk=min(chunk, m),
                          ids=ids, device=dev)
    dist_g, idx_g = _merged(res, group)
    n_series = _all_reduce(torch.tensor(m, dtype=torch.int32, device=dev),
                           dist.ReduceOp.SUM, group)
    qn = idx_g.shape[0]
    zeros = torch.zeros((qn,), dtype=torch.int32, device=dev)
    stats = SearchStats(blocks_visited=zeros,
                        series_refined=n_series.expand(qn).clone(),
                        lb_series=zeros.clone(),
                        iters=torch.zeros((), dtype=torch.int32, device=dev))
    return SearchResult(dist=dist_g, idx=idx_g, stats=stats)


def search_sharded_ooc(sessions: Sequence, queries, *, k: int = 1,
                       lb_filter: bool = True,
                       normalize_queries: bool = True, metric=None,
                       pipeline_depth: int | None = None,
                       group_blocks: int | None = None) -> OocSearchResult:
    """Distributed OUT-OF-CORE exact k-NN: the same two rounds, at the host
    level, over one ``storage.SearchSession`` a shard (disjoint series,
    global ids: e.g. each shard built with ``core.build(..., ids=...)``
    and saved).

    Round 1 runs stage A on every shard (fetching only best-envelope
    blocks) and min-reduces the k-th-best thresholds on the host; round 2
    RESUMES each shard from its ``storage.PreparedRound``, seeded with
    the global bound, so no block is fetched or refined twice a run; the
    per-shard frontiers then merge into the global top-k.  ``stats`` and
    ``io`` are summed over shards; round 1's reads are billed into each
    shard's round-2 ``IOStats``, so ``io.blocks_fetched`` is the
    protocol's whole disk cost.  ``pipeline_depth`` / ``group_blocks``
    forward to every shard's walk (None: each session's own).
    """
    if not sessions:
        raise ValueError("search_sharded_ooc needs at least one session")
    kw = dict(k=k, lb_filter=lb_filter, normalize_queries=normalize_queries,
              metric=metric, pipeline_depth=pipeline_depth,
              group_blocks=group_blocks)
    # round 1: per-shard stage A -> the host min of the thresholds
    preps = [s.approximate_threshold(queries, **kw) for s in sessions]
    thr_g = torch.from_numpy(np.minimum.reduce([p.threshold for p in preps]))
    # round 2: every shard resumed from round 1, seeded with the bound
    results = [s.search(queries, initial_threshold=thr_g, prepared=p, **kw)
               for s, p in zip(sessions, preps)]
    # merge: per-shard frontiers (sqrt domain, disjoint ids) -> global top-k
    front = Frontier(results[0].dist, results[0].idx)
    for r in results[1:]:
        front = frontier_lib.merge(front, Frontier(r.dist, r.idx))
    st = [r.stats for r in results]
    stats = SearchStats(
        blocks_visited=sum(s.blocks_visited for s in st),
        series_refined=sum(s.series_refined for s in st),
        lb_series=sum(s.lb_series for s in st),
        iters=torch.stack([s.iters for s in st]).amax())
    io = IOStats(*(sum(getattr(r.io, f) for r in results)
                   for f in IOStats._fields))
    return OocSearchResult(dist=front.dists, idx=front.ids, stats=stats,
                           io=io)
