"""Shared top-k frontier: the k-NN generalization of the best-so-far.

ParIS+ and MESSI answer exact k-NN queries: every worker keeps k
best-so-far answers and prunes against the k-th best distance.  This is
that structure as a fixed-size, per-query, always-sorted (distance, id)
table of tensors.

Invariants (as in ``repro.core.frontier``):
  * rows are sorted ascending by (distance, id) — ties break toward the
    smaller id;
  * ids are unique per row; empty slots are (INF, -1);
  * ``threshold()`` (the k-th best distance) only ever decreases, so
    pruning with ``lb >= threshold()`` keeps the no-false-dismissal
    guarantee for every k.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import isax
from repro_torch.core.index import require_device_resident
from repro_torch.kernels import ops, ref

# float32 max, not inf: f32 arithmetic on empty slots stays finite.  The
# same value as ref.INF, defined here too because importing ref first
# imports this module while ref is still initializing.
INF = float(torch.finfo(torch.float32).max)


class SearchStats(NamedTuple):
    """Work counters, per query — the quantities behind the paper's Fig. 9/12."""
    blocks_visited: torch.Tensor    # (Q,) envelopes that survived pruning & were refined
    series_refined: torch.Tensor    # (Q,) real-distance computations performed
    lb_series: torch.Tensor         # (Q,) per-series lower bounds computed
    iters: torch.Tensor             # () walk trips (shared)


def stats_init(qn: int, device: torch.device) -> SearchStats:
    def zeros(shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return SearchStats(blocks_visited=zeros((qn,)), series_refined=zeros((qn,)),
                       lb_series=zeros((qn,)), iters=zeros(()))


class Frontier(NamedTuple):
    """Per-query top-k result set. dists/ids (Q, K), ascending by (dist, id)."""
    dists: torch.Tensor   # (Q, K) f32 squared distances
    ids: torch.Tensor     # (Q, K) int32 original series ids; -1 = empty slot

    @property
    def k(self) -> int:
        return self.dists.shape[-1]

    def threshold(self) -> torch.Tensor:
        """(Q,) k-th best distance — the pruning bound. INF until full."""
        return self.dists[..., -1]

    def insert(self, d: torch.Tensor, ids: torch.Tensor) -> "Frontier":
        return insert_batch(self, d, ids)

    def insert_topk(self, d: torch.Tensor, ids: torch.Tensor) -> "Frontier":
        return insert_topk(self, d, ids)


def init(qn: int, k: int, device: torch.device) -> Frontier:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return Frontier(
        dists=torch.full((qn, k), INF, dtype=torch.float32, device=device),
        ids=torch.full((qn, k), -1, dtype=torch.int32, device=device))


def insert_batch(f: Frontier, d: torch.Tensor, ids: torch.Tensor, *,
                 assume_unique: bool = False) -> Frontier:
    """Fold a batch of candidates (Q, M) into the frontier.

    Candidates with id < 0 are ignored.  A candidate whose id is already
    held (the stage-A block is visited again by the walk) keeps one slot,
    at the MIN of both distances: the same pair recomputed by another
    kernel can differ in the last ulps.  Within one batch ids must be
    distinct.  ``assume_unique=True`` skips the (Q, M, K) duplicate mask
    for callers whose candidates cannot collide with held ids (the UCR
    scan: globally unique ids, each seen once).
    """
    d = torch.where(ids >= 0, d.to(torch.float32), INF)
    dists = f.dists
    if not assume_unique:
        same = (ids[..., :, None] == f.ids[..., None, :]) \
            & (ids[..., :, None] >= 0)                       # (Q, M, K)
        held = torch.where(same, d[..., :, None], INF).amin(dim=-2)
        dists = torch.minimum(dists, held)
        d = torch.where(same.any(dim=-1), INF, d)
    all_d = torch.cat([dists, d], dim=-1)
    all_i = torch.cat([f.ids, ids], dim=-1)
    nd, ni = ref.topk_by_dist_id(all_d, all_i, f.k)
    return Frontier(dists=nd, ids=torch.where(nd < INF, ni, -1))


def insert_topk(f: Frontier, d: torch.Tensor, ids: torch.Tensor) -> Frontier:
    """Fold PRE-SELECTED candidates (Q, k'), k' <= K, into the frontier.

    Inserting only the (dist, id)-lex top-k of a batch (ids distinct
    within the batch) is identical to inserting the whole batch, so the
    kernels hand over (Q, k) and the merge sorts 2k elements.
    """
    if d.shape[-1] > f.k:
        raise ValueError(
            f"insert_topk expects pre-selected candidates: got "
            f"{d.shape[-1]} > k={f.k}; use insert_batch for full panels")
    return insert_batch(f, d, ids)


def merge(fa: Frontier, fb: Frontier) -> Frontier:
    """Merge two frontiers (e.g. per-shard results) into one top-k."""
    return insert_batch(fa, fb.dists, fb.ids)


def result_dists(f: Frontier) -> torch.Tensor:
    """(Q, K) sqrt'd distances for a SearchResult; empty slots stay INF."""
    return torch.where(f.ids >= 0, torch.sqrt(f.dists), INF)


def bound(f: Frontier, initial_threshold: torch.Tensor | None = None
          ) -> torch.Tensor:
    """(Q,) pruning bound: k-th best so far, tightened by a seeded threshold."""
    t = f.threshold()
    if initial_threshold is not None:
        t = torch.minimum(t, initial_threshold)
    return t


def comm_device(group=None) -> torch.device:
    """The device a process group's collectives take their tensors on:
    the current card for NCCL, the host for gloo.  The messages of the
    distributed protocol are tiny ((Q,) thresholds, (Q, K) frontiers), so
    callers copy them there and back explicitly; the kernels stay on the
    index's device."""
    import torch.distributed as dist
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_merge(f: Frontier, group=None) -> Frontier:
    """Merge every rank's (Q, K) frontier into the global top-k, identical
    on every rank of ``group`` (None: the default group).

    One (D, Q, K) ``all_gather`` on the backend's device
    (``comm_device``), then one local merge on the frontier's own device:
    communication independent of the dataset size.
    """
    import torch.distributed as dist
    dev = comm_device(group)
    world = dist.get_world_size(group)
    out = []
    for t in (f.dists, f.ids):
        t = t.to(dev).contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.stack(parts).to(f.dists.device))  # (D, Q, K)
    gd, gi = out
    qn, k = f.dists.shape
    return insert_batch(init(qn, k, f.dists.device),
                        gd.movedim(0, 1).reshape(qn, -1),
                        gi.movedim(0, 1).reshape(qn, -1),
                        assume_unique=True)        # shards are disjoint


def query_block_l2(q: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Per-query distances to its own gathered block(s).

    q (Q, n); blocks (Q, ..., C, n) -> (Q, ..., C) squared distances, in
    the expanded form the kernels use, evaluated in float64 and rounded
    once, as ``ref.batch_l2_ref`` is (see there why).
    """
    q = q.to(torch.float64)
    blocks = blocks.to(torch.float64)
    qq = torch.sum(q * q, dim=-1)                             # (Q,)
    xx = torch.sum(blocks * blocks, dim=-1)                   # (Q, ..., C)
    cross = torch.einsum("qn,q...n->q...", q, blocks)
    qq = qq.reshape(qq.shape + (1,) * (xx.ndim - 1))
    return torch.clamp(qq + xx - 2.0 * cross, min=0.0).to(torch.float32)


def approximate(index, q: torch.Tensor, q_paa: torch.Tensor, k: int = 1
                ) -> tuple[Frontier, torch.Tensor]:
    """Stage A: seed a frontier from each query's best-envelope block.

    -> (frontier, block_lb (Q, B)).  One lower-bound kernel pass over the
    block envelopes, then the exact distances to each query's argmin
    block, inserted whole.
    """
    block_lb = ops.lb_scan_planar(q_paa, index.elo, index.ehi, n=index.n)
    b0 = torch.argmin(block_lb, dim=1)                        # (Q,)
    d = query_block_l2(q, index.raw[b0])                      # (Q, C)
    f = init(q.shape[0], k, q.device).insert(d, index.ids[b0])
    return f, block_lb


class QuerySetup(NamedTuple):
    """Shared query-side prep for the search paths."""
    q: torch.Tensor                    # (Q, n) prepared (z-normed / cast) queries
    q_paa: torch.Tensor | None         # (Q, w) PAA, when an index is involved
    frontier: Frontier                 # stage-A-seeded (or empty) top-k frontier
    block_lb: torch.Tensor | None      # (Q, B) stage-A envelope lower bounds
    stats: SearchStats


def prepare(queries: torch.Tensor, k: int, *, index=None, w: int | None = None,
            normalize: bool = True) -> QuerySetup:
    """z-norm/PAA + stage-A seeding + stats init, on the queries' device.

    ``index``: a BlockIndex enables stage-A approximate seeding.  ``w``:
    compute the PAA without an index.
    """
    q = (isax.znorm(queries) if normalize else queries).to(torch.float32)
    qn = q.shape[0]
    q_paa = block_lb = None
    if index is not None:
        require_device_resident(index)
        q_paa = isax.paa(q, index.w)
        front, block_lb = approximate(index, q, q_paa, k)
    else:
        if w is not None:
            q_paa = isax.paa(q, w)
        front = init(qn, k, q.device)
    return QuerySetup(q=q, q_paa=q_paa, frontier=front, block_lb=block_lb,
                      stats=stats_init(qn, q.device))
