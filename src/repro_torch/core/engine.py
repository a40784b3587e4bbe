"""One query engine: metric x schedule x backend, the device-resident
backend of ``repro.core.engine``.

ParIS/ParIS+ and MESSI are one skeleton: rank blocks by a lower bound,
seed a best-so-far top-k, refine survivors under the tightening k-th-best
bound.  Each axis is pluggable:

  * **metric**: ``ED`` (z-normalized Euclidean, the paper's core),
    ``DTW(r)`` (Sakoe-Chiba band over the unchanged index, the paper's
    §V) and ``Cosine`` (unit-norm embeddings);
  * **schedule**: ``query_major`` (paper-faithful per-query priority
    order), ``block_major`` (each block once, min-over-queries order with
    a suffix-min stopping table) and ``flat`` (the ParIS whole-SAX-array
    scan with chunked refinement, ``run_flat``).

The JAX walks are jitted ``lax.while_loop``/``lax.scan`` loops; here they
are host loops with one host sync per trip or chunk (the stopping test).
The third backend, ``run_cached``, walks an index opened out-of-core
(raw series on disk): the same block-major schedule, every raw block
fetched through a callback into a ``storage.BlockCache``, with a depth-D
lookahead of speculative reads and one threshold sync per group of G
blocks (``storage.SearchSession``).

Exactness: a schedule only skips work whose metric lower bound is >= the
frontier's k-th-best distance, and every metric's bounds satisfy
``block_lb <= series_lb <= distance``, so no true k-NN member is ever
dismissed.
"""
# repro: sync-trace — every device->host transfer in this module must
# carry a '# sync: once per <unit>' (deliberate) or '# host' (host data,
# no transfer) annotation; `python -m repro_torch.analysis` enforces it
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import frontier as frontier_lib
from repro_torch.core import isax
from repro_torch.core.frontier import INF, Frontier, SearchStats, query_block_l2
from repro_torch.core.index import (BlockIndex, FlatIndex,
                                    require_device_resident)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

SCHEDULES = ("query_major", "block_major", "flat")


class QueryState(NamedTuple):
    """Metric-prepared queries: ``q`` plus metric-owned aux tensors
    (ED: the PAA)."""
    q: torch.Tensor
    aux: tuple


# ---------------------------------------------------------------------------
# metric adapters
# ---------------------------------------------------------------------------

def prep_vectors(v: torch.Tensor, unit_norm: bool = True) -> torch.Tensor:
    """Embedding preparation for the Cosine metric.

    Unit-normalization makes Euclidean top-k == cosine top-k; the sqrt(d)
    rescale keeps per-dim values ~N(0,1)-sized so the iSAX breakpoints
    (standard-normal quantiles) stay discriminative.
    """
    v = v.to(torch.float32)
    if unit_norm:
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-8)
        v = v * math.sqrt(v.shape[-1])
    return v


def query_envelope(q: torch.Tensor, r: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keogh envelope: U_i = max(q[i-r:i+r+1]), L_i = min(...). q (..., n)."""
    n = q.shape[-1]
    pad = q.new_full(q.shape[:-1] + (r,), float("inf"))
    qu = torch.cat([-pad, q, -pad], dim=-1)
    ql = torch.cat([pad, q, pad], dim=-1)
    iu = (torch.arange(n, device=q.device)[:, None]
          + torch.arange(2 * r + 1, device=q.device)[None, :])
    return qu[..., iu].amax(dim=-1), ql[..., iu].amin(dim=-1)


def lb_keogh(q_env: tuple[torch.Tensor, torch.Tensor], x: torch.Tensor
             ) -> torch.Tensor:
    """LB_Keogh(Q, x)^2 for raw candidates. u, l (Q, n); x (N, n) -> (Q, N)."""
    u, l = q_env
    above = torch.clamp(x[None] - u[:, None], min=0.0)
    below = torch.clamp(l[:, None] - x[None], min=0.0)
    d = above + below   # at most one of the two is nonzero per element
    return torch.sum(d * d, dim=-1)


def interval_planar_lb(u_paa: torch.Tensor, l_paa: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor, *, n: int
                       ) -> torch.Tensor:
    """Squared MINDIST of the interval [l_paa, u_paa] to regions [lo, hi].

    Per segment max(0, lo - u, l - hi), zero when they overlap, which
    lower-bounds LB_Keogh_PAA and hence DTW against any series in the
    region.  Two passes of the planar ``lb_scan`` kernel: u against
    (lo, +S) and l against (-S, hi).  lo/hi (w, M): blocks or series.
    """
    big = isax.SENTINEL
    plane = torch.full(lo.shape, big, dtype=torch.float32, device=lo.device)
    above = ops.lb_scan_planar(u_paa, lo, plane, n=n)
    below = ops.lb_scan_planar(l_paa, -plane, hi, n=n)
    return above + below


def dtw_band(a: torch.Tensor, b: torch.Tensor, r: int) -> torch.Tensor:
    """Exact squared DTW with band r, a (..., n) vs b (..., n), broadcast:
    the generic entry point (the plain anti-diagonal DP).  Panel-shaped
    refines go through ``ops.dtw_panel``, which launches the kernel."""
    return ref.dtw_band_ref(a, b, r)


@dataclasses.dataclass(frozen=True)
class ED:
    """Z-normalized Euclidean distance — the paper's core metric.

    ``lb_filter`` is the per-series MINDIST filter inside a surviving
    block (the fused kernel on a shared panel); without it a panel is
    ``batch_l2`` then ``block_topk``.  ``normalize=False`` is the
    prepared-vector path.
    """
    normalize: bool = True
    lb_filter: bool = True

    # per-series filtering reads the stored iSAX region bounds
    needs_bounds = True

    @property
    def filters(self) -> bool:
        return self.lb_filter

    def prep_queries(self, queries: torch.Tensor, *, w: int) -> QueryState:
        q = (isax.znorm(queries) if self.normalize
             else queries).to(torch.float32)
        return QueryState(q=q, aux=(isax.paa(q, w),))

    def block_lb(self, qs: QueryState, lo: torch.Tensor, hi: torch.Tensor, *,
                 n: int) -> torch.Tensor:
        """MINDIST of each query to planar (w, M) region bounds -> (Q, M);
        M may be blocks (envelopes) or series (the flat schedule)."""
        return ops.lb_scan_planar(qs.aux[0], lo, hi, n=n)

    def series_lb(self, qs: QueryState, block: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, *, n: int, w: int) -> torch.Tensor:
        """Per-series MINDIST of gathered (Q, K, w, C) bounds -> (Q, K, C)."""
        qe = qs.aux[0][:, None, :, None]                   # (Q, 1, w, 1)
        dd = torch.clamp(torch.maximum(lo - qe, qe - hi), min=0.0)
        return (n / w) * torch.sum(dd * dd, dim=2)

    def distances(self, qs: QueryState, block: torch.Tensor) -> torch.Tensor:
        """Shared (C, n) panel -> (Q, C) through the ``batch_l2`` kernel;
        per-query gathered blocks (Q, ..., C, n) -> (Q, ..., C)."""
        if block.ndim == 2:
            return ops.batch_l2(qs.q, block)
        return query_block_l2(qs.q, block)

    def panel_topk(self, qs: QueryState, block: torch.Tensor,
                   ids_b: torch.Tensor, lo: torch.Tensor | None,
                   hi: torch.Tensor | None, active: torch.Tensor,
                   thr: torch.Tensor, k: int, *, n: int, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """LB-filter + distance + (dist, id)-lex top-k over one (C, n)
        panel -> (sel_d (Q, k), sel_id (Q, k), n_live (Q,)).  With the
        filter it is ONE fused kernel, the per-query ``active`` mask
        folded into the threshold as -inf (``lb < -inf`` is never true)."""
        if self.lb_filter:
            return ops.fused_panel_topk(
                qs.q, qs.aux[0], block, lo, hi, ids_b,
                torch.where(active, thr, float("-inf")), k=k, n=n)
        live = active[:, None] & (ids_b >= 0)[None, :]
        d = torch.where(live, self.distances(qs, block), INF)
        sd, si = ops.block_topk(d, torch.where(live, ids_b[None, :], -1), k)
        return sd, si, torch.sum(live, dim=1, dtype=torch.int32)

    def finalize_stats(self, stats: SearchStats, capacity: int
                       ) -> SearchStats:
        """ED's counters are already right: ``series_refined`` counts
        filter survivors."""
        return stats


@dataclasses.dataclass(frozen=True)
class Cosine(ED):
    """Cosine similarity over embeddings, served as Euclidean top-k.

    ``prep_vectors`` maps corpus and queries onto the sqrt(d)-scaled unit
    sphere, where d^2 = dim * (2 - 2 cos) is monotone in cosine, so the
    exact ED frontier is the exact cosine top-k.
    """
    normalize: bool = False     # never z-norm embeddings
    unit_norm: bool = True

    def prep_queries(self, queries: torch.Tensor, *, w: int) -> QueryState:
        q = prep_vectors(queries, self.unit_norm)
        return QueryState(q=q, aux=(isax.paa(q, w),))


@dataclasses.dataclass(frozen=True)
class DTW:
    """Sakoe-Chiba-band DTW over the UNCHANGED Euclidean index (paper §V).

    The block lower bound widens the query to its Keogh envelope and takes
    the interval-to-region MINDIST, which lower-bounds LB_Keogh_PAA and
    hence DTW.  The per-series filter is LB_Keogh on the raw values; it
    reads the block itself, so it needs no stored bounds.
    """
    r: int

    filters = True
    needs_bounds = False

    def prep_queries(self, queries: torch.Tensor, *, w: int) -> QueryState:
        q = isax.znorm(queries).to(torch.float32)
        u, l = query_envelope(q, self.r)
        return QueryState(q=q, aux=(u, l, isax.paa(u, w), isax.paa(l, w)))

    def block_lb(self, qs: QueryState, lo: torch.Tensor, hi: torch.Tensor, *,
                 n: int) -> torch.Tensor:
        """Interval [l_paa, u_paa] to region [lo, hi] MINDIST -> (Q, M)."""
        return interval_planar_lb(qs.aux[2], qs.aux[3], lo, hi, n=n)

    def series_lb(self, qs: QueryState, block: torch.Tensor, lo, hi, *,
                  n: int, w: int) -> torch.Tensor:
        u, l = qs.aux[0], qs.aux[1]
        if block.ndim == 2:                               # panel (C, n)
            return lb_keogh((u, l), block)                # (Q, C)
        above = torch.clamp(block - u[:, None, None, :], min=0.0)
        below = torch.clamp(l[:, None, None, :] - block, min=0.0)
        dd = above + below
        return torch.sum(dd * dd, dim=-1)                 # (Q, K, C)

    def distances(self, qs: QueryState, block: torch.Tensor) -> torch.Tensor:
        """Shared (C, n) or gathered (Q, C, n) -> the ``dtw_band_panel``
        kernel; (Q, K, C, n) goes to its gathered form as (Q, K*C, n)."""
        if block.ndim <= 3:
            return ops.dtw_panel(qs.q, block, r=self.r)
        qn, kb, c, n = block.shape
        return ops.dtw_panel(qs.q, block.reshape(qn, kb * c, n),
                             r=self.r).reshape(qn, kb, c)

    def panel_topk(self, qs: QueryState, block: torch.Tensor,
                   ids_b: torch.Tensor, lo, hi, active: torch.Tensor,
                   thr: torch.Tensor, k: int, *, n: int, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """LB_Keogh filter + banded-DP panel + top-k select."""
        s_lb = self.series_lb(qs, block, lo, hi, n=n, w=w)      # (Q, C)
        live = ((s_lb < thr[:, None]) & active[:, None]
                & (ids_b >= 0)[None, :])
        d = torch.where(live, self.distances(qs, block), INF)
        sd, si = ops.block_topk(d, torch.where(live, ids_b[None, :], -1), k)
        return sd, si, torch.sum(live, dim=1, dtype=torch.int32)

    def finalize_stats(self, stats: SearchStats, capacity: int
                       ) -> SearchStats:
        """DTW's convention on every schedule: each visited block costs a
        full panel of LB_Keogh bounds and of banded-DP distances (the DP
        runs for all candidates, then masks), so ``series_refined ==
        lb_series == blocks_visited * capacity`` and ``iters == 0``."""
        v = stats.blocks_visited
        return SearchStats(blocks_visited=v, series_refined=v * capacity,
                           lb_series=v * capacity,
                           iters=torch.zeros((), dtype=torch.int32,
                                             device=v.device))


# ---------------------------------------------------------------------------
# prepared round-1 state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedSearch:
    """Round-1 state as a resumable object: metric-prepared queries, the
    block lower-bound matrix, the stage-A-seeded frontier, the work
    stats so far and, on the cached backend, the ids of the blocks
    already fetched and refined.  Produced by ``prepare`` (device) or
    ``run_cached_stage_a`` / a deadline-cut ``run_cached`` (cached);
    ``run(prepared=...)`` and ``run_cached(prepared=...)`` resume from
    it instead of recomputing round 1.  Nothing here is updated in
    place, so the object stays valid after a resume.
    """
    qs: QueryState
    front: Frontier
    block_lb: torch.Tensor         # (Q, B) metric block lower bounds
    stats: SearchStats             # work already accrued (stage A)
    refined: frozenset = frozenset()   # block ids already refined (cached)

    @property
    def k(self) -> int:
        return self.front.k


def _check_prepared(prepared: PreparedSearch, plan: "QueryPlan",
                    n_blocks: int, qn: int) -> None:
    if prepared.k != plan.k:
        raise ValueError(f"prepared state holds a k={prepared.k} frontier "
                         f"but the plan asks k={plan.k}; round 2 must reuse "
                         "the round-1 plan")
    if prepared.block_lb.shape[-1] != n_blocks:
        raise ValueError(
            f"prepared block_lb ranks {prepared.block_lb.shape[-1]} blocks "
            f"but this index has {n_blocks}; the prepared state belongs to "
            "a different index")
    if prepared.block_lb.shape[0] != qn:
        raise ValueError(
            f"prepared state was built for {prepared.block_lb.shape[0]} "
            f"queries but {qn} were passed; round 2 must reuse the round-1 "
            "query batch")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One cell of the metric x schedule matrix, plus its knobs."""
    metric: object = ED()
    schedule: str = "block_major"
    k: int = 1
    blocks_per_iter: int = 4        # query_major refine width
    deadline_blocks: int | None = None   # anytime cap; None = exact
    chunk: int = 4096               # flat-schedule refinement chunk

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        if self.deadline_blocks is not None and self.deadline_blocks < 1:
            # a <= 0 deadline would clamp to an empty walk — an
            # approximate answer the caller never asked for
            raise ValueError(
                f"deadline_blocks must be >= 1 (or None for an exact "
                f"search), got {self.deadline_blocks}")


def prepare(metric, index: BlockIndex, queries: torch.Tensor, k: int
            ) -> PreparedSearch:
    """Metric prep + block ranking + stage-A seeding.

    One block-LB kernel pass ranks every envelope; each query's best
    block (the first minimum) is refined exactly and seeds the frontier.
    """
    require_device_resident(index)
    qs = metric.prep_queries(queries, w=index.w)
    qn = qs.q.shape[0]
    block_lb = metric.block_lb(qs, index.elo, index.ehi, n=index.n)
    b0 = torch.argmin(block_lb, dim=1)                        # (Q,)
    ids0 = index.ids[b0]                                      # (Q, C)
    d0 = metric.distances(qs, index.raw[b0])                  # (Q, C)
    # pad lanes (id < 0) hold RAW_PAD series with FINITE huge distances —
    # mask to INF before the select (block_topk's masking contract)
    sd, si = ops.block_topk(torch.where(ids0 >= 0, d0, INF), ids0, k)
    front = frontier_lib.init(qn, k, index.device).insert_topk(sd, si)
    return PreparedSearch(qs=qs, front=front, block_lb=block_lb,
                          stats=frontier_lib.stats_init(qn, index.device))


def panel_refine(metric, qs: QueryState, front: Frontier, stats: SearchStats,
                 block: torch.Tensor, ids_b: torch.Tensor,
                 lo: torch.Tensor | None, hi: torch.Tensor | None,
                 active: torch.Tensor, thr: torch.Tensor, *,
                 n: int, w: int) -> tuple[Frontier, SearchStats]:
    """Refine one (C, n) raw block panel against every query at once:
    the metric's ``panel_topk``, a 2k-wide ``insert_topk`` merge and the
    work-stat updates.  ``active`` (Q,) masks queries whose block lower
    bound beat ``thr``; ``lo``/``hi`` are the block's (w, C) bounds, None
    when the metric filters off the raw values or not at all."""
    c = block.shape[0]
    sd, si, nlive = metric.panel_topk(qs, block, ids_b, lo, hi, active,
                                      thr, front.k, n=n, w=w)
    front = front.insert_topk(sd, si)
    act = active.to(torch.int32)
    stats = SearchStats(
        blocks_visited=stats.blocks_visited + act,
        series_refined=stats.series_refined + nlive,
        lb_series=stats.lb_series + (act * c if metric.filters else 0),
        iters=stats.iters,
    )
    return front, stats


# ---------------------------------------------------------------------------
# device backend: the two ordered schedules + the flat scan
# ---------------------------------------------------------------------------

def trip_panel(metric, index: BlockIndex, qs: QueryState, idxs: torch.Tensor,
               active: torch.Tensor, thr: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked panel of one query-major trip: each query's blocks
    ``idxs`` (Q, K), ``active`` (Q, K) where the block bound beat ``thr``
    (Q,), the metric's per-series filter, then its distances ->
    (d (Q, K*C) with INF off the live lanes, ids (Q, K*C) with -1 there,
    live (Q, K, C)), the panel ``block_topk`` selects from."""
    n = index.n
    qn = qs.q.shape[0]
    blocks = index.raw[idxs]                                  # (Q,K,C,n)
    ids = index.ids[idxs]                                     # (Q,K,C)
    if metric.filters:
        lo = index.slo[idxs] if metric.needs_bounds else None
        hi = index.shi[idxs] if metric.needs_bounds else None
        s_lb = metric.series_lb(qs, blocks, lo, hi, n=n, w=index.w)
        s_act = (s_lb < thr[:, None, None]) & active[..., None]
    else:
        s_act = active[..., None].expand(ids.shape)
    d = metric.distances(qs, blocks)                          # (Q,K,C)
    live = s_act & (ids >= 0)
    # blocks partition the series and idxs rows are distinct, so ids
    # are unique per row: block_topk's subset-exactness holds
    return (torch.where(live, d, INF).reshape(qn, -1),
            torch.where(live, ids, -1).reshape(qn, -1), live)


def _query_major(metric, index: BlockIndex, qs: QueryState, front: Frontier,
                 block_lb: torch.Tensor, stats: SearchStats, *,
                 blocks_per_iter: int, deadline_blocks: int | None,
                 initial_threshold: torch.Tensor | None
                 ) -> tuple[Frontier, SearchStats]:
    """Paper-faithful order: each query refines ITS next-best blocks.

    A per-query LB-argsorted schedule and a host loop refining the next
    ``blocks_per_iter`` blocks of every query per trip, with one sync per
    trip (the stopping test: every query's next block LB >= its bound).
    Ordered traversal plus that rule are the paper's priority-queue
    semantics.  The JAX walk's skipped branch (no active block in a trip)
    is the masked refine here: nothing is live, so the frontier and every
    counter but ``iters`` stay as they are.
    """
    b, c, _ = index.raw.shape
    kb = min(blocks_per_iter, b)
    # stable: block bounds often tie (at 0.0), and the visit order and
    # every counter follow jnp.argsort's stable order
    order = torch.argsort(block_lb, dim=1, stable=True)      # (Q, B)
    max_ptr = b if deadline_blocks is None else min(b, deadline_blocks)
    ptr = 0
    while ptr < max_ptr:
        thr = frontier_lib.bound(front, initial_threshold)
        safe = min(ptr, b - 1)
        nxt = torch.gather(block_lb, 1, order[:, safe:safe + 1])[:, 0]
        if not bool((nxt < thr).any()):                   # sync: once per trip
            break
        # lax.dynamic_slice clamps its start so that kb blocks fit
        start = min(ptr, b - kb)
        idxs = order[:, start:start + kb]                         # (Q, K)
        active = torch.gather(block_lb, 1, idxs) < thr[:, None]   # (Q, K)
        d, ids, live = trip_panel(metric, index, qs, idxs, active, thr)
        sd, si = ops.block_topk(d, ids, front.k)
        front = front.insert_topk(sd, si)
        n_act = torch.sum(active, dim=1, dtype=torch.int32)
        stats = SearchStats(
            blocks_visited=stats.blocks_visited + n_act,
            series_refined=stats.series_refined
            + torch.sum(live, dim=(1, 2), dtype=torch.int32),
            lb_series=stats.lb_series + (n_act * c if metric.filters else 0),
            iters=stats.iters + 1)
        ptr += kb
    return front, stats


def block_major_schedule(block_lb: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Visit order + suffix-min stop table.

    Blocks ascend by min-over-queries lower bound (a stable sort: blocks
    often tie, e.g. at 0.0, and ties keep block order as ``jnp.argsort``
    does); when suffix[q, ptr] >= threshold[q] nothing later can improve
    q's top-k.
    """
    order = torch.argsort(block_lb.amin(dim=0), stable=True)  # (B,)
    sched_lb = block_lb[:, order]                             # (Q, B)
    suffix = torch.cummin(sched_lb.flip(1), dim=1).values.flip(1)
    return order, sched_lb, suffix


def _block_major(metric, index: BlockIndex, qs: QueryState, front: Frontier,
                 block_lb: torch.Tensor, stats: SearchStats, *,
                 deadline_blocks: int | None,
                 initial_threshold: torch.Tensor | None
                 ) -> tuple[Frontier, SearchStats]:
    """Every block visited at most once; one (Q, C) panel per visit.

    A host loop with one sync per block, the stopping test.  A visit
    whose queries are all inactive (their rows carry thr = -inf into the
    kernel) leaves the frontier and every counter but ``iters``
    unchanged, exactly as the JAX walk's skipped branch does, so it
    needs no second sync.
    """
    b = index.n_blocks
    order, _, suffix = block_major_schedule(block_lb)
    order_h = order.tolist()                      # sync: once per batch
    max_ptr = b if deadline_blocks is None else min(b, deadline_blocks)
    bounds = metric.filters and metric.needs_bounds
    ptr = 0
    while ptr < max_ptr:
        thr = frontier_lib.bound(front, initial_threshold)
        if not bool((suffix[:, ptr] < thr).any()):    # sync: once per block
            break
        b_id = order_h[ptr]
        active = block_lb[:, b_id] < thr                      # (Q,)
        front, stats = panel_refine(
            metric, qs, front, stats, index.raw[b_id], index.ids[b_id],
            index.slo[b_id] if bounds else None,
            index.shi[b_id] if bounds else None, active, thr, n=index.n,
            w=index.w)
        stats = stats._replace(iters=stats.iters + 1)
        ptr += 1
    return front, stats


def _as_device(queries, initial_threshold, dev: torch.device):
    queries = torch.as_tensor(queries, device=dev)
    if initial_threshold is not None:
        initial_threshold = torch.as_tensor(initial_threshold,
                                            dtype=torch.float32, device=dev)
    return queries, initial_threshold


def run(index: BlockIndex, queries, plan: QueryPlan,
        initial_threshold: torch.Tensor | None = None,
        prepared: PreparedSearch | None = None, *,
        device: str | torch.device | None = "cuda"):
    """Execute a plan against a device-resident index. -> SearchResult.

    ``device`` is where the search runs (the card unless the caller asks
    for the CPU); the index must live there.  ``initial_threshold``
    tightens the pruning bound (squared distance) and never appears in
    the result.  ``prepared`` resumes from a round-1 ``PreparedSearch``
    (same metric, index, queries and k) instead of recomputing it.
    """
    from repro_torch.core.search import SearchResult   # thin wrapper layer
    dev = resolve_device(device)
    if index.device != dev:
        raise ValueError(f"the index lives on {index.device}, not on {dev}")
    if plan.schedule == "flat":
        raise ValueError("the flat schedule scans a FlatIndex — use "
                         "engine.run_flat (or paris.search_flat)")
    queries, initial_threshold = _as_device(queries, initial_threshold, dev)
    if prepared is None:
        prepared = prepare(plan.metric, index, queries, plan.k)
    else:
        _check_prepared(prepared, plan, index.n_blocks, queries.shape[0])
    walk_args = (plan.metric, index, prepared.qs, prepared.front,
                 prepared.block_lb, prepared.stats)
    if plan.schedule == "query_major":
        front, stats = _query_major(
            *walk_args, blocks_per_iter=plan.blocks_per_iter,
            deadline_blocks=plan.deadline_blocks,
            initial_threshold=initial_threshold)
    else:
        front, stats = _block_major(
            *walk_args, deadline_blocks=plan.deadline_blocks,
            initial_threshold=initial_threshold)
    stats = plan.metric.finalize_stats(stats, index.capacity)
    return SearchResult(dist=frontier_lib.result_dists(front),
                        idx=front.ids, stats=stats)


def run_flat(index: FlatIndex, queries, plan: QueryPlan,
             block_index: BlockIndex | None = None,
             initial_threshold: torch.Tensor | None = None, *,
             device: str | torch.device | None = "cuda"):
    """The ParIS schedule: one planar LB pass over EVERY series, then
    chunked candidate refinement with the running frontier.

    ``block_index`` (optional) enables stage-A seeding from the block
    view; without it the scan starts from an empty frontier.  A host loop
    over chunks with one sync per chunk (does any candidate survive?); a
    chunk with no survivor is skipped.  The last chunk is ragged instead
    of padded: padding lanes are never live, so the answer and counters
    are those of the padded JAX scan.  ``plan.deadline_blocks`` caps the
    number of chunks refined (anytime, in chunk units).
    """
    from repro_torch.core.search import SearchResult
    dev = resolve_device(device)
    if index.device != dev:
        raise ValueError(f"the index lives on {index.device}, not on {dev}")
    queries, initial_threshold = _as_device(queries, initial_threshold, dev)
    metric = plan.metric
    npad, n = index.raw.shape
    if block_index is not None:
        prep = prepare(metric, block_index, queries, plan.k)
        qs, front = prep.qs, prep.front
    else:
        qs = metric.prep_queries(queries, w=index.w)
        front = frontier_lib.init(qs.q.shape[0], plan.k, dev)
    qn = qs.q.shape[0]
    c = min(plan.chunk, npad)
    nchunks = -(-npad // c)

    # phase 2 — the flat LB scan over the ENTIRE SAX array (one kernel pass)
    lb = metric.block_lb(qs, index.lo, index.hi, n=n)         # (Q, Np)

    # phase 3 — chunked candidate refinement with the running frontier
    refined = torch.zeros((qn,), dtype=torch.int32, device=dev)
    nref = 0
    for j in range(nchunks):
        if plan.deadline_blocks is not None and nref >= plan.deadline_blocks:
            break                         # every later chunk is skipped
        s, e = j * c, min((j + 1) * c, npad)
        ids_k = index.ids[s:e]
        thr = frontier_lib.bound(front, initial_threshold)
        act = (lb[:, s:e] < thr[:, None]) & (ids_k[None, :] >= 0)
        if not bool(act.any()):                       # sync: once per chunk
            continue
        d = torch.where(act, metric.distances(qs, index.raw[s:e]), INF)
        sd, si = ops.block_topk(d, torch.where(act, ids_k[None, :], -1),
                                front.k)
        front = front.insert_topk(sd, si)
        refined = refined + torch.sum(act, dim=1, dtype=torch.int32)
        nref += 1

    stats = SearchStats(
        blocks_visited=torch.full((qn,), nchunks, dtype=torch.int32,
                                  device=dev),
        series_refined=refined,
        lb_series=torch.full((qn,), index.n_real, dtype=torch.int32,
                             device=dev),                 # whole array
        iters=torch.tensor(nchunks, dtype=torch.int32, device=dev),
    )
    return SearchResult(dist=frontier_lib.result_dists(front),
                        idx=front.ids, stats=stats)


# ---------------------------------------------------------------------------
# cached backend: the same block-major walk, host-driven through callbacks
# ---------------------------------------------------------------------------

def _cached_refine_step(metric, qs: QueryState, front: Frontier,
                        stats: SearchStats, block: torch.Tensor,
                        ids_b: torch.Tensor, lo, hi, lbs: torch.Tensor,
                        initial_threshold, *, n: int, w: int
                        ) -> tuple[Frontier, SearchStats]:
    """One fetched block against all queries: the device side of the walk.
    The threshold is the device-side frontier's, so a block the host
    admitted under a stale bound refines exactly what the serial walk
    would (often nothing: all-False ``active``)."""
    thr = frontier_lib.bound(front, initial_threshold)
    active = lbs < thr
    return panel_refine(metric, qs, front, stats, block, ids_b, lo, hi,
                        active, thr, n=n, w=w)


def cached_setup(index: BlockIndex, queries: torch.Tensor, plan: QueryPlan
                 ) -> PreparedSearch:
    """Query prep + block ranking for an index whose raw lives off-device.

    Only summaries and envelopes are touched (they are device-resident on
    an opened index); the frontier starts EMPTY: stage A needs raw
    blocks, which the walk fetches through its callback.
    """
    metric = plan.metric
    qs = metric.prep_queries(queries, w=index.w)
    qn = qs.q.shape[0]
    block_lb = metric.block_lb(qs, index.elo, index.ehi, n=index.n)
    return PreparedSearch(qs=qs, front=frontier_lib.init(qn, plan.k,
                                                         index.device),
                          block_lb=block_lb,
                          stats=frontier_lib.stats_init(qn, index.device))


def _check_pipeline_knobs(pipeline_depth: int, group_blocks: int) -> None:
    if pipeline_depth < 1 or group_blocks < 1:
        raise ValueError(
            f"pipeline_depth and group_blocks must be >= 1 (1, 1 is the "
            f"serial walk), got ({pipeline_depth}, {group_blocks})")


class _GroupDispatcher:
    """Host side of the pipelined refine: one group of blocks per call.

    Shared by stage A and the walk.  A group is a loop of
    ``_cached_refine_step`` calls with no host sync between them (the
    reference stacks the group into one ``lax.scan``): the frontier
    carries from block to block on the device, so every block meets the
    threshold left by the blocks before it, exactly as in the serial
    walk, and the host syncs once per group.
    """

    def __init__(self, index: BlockIndex, plan: QueryPlan,
                 block_lb: torch.Tensor, fetch, initial_threshold):
        self.index = index
        self.metric = plan.metric
        self.block_lb = block_lb                 # (Q, B) device
        self.fetch = fetch
        self.thr0 = initial_threshold
        self.needs = plan.metric.filters and plan.metric.needs_bounds
        self.dispatches = 0

    def __call__(self, qs: QueryState, front: Frontier, stats: SearchStats,
                 gids: list[int]) -> tuple[Frontier, SearchStats]:
        index, needs = self.index, self.needs
        self.dispatches += 1
        for b in gids:
            front, stats = _cached_refine_step(
                self.metric, qs, front, stats, self.fetch(b), index.ids[b],
                index.slo[b] if needs else None,
                index.shi[b] if needs else None, self.block_lb[:, b],
                self.thr0, n=index.n, w=index.w)
        return front, stats


def _cached_stage_a(index: BlockIndex, plan: QueryPlan, prep: PreparedSearch,
                    block_lb_h: np.ndarray, fetch, speculate,
                    initial_threshold, *, pipeline_depth: int = 1,
                    group_blocks: int = 1, telemetry: dict | None = None
                    ) -> PreparedSearch:
    """Stage A on the cached backend: each query's best-envelope block
    seeds the frontier.  A pure fetch/refine chain: the next
    ``pipeline_depth`` blocks are always in flight behind the reader
    pool, and up to ``group_blocks`` blocks ride one dispatch.  Returns
    the state with the refined block ids recorded, so a resumed walk
    never fetches or refines them again."""
    qs, front, stats = prep.qs, prep.front, prep.stats
    dispatch = _GroupDispatcher(index, plan, prep.block_lb, fetch,
                                initial_threshold)
    stage_a = [int(b) for b in np.unique(np.argmin(block_lb_h, axis=1))]
    i = 0
    while i < len(stage_a):
        gids = stage_a[i:i + group_blocks]
        for b in gids:                     # group reads first, in order
            speculate(b)
        nxt = i + len(gids)
        for b in stage_a[nxt:nxt + pipeline_depth]:    # depth-D lookahead
            speculate(b)
        front, stats = dispatch(qs, front, stats, gids)
        i = nxt
    if telemetry is not None:
        telemetry["stage_a_blocks"] = len(stage_a)
        telemetry["stage_a_dispatches"] = dispatch.dispatches
    return dataclasses.replace(prep, front=front, stats=stats,
                               refined=prep.refined | frozenset(stage_a))


def run_cached(index: BlockIndex, queries: torch.Tensor, plan: QueryPlan, *,
               fetch: Callable[[int], torch.Tensor],
               speculate: Callable[[int], None] = lambda b: None,
               initial_threshold: torch.Tensor | None = None,
               prepared: PreparedSearch | None = None,
               pipeline_depth: int = 1, group_blocks: int = 1,
               telemetry: dict | None = None
               ) -> tuple[Frontier, SearchStats, PreparedSearch]:
    """The block-major walk over an index whose raw series live off the
    device, driven through a fetch callback (``storage.BlockCache``), as
    a depth-D, group-G pipeline that is the serial walk at (D=1, G=1).

    Same schedule, stopping rule and ``panel_refine`` as the device
    block-major backend; only the block transport differs: ``fetch(b)``
    returns the (C, n) block on the index's device (blocking only if a
    disk read is needed), ``speculate(b)`` starts a background read.

    ``pipeline_depth`` (D) surviving schedule slots beyond the current
    group are speculated each iteration; ``group_blocks`` (G) batches up
    to G consecutive surviving blocks (under the current host threshold)
    into one dispatch, and the walk syncs the threshold once per GROUP.
    The host threshold only decides which blocks are dispatched and is
    stale by at most one group; a block admitted stale meets the
    up-to-date device-side threshold, so dist, idx and every counter are
    bit-identical for any (D, G); only the I/O can differ.

    ``telemetry`` (optional dict) receives ``syncs`` (threshold round
    trips), ``dispatches``, ``walk_blocks``, and stage A's block and
    dispatch counts.

    ``plan.deadline_blocks`` caps the blocks refined AFTER stage A; when
    it fires the frontier is the anytime answer and the returned state
    its exact-resume continuation.  ``prepared`` resumes from a
    ``PreparedSearch`` of ``run_cached_stage_a`` or a deadline-cut
    ``run_cached`` (same metric, index, queries and k): query prep,
    ranking and stage A are skipped, and no block in
    ``prepared.refined`` is fetched or refined again.

    Returns ``(frontier, finalized stats, end state)``; the end state's
    ``refined`` holds every block this run and the run it resumed
    refined.  I/O accounting belongs to the callback owner.
    """
    if plan.schedule != "block_major":
        raise ValueError("the cached backend walks the block-major "
                         f"schedule; got {plan.schedule!r}")
    _check_pipeline_knobs(pipeline_depth, group_blocks)
    n_blocks = index.n_blocks
    queries, initial_threshold = _as_device(queries, initial_threshold,
                                            index.device)
    if prepared is None:
        prep = cached_setup(index, queries, plan)
        prep = _cached_stage_a(
            index, plan, prep,
            prep.block_lb.cpu().numpy(),            # sync: once per batch
            fetch, speculate, initial_threshold,
            pipeline_depth=pipeline_depth, group_blocks=group_blocks,
            telemetry=telemetry)
    else:
        _check_prepared(prepared, plan, n_blocks, queries.shape[0])
        prep = prepared
    qs, front, block_lb, stats = (prep.qs, prep.front, prep.block_lb,
                                  prep.stats)
    done = prep.refined
    # one sync a batch: the host copy drives block ordering and the
    # survivor scan; the walk then syncs once a GROUP
    block_lb_h = block_lb.cpu().numpy()             # sync: once per batch
    dispatch = _GroupDispatcher(index, plan, block_lb, fetch,
                                initial_threshold)
    budget = plan.deadline_blocks        # refines left; None = unbounded

    order_t, sched_t, _ = block_major_schedule(torch.from_numpy(block_lb_h))
    order, sched_lb = order_t.numpy(), sched_t.numpy()      # host
    # slot_done[s]: schedule slot s already refined (stage A / a resumed
    # run) or consumed by this walk; the survivor scan masks it out
    slot_done = (np.isin(order, np.fromiter(done, np.int64, len(done)))
                 if done else np.zeros(n_blocks, dtype=bool))

    walked: list[int] = []               # blocks THIS walk refined
    n_syncs = 1
    thr_h = frontier_lib.bound(  # sync: once per batch
        front, initial_threshold).cpu().numpy()
    ptr = 0
    while ptr < n_blocks:
        if budget is not None and len(walked) >= budget:
            break                       # deadline: the answer is anytime
        # a slot survives if unconsumed and any query's scheduled LB beats
        # the bound; no survivor <=> the suffix-min stopping rule fires
        live = np.flatnonzero(~slot_done[ptr:] & np.any(
            sched_lb[:, ptr:] < thr_h[:, None], axis=0)) + ptr
        if live.size == 0:
            break                       # nothing later helps any query
        g = (group_blocks if budget is None
             else min(group_blocks, budget - len(walked)))
        take = live[:g]                 # this group's schedule slots
        gids = [int(order[s]) for s in take]
        for b in gids[1:]:
            # group members behind the head start reading now, so the
            # reader pool overlaps them with the head's blocking fetch
            speculate(b)
        front, stats = dispatch(qs, front, stats, gids)           # async
        walked += gids
        slot_done[take] = True
        # depth-D lookahead: the next D surviving slots under the (now
        # one group stale) bound start reading while the device refines;
        # a speculated slot pruned later just stays cached under its id
        for s in live[g:g + pipeline_depth]:
            speculate(int(order[s]))
        thr_h = frontier_lib.bound(  # sync: once per group
            front, initial_threshold).cpu().numpy()
        n_syncs += 1
        # slots in [ptr, take[-1]] not taken were pruned under a bound
        # that only tightened since: jump straight past the group
        ptr = int(take[-1]) + 1
    if telemetry is not None:
        telemetry.update(syncs=n_syncs, dispatches=dispatch.dispatches,
                         walk_blocks=len(walked),
                         pipeline_depth=pipeline_depth,
                         group_blocks=group_blocks)
    state = dataclasses.replace(prep, front=front, stats=stats,
                                refined=done | frozenset(walked))
    return front, plan.metric.finalize_stats(stats, index.capacity), state


def run_cached_stage_a(index: BlockIndex, queries: torch.Tensor,
                       plan: QueryPlan, *,
                       fetch: Callable[[int], torch.Tensor],
                       speculate: Callable[[int], None] = lambda b: None,
                       pipeline_depth: int = 1, group_blocks: int = 1
                       ) -> PreparedSearch:
    """Stage A only, on the cached backend: the approximate top-k after
    refining each query's best-envelope block.  ``run_cached`` resumes
    the returned ``PreparedSearch`` instead of repeating stage A."""
    _check_pipeline_knobs(pipeline_depth, group_blocks)
    queries = torch.as_tensor(queries, device=index.device)
    prep = cached_setup(index, queries, plan)
    return _cached_stage_a(index, plan, prep,
                           prep.block_lb.cpu().numpy(),  # sync: once per batch
                           fetch, speculate, None,
                           pipeline_depth=pipeline_depth,
                           group_blocks=group_blocks)
