"""One query engine: metric x schedule x backend — the ED x block_major x
device cell of ``repro.core.engine``.

ParIS/ParIS+ and MESSI are one skeleton: rank blocks by a lower bound,
seed a best-so-far top-k, refine survivors under the tightening k-th-best
bound.  This slice ports the main path: the z-normalized Euclidean
metric (``ED``), the block-major schedule (each block visited at most
once, in ascending min-over-queries lower-bound order, with a suffix-min
stopping table) and the device-resident backend.  The JAX walk is one
jitted ``lax.while_loop``; here it is a host loop with one host sync per
block (the stopping test).

Exactness: a block is only skipped when its lower bound is >= the
frontier's k-th-best distance for every query, and every bound satisfies
``block_lb <= series_lb <= distance``, so no true k-NN member is ever
dismissed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import frontier as frontier_lib
from repro_torch.core import isax
from repro_torch.core.frontier import INF, Frontier, SearchStats, query_block_l2
from repro_torch.core.index import BlockIndex
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

SCHEDULES = ("query_major", "block_major", "flat")


class QueryState(NamedTuple):
    """Metric-prepared queries: ``q`` plus metric-owned aux tensors
    (ED: the PAA)."""
    q: torch.Tensor
    aux: tuple


# ---------------------------------------------------------------------------
# metric adapters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ED:
    """Z-normalized Euclidean distance — the paper's core metric.

    ``lb_filter`` is the per-series MINDIST filter inside a surviving
    block; this slice runs it through the fused kernel.  Without it the
    refine needs the ``batch_l2`` kernel, which comes in slice 2.
    ``normalize=False`` is the prepared-vector path.
    """
    normalize: bool = True
    lb_filter: bool = True

    def __post_init__(self):
        if not self.lb_filter:
            raise NotImplementedError(
                "ED(lb_filter=False) needs the batch_l2 kernel, which "
                "comes in slice 2 of the port")

    def prep_queries(self, queries: torch.Tensor, *, w: int) -> QueryState:
        q = (isax.znorm(queries) if self.normalize
             else queries).to(torch.float32)
        return QueryState(q=q, aux=(isax.paa(q, w),))

    def block_lb(self, qs: QueryState, lo: torch.Tensor, hi: torch.Tensor, *,
                 n: int) -> torch.Tensor:
        """MINDIST of each query to planar (w, M) region bounds -> (Q, M)."""
        return ops.lb_scan_planar(qs.aux[0], lo, hi, n=n)

    def distances(self, qs: QueryState, block: torch.Tensor) -> torch.Tensor:
        """Per-query gathered blocks (Q, ..., C, n) -> (Q, ..., C)."""
        if block.ndim == 2:
            raise NotImplementedError(
                "shared-panel distances need the batch_l2 kernel, which "
                "comes in slice 2 of the port")
        return query_block_l2(qs.q, block)

    def panel_topk(self, qs: QueryState, block: torch.Tensor,
                   ids_b: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   active: torch.Tensor, thr: torch.Tensor, k: int, *,
                   n: int, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """LB-filter + distance + (dist, id)-lex top-k over one (C, n)
        panel, as ONE fused kernel -> (sel_d (Q, k), sel_id (Q, k),
        n_live (Q,)).  The per-query ``active`` mask folds into the
        threshold as -inf (``lb < -inf`` is never true)."""
        return ops.fused_panel_topk(
            qs.q, qs.aux[0], block, lo, hi, ids_b,
            torch.where(active, thr, float("-inf")), k=k, n=n)

    def finalize_stats(self, stats: SearchStats, capacity: int
                       ) -> SearchStats:
        """ED's counters are already right: ``series_refined`` counts
        filter survivors."""
        return stats


@dataclasses.dataclass(frozen=True)
class Cosine(ED):
    """Cosine similarity over embeddings (``repro.core.engine.Cosine``)."""

    def __post_init__(self):
        raise NotImplementedError(
            "the Cosine metric comes in slice 2 of the port")


@dataclasses.dataclass(frozen=True)
class DTW:
    """Sakoe-Chiba-band DTW (``repro.core.engine.DTW``)."""
    r: int

    def __post_init__(self):
        raise NotImplementedError(
            "the DTW metric and its dtw_band kernel come in slice 2 of "
            "the port")


# ---------------------------------------------------------------------------
# prepared round-1 state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedSearch:
    """Round-1 state as a resumable object: metric-prepared queries, the
    block lower-bound matrix, the stage-A-seeded frontier and the work
    stats so far.  Produced by ``prepare``; ``run(prepared=...)``
    resumes from it instead of recomputing round 1.  Nothing here is
    updated in place, so the object stays valid after a resume.
    """
    qs: QueryState
    front: Frontier
    block_lb: torch.Tensor         # (Q, B) metric block lower bounds
    stats: SearchStats             # work already accrued (stage A)

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
    """One cell of the metric x schedule matrix, plus its knobs.  The
    query-major width and flat-chunk knobs arrive with those schedules."""
    metric: object = ED()
    schedule: str = "block_major"
    k: int = 1
    deadline_blocks: int | None = None   # anytime cap; None = exact

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
                 lo: torch.Tensor, hi: torch.Tensor,
                 active: torch.Tensor, thr: torch.Tensor, *,
                 n: int, w: int) -> tuple[Frontier, SearchStats]:
    """Refine one (C, n) raw block panel against every query at once:
    the metric's fused ``panel_topk``, a 2k-wide ``insert_topk`` merge and
    the work-stat updates.  ``active`` (Q,) masks queries whose block
    lower bound beat ``thr``."""
    c = block.shape[0]
    sd, si, nlive = metric.panel_topk(qs, block, ids_b, lo, hi, active,
                                      thr, front.k, n=n, w=w)
    front = front.insert_topk(sd, si)
    act = active.to(torch.int32)
    stats = SearchStats(
        blocks_visited=stats.blocks_visited + act,
        series_refined=stats.series_refined + nlive,
        lb_series=stats.lb_series + act * c,
        iters=stats.iters,
    )
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
    ptr = 0
    while ptr < max_ptr:
        thr = frontier_lib.bound(front, initial_threshold)
        if not bool((suffix[:, ptr] < thr).any()):    # sync: once per block
            break
        b_id = order_h[ptr]
        active = block_lb[:, b_id] < thr                      # (Q,)
        front, stats = panel_refine(
            metric, qs, front, stats, index.raw[b_id], index.ids[b_id],
            index.slo[b_id], index.shi[b_id], active, thr, n=index.n,
            w=index.w)
        stats = stats._replace(iters=stats.iters + 1)
        ptr += 1
    return front, stats


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
    if plan.schedule != "block_major":
        raise NotImplementedError(
            f"the {plan.schedule!r} schedule comes in slice 2 of the port")
    if not isinstance(plan.metric, ED):
        raise NotImplementedError(
            f"metric {type(plan.metric).__name__} comes in slice 2 of the port")
    queries = torch.as_tensor(queries, device=dev)
    if initial_threshold is not None:
        initial_threshold = torch.as_tensor(initial_threshold,
                                            dtype=torch.float32, device=dev)
    if prepared is None:
        prepared = prepare(plan.metric, index, queries, plan.k)
    else:
        _check_prepared(prepared, plan, index.n_blocks, queries.shape[0])
    front, stats = _block_major(
        plan.metric, index, prepared.qs, prepared.front, prepared.block_lb,
        prepared.stats, deadline_blocks=plan.deadline_blocks,
        initial_threshold=initial_threshold)
    stats = plan.metric.finalize_stats(stats, index.capacity)
    return SearchResult(dist=frontier_lib.result_dists(front),
                        idx=front.ids, stats=stats)


def run_cached(*args, **kwargs):
    """The out-of-core host walk (``repro.core.engine.run_cached``)."""
    raise NotImplementedError(
        "run_cached and the on-disk index come in slice 3 of the port")
