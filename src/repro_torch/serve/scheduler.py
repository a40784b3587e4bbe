"""The coalesced query-major priority walk (``repro.serve.scheduler``).

``engine.run_cached`` walks block-major: one static schedule (ascending
min-over-queries envelope LB) shared by the whole batch.  Serving mixed
traffic wants the paper-faithful *query-major* order instead — each query
works through ITS OWN LB-ascending block list — without paying N cold
walks for N concurrent tenants.  This walk does both:

  * **priority**: each step fetches the most urgent query's next-best
    unrefined block — the argmin, over all tenants' (query, block) pairs
    still able to improve a result, of the envelope lower bound.  That
    argmin IS per-query priority order: the winning query advances
    through its own ranking, and urgency decides the interleave.
  * **coalescing**: the fetched block refines EVERY tenant that could
    still need it, in one pass a tenant, and is marked refined for all of
    them; tenants whose queries no longer reach it (their bounds only
    tighten) skip it for good.  N tenants therefore fetch the union of
    their surviving block sets, not the sum.

Exactness is the engine's argument: a (query, block) pair is skipped only
once ``lb >= threshold``, and thresholds only tighten, so no true k-NN
member is dismissed: the final frontier is bit-identical to each tenant
running alone (the same candidates meet the same ``panel_refine``; only
the fetch order and count differ).

``budget`` bounds the walk's refines for anytime serving: when it fires,
each incomplete tenant's state is a deadline-cut walk state —
``serve.certify`` bounds its error, ``prepared=`` resumes it to exact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.index import BlockIndex


@dataclasses.dataclass
class TenantRun:
    """One admitted query batch's in-walk state.

    ``plan`` is the tenant's deadline-free plan (metric and k may differ
    across tenants sharing a walk); ``state`` is the evolving
    ``engine.PreparedSearch`` — stage-A-seeded on entry, the tenant's
    final (or anytime-resumable) state on exit.  ``complete`` is set once
    no unrefined block can improve any of the tenant's queries.
    """
    plan: engine.QueryPlan
    queries: torch.Tensor
    state: engine.PreparedSearch
    complete: bool = False


def prepare_tenant(index: BlockIndex, queries: torch.Tensor,
                   plan: engine.QueryPlan, *,
                   fetch: Callable[[int], torch.Tensor],
                   speculate: Callable[[int], None] = lambda b: None,
                   pipeline_depth: int = 1, group_blocks: int = 1
                   ) -> TenantRun:
    """Admission: metric prep, block ranking and stage-A seeding.

    Stage A goes through the SHARED fetch callback, so tenants whose
    best-envelope blocks coincide already coalesce here: the second
    tenant's stage A is a cache hit, not a disk read.
    ``pipeline_depth`` / ``group_blocks`` pipeline the tenant's own
    stage-A chain as in ``run_cached`` (answers unchanged).
    """
    state = engine.run_cached_stage_a(index, queries, plan,
                                      fetch=fetch, speculate=speculate,
                                      pipeline_depth=pipeline_depth,
                                      group_blocks=group_blocks)
    return TenantRun(plan=plan, queries=queries, state=state)


def coalesced_walk(index: BlockIndex, tenants: list[TenantRun], *,
                   fetch: Callable[[int], torch.Tensor],
                   speculate: Callable[[int], None] = lambda b: None,
                   budget: int | None = None,
                   pipeline_depth: int = 1, group_blocks: int = 1) -> int:
    """Run the shared priority walk to completion (or ``budget`` refines).

    Mutates each tenant's ``state`` / ``complete`` in place; returns the
    number of blocks the walk fetched and refined (stage A excluded).

    The walk is pipelined like ``engine.run_cached``: each step picks the
    ``group_blocks`` most urgent surviving blocks under the CURRENT host
    thresholds (a stable urgency order: ties fall to the lowest block id,
    so G=1 is the plain argmin pick), refines each tenant's share of the
    group in one dispatch, then speculates the next ``pipeline_depth``
    targets before paying ONE threshold sync per tenant per group.  Stale
    thresholds only admit extra blocks, and each refine re-checks the
    carried frontier's threshold on the device, so dist and idx stay
    bit-identical to the serial walk (and to each tenant alone).  The
    work counters may differ under G>1: this walk's fetch order depends
    on the thresholds, so grouping can change which interleave (and how
    much masked work) produced the same exact answer.  ``budget`` counts
    blocks: a partial final group is cut to fit.
    """
    if not tenants:
        return 0
    engine._check_pipeline_knobs(pipeline_depth, group_blocks)
    n_blocks = index.n_blocks
    # host-side walk state, per tenant: LB matrix, refined mask, thresholds
    lbs = [t.state.block_lb.cpu().numpy() for t in tenants]  # sync: 1/walk
    thrs = [t.state.front.threshold().cpu().numpy() for t in tenants]
    refined = []
    for t in tenants:
        mask = np.zeros(n_blocks, dtype=bool)
        if t.state.refined:
            mask[np.fromiter(t.state.refined, dtype=np.int64)] = True
        refined.append(mask)
    walked = [set() for _ in tenants]     # beyond-stage-A refines, per tenant

    def urgency(i: int) -> np.ndarray:
        """(B,) tenant i's most urgent pending lb per block (inf = none)."""
        live = np.where(lbs[i] < thrs[i][:, None], lbs[i], np.inf)
        u = live.min(axis=0)
        u[refined[i]] = np.inf
        return u

    def pick_many(g: int) -> list[int]:
        """The ``g`` most urgent surviving blocks, urgency-ascending.

        Stable: ties keep ascending block-id order, so ``g=1`` is the
        argmin pick.  Flags tenants whose urgency went all-inf as
        complete.
        """
        glob = np.full(n_blocks, np.inf)
        for i in range(len(tenants)):
            if not tenants[i].complete:
                u = urgency(i)
                if np.isinf(u).all():
                    tenants[i].complete = True
                else:
                    glob = np.minimum(glob, u)
        live = np.flatnonzero(np.isfinite(glob))
        if live.size == 0:
            return []
        return [int(b) for b in
                live[np.argsort(glob[live], kind="stable")[:g]]]

    # per-tenant group dispatchers share one fetched-this-step map, so
    # each block is read once for the whole fleet
    fetched: dict[int, torch.Tensor] = {}
    disps = [engine._GroupDispatcher(index, t.plan, t.state.block_lb,
                                     fetched.__getitem__, None)
             for t in tenants]

    steps = 0
    while True:
        gids = pick_many(group_blocks)
        if not gids:
            break                          # every tenant proved complete
        if budget is not None:
            if steps >= budget:
                break                      # deadline: states are anytime now
            gids = gids[:budget - steps]   # partial final group: cut to fit
        for b in gids[1:]:
            speculate(b)                   # overlap the group's own reads
        fetched.clear()
        for b in gids:
            fetched[b] = fetch(b)
        for i, t in enumerate(tenants):
            sel = [b for b in gids if not refined[i][b]]
            for b in sel:
                refined[i][b] = True       # needed or not, never revisit:
            # host-side cut under this tenant's (possibly one-group-
            # stale) threshold; the device re-checks per block
            sel = [b for b in sel if (lbs[i][:, b] < thrs[i]).any()]
            if not sel:
                continue                   # bounds only tighten from here
            front, stats = disps[i](t.state.qs, t.state.front,
                                    t.state.stats, sel)   # async dispatch
            t.state = dataclasses.replace(t.state, front=front, stats=stats)
            walked[i].update(sel)
        steps += len(gids)
        # speculate the next depth-D targets under the PRE-sync thresholds
        # (the bound only tightens: a wasted read stays cached under its
        # id), then pay the one sync per tenant this group cost
        for b in pick_many(pipeline_depth):
            speculate(b)
        for i, t in enumerate(tenants):
            if not t.complete:
                thrs[i] = t.state.front.threshold().cpu().numpy()  # sync: 1/group

    for i, t in enumerate(tenants):
        t.state = dataclasses.replace(
            t.state, refined=t.state.refined | frozenset(walked[i]))
        if not t.complete:                 # re-check under final thresholds
            t.complete = bool(np.isinf(urgency(i)).all())
    return steps
