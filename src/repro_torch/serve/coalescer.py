"""Admission coalescing for concurrent sessions (``repro.serve.coalescer``).

Under mixed traffic, one ``SearchSession.search`` at a time means exact
queries queue behind each other.  The coalescer is the admission layer in
front of the session: concurrent callers ``submit()`` their batches and
get a ``Ticket`` at once; a ``drain()`` admits everything pending as one
fleet of tenants and answers them through a single
``serve.coalesced_walk`` — every block fetched once for all tenants that
still need it, through the session's one ``BlockCache``.

Submissions with the SAME plan (metric, k, filter flags) merge into one
tenant: their queries ride one (ΣQ, n) panel through every refine, and
split back into per-ticket rows at resolution.  Submissions with
different plans stay separate tenants but still share every fetch.

``Ticket.result()`` blocks until its drain has run; the first caller to
ask becomes the drainer for the whole admitted window (everyone else
waits on their event), so a fleet of threads that all submit-then-wait
serves itself.  Accounting: one drain is one bill — the first touch of
each block across ALL tenants decides hit vs miss once, so
``blocks_fetched`` measures the coalesced union, comparable with N
isolated sessions fetching the sum.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.analysis import sanitize
from repro_torch.core import engine
from repro_torch.core import frontier as frontier_lib
from repro_torch.core.frontier import Frontier, SearchStats
from repro_torch.serve.anytime import AnytimeResult, certify
from repro_torch.serve.scheduler import TenantRun, coalesced_walk, prepare_tenant
from repro_torch.storage.cache import (PreparedRound, _query_signature,
                                       _TouchTracker)
from repro_torch.storage.ooc_search import OocSearchResult


class Ticket:
    """Handle for one submitted query batch.

    ``result()`` returns the batch's ``OocSearchResult`` (exact) or
    ``serve.AnytimeResult`` (a budgeted drain cut this tenant short),
    draining the session's pending admissions first if nobody else has.
    """

    def __init__(self, coalescer: "AdmissionCoalescer",
                 queries: torch.Tensor, plan: engine.QueryPlan):
        self._coalescer = coalescer
        self.queries = queries
        self.plan = plan
        self._done = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, result=None, error=None) -> None:
        self._result = result
        self._error = error
        self._done.set()

    def result(self, timeout: float | None = None):
        if not self._done.is_set():
            # either we become the drainer, or we wait out whoever is
            # mid-drain holding our ticket and find it resolved after
            self._coalescer.drain()
        if not self._done.wait(timeout):
            raise TimeoutError("ticket not resolved within timeout")
        if self._error is not None:
            raise self._error
        return self._result


def _slice_state(state: engine.PreparedSearch, sl: slice
                 ) -> engine.PreparedSearch:
    """Rows ``sl`` of a merged tenant's walk state, as a standalone
    resumable state for that ticket's queries.  Every leaf is per-query on
    its leading axis (metric aux tensors included); ``refined`` is shared:
    those blocks were refined against the whole merged panel, so the
    sliced frontier rows already reflect them."""
    qs = engine.QueryState(q=state.qs.q[sl],
                           aux=tuple(a[sl] for a in state.qs.aux))
    return engine.PreparedSearch(
        qs=qs,
        front=Frontier(dists=state.front.dists[sl], ids=state.front.ids[sl]),
        block_lb=state.block_lb[sl],
        stats=SearchStats(blocks_visited=state.stats.blocks_visited[sl],
                          series_refined=state.stats.series_refined[sl],
                          lb_series=state.stats.lb_series[sl],
                          iters=state.stats.iters),
        refined=state.refined)


@sanitize.guarded
class AdmissionCoalescer:
    """Pending-submission queue and the coalesced drain, bound to one
    ``storage.SearchSession`` (a session makes one on its first
    ``submit``)."""

    def __init__(self, session):
        self.session = session
        self._pending: list[Ticket] = []      # guarded by: _admit_lock
        self._admit_lock = sanitize.create_lock()
        # serializes drains; _run only ever executes under it
        self._drain_lock = sanitize.create_lock()

    def submit(self, queries, plan: engine.QueryPlan) -> Ticket:
        if plan.deadline_blocks is not None:
            raise ValueError("per-ticket deadlines are not supported: the "
                             "deadline is a property of the drain "
                             "(drain(deadline_blocks=...)) — the walk's "
                             "budget is shared by construction")
        t = Ticket(self, torch.as_tensor(queries,
                                         device=self.session.device), plan)
        with self._admit_lock:
            self._pending.append(t)
        return t

    def drain(self, *, deadline_blocks: int | None = None) -> list[Ticket]:
        """Answer every pending submission in one coalesced walk.

        Serialized: concurrent callers queue on the drain lock, and a
        ticket submitted during a running drain lands in the next one.
        With ``deadline_blocks`` the walk refines at most that many blocks
        beyond the per-tenant stage A; tenants it finished get exact
        results, the rest certified ``AnytimeResult``s whose
        ``refine_to_exact`` resumes through this same session.  If the
        walk raises, every ticket of the drain resolves to that error.
        """
        if deadline_blocks is not None and deadline_blocks < 1:
            raise ValueError(f"deadline_blocks must be >= 1 (or None for "
                             f"an exact drain), got {deadline_blocks}")
        with self._drain_lock:
            with self._admit_lock:
                batch, self._pending = self._pending, []
            if batch:
                try:
                    self._run(batch, deadline_blocks)
                except BaseException as e:
                    for t in batch:
                        if not t.done:
                            t._resolve(error=e)
                    raise
            return batch

    # -- the drain body --------------------------------------------------

    def _run(self, batch: list[Ticket], deadline_blocks: int | None) -> None:
        # caller holds _drain_lock
        session = self.session
        index = session.index

        # one bill per drain: the first touch across ALL tenants decides
        # hit vs miss once (the coalescing is what the bill measures)
        tracker = _TouchTracker(session.cache)
        fetch, speculate = tracker.fetch, tracker.speculate

        # merge same-plan tickets into one tenant (one device panel);
        # remember each ticket's row slice for the split at resolution
        groups: dict[engine.QueryPlan, list[Ticket]] = {}
        for t in batch:
            groups.setdefault(t.plan, []).append(t)
        tenants: list[TenantRun] = []
        rows: list[list[tuple[Ticket, slice]]] = []
        # the drain inherits the session's walk pipeline; answers are
        # bit-identical at every setting
        d, g = session.pipeline_depth, session.group_blocks
        for plan, tickets in groups.items():
            qs = (tickets[0].queries if len(tickets) == 1 else
                  torch.cat([t.queries for t in tickets], dim=0))
            tenants.append(prepare_tenant(index, qs, plan,
                                          fetch=fetch, speculate=speculate,
                                          pipeline_depth=d, group_blocks=g))
            sls, at = [], 0
            for t in tickets:
                qn = t.queries.shape[0]
                sls.append((t, slice(at, at + qn)))
                at += qn
            rows.append(sls)

        coalesced_walk(index, tenants, fetch=fetch, speculate=speculate,
                       budget=deadline_blocks,
                       pipeline_depth=d, group_blocks=g)
        session.cache.drain()            # settle speculations into this bill
        union = set().union(*(t.state.refined for t in tenants))
        io = session._bill(tracker, batches=len(batch),
                           blocks_refined=len(union))

        for tenant, sls in zip(tenants, rows):
            display = tenant.plan.metric.finalize_stats(
                tenant.state.stats, index.capacity)
            dist = frontier_lib.result_dists(tenant.state.front)
            for ticket, sl in sls:
                ticket._resolve(self._make_result(ticket, tenant, sl, dist,
                                                  display, io))

    def _make_result(self, ticket: Ticket, tenant: TenantRun, sl: slice,
                     dist, display_stats, io):
        stats = SearchStats(
            blocks_visited=display_stats.blocks_visited[sl],
            series_refined=display_stats.series_refined[sl],
            lb_series=display_stats.lb_series[sl],
            iters=display_stats.iters)
        if tenant.complete:
            return OocSearchResult(dist=dist[sl],
                                   idx=tenant.state.front.ids[sl],
                                   stats=stats, io=io)
        state = _slice_state(tenant.state, sl)
        resume = PreparedRound(self.session, ticket.plan,
                               _query_signature(ticket.queries), state,
                               carry_blocks=0, carry_bytes=0,
                               touched=set(), hits=0)
        return AnytimeResult(dist=dist[sl], idx=tenant.state.front.ids[sl],
                             stats=stats, io=io, certificate=certify(state),
                             resume=resume, queries=ticket.queries)
