"""Certified anytime answers (``repro.serve.anytime``).

The MESSI/ParIS+ answer discipline is approximate-then-exact: return a
good answer at once, certify or refine it as budget allows.  A
deadline-cut walk (``engine.run_cached`` with ``deadline_blocks``, or a
budgeted ``serve.coalesced_walk``) ends holding everything needed to
make that discipline *certified*:

  * the frontier's distances are EXACT distances of real candidates, so
    the reported k-th distance bounds the true k-th distance from above,
    for any deadline;
  * every unrefined block's envelope lower bound under-estimates every
    member's distance (the index's no-false-dismissal bound), so the
    minimum envelope LB over the deferred blocks, clipped at the
    reported k-th, bounds the true k-th from below.

``certify`` turns a walk's end state into that two-sided
``AnytimeCertificate``; when the interval is empty the anytime answer IS
the exact answer and the certificate says so.  ``AnytimeResult`` carries
the certificate beside the answer and the walk's resumable state;
``refine_to_exact()`` feeds it back through the session, reaching the
exact answer bit for bit while refining only the deferred blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.frontier import INF, SearchStats
from repro_torch.storage.ooc_search import IOStats


class AnytimeCertificate(NamedTuple):
    """Two-sided per-query bound on the true k-th distance (sqrt domain).

    ``lower[q] <= true_kth[q] <= upper[q]``: ``upper`` is the reported
    answer's own k-th distance (an exact distance of a real candidate;
    INF while fewer than k real candidates have been seen), ``lower`` the
    minimum envelope lower bound over blocks not yet refined, clipped
    into [0, upper].  ``exact[q]`` means the interval is empty: no
    deferred block can beat the reported k-th, so the anytime answer is
    certifiably the exact one.  ``blocks_deferred[q]`` counts the
    deferred blocks that could still matter (envelope LB below
    ``upper``): at most what ``refine_to_exact`` will refine.
    """
    upper: np.ndarray            # (Q,) reported k-th distance (sqrt'd)
    lower: np.ndarray            # (Q,) certified floor on the true k-th
    exact: np.ndarray            # (Q,) bool: answer certified exact
    blocks_deferred: np.ndarray  # (Q,) int: deferred blocks below upper

    @property
    def gap(self) -> np.ndarray:
        """(Q,) certified uncertainty ``upper - lower``; 0 when exact."""
        return self.upper - self.lower


def certify(state: engine.PreparedSearch) -> AnytimeCertificate:
    """Certificate for a walk end state (``run_cached``'s third return).

    Host arithmetic over state the walk already holds: the frontier
    (exact candidate distances), the (Q, B) envelope lower bounds and
    the set of refined block ids.  Comparisons are in the squared domain
    the walk prunes in; the reported bounds are sqrt'd to match
    ``SearchResult.dist``.
    """
    dists = state.front.dists.cpu().numpy()          # (Q, K) squared
    ids = state.front.ids.cpu().numpy()
    block_lb = state.block_lb.cpu().numpy()          # (Q, B) squared
    qn, n_blocks = block_lb.shape

    upper_sq = dists[:, -1]                          # k-th best so far
    deferred = np.ones(n_blocks, dtype=bool)
    if state.refined:
        deferred[np.fromiter(state.refined, dtype=np.int64)] = False
    if deferred.any():
        rem_sq = block_lb[:, deferred].min(axis=1)   # (Q,)
        n_live = np.sum(block_lb[:, deferred] < upper_sq[:, None], axis=1)
    else:
        rem_sq = np.full(qn, np.float32(INF))
        n_live = np.zeros(qn, dtype=np.int64)
    exact = rem_sq >= upper_sq
    lower_sq = np.clip(rem_sq, 0.0, upper_sq)

    # the sqrt domain of SearchResult.dist; a frontier slot still empty
    # (id < 0) keeps the INF convention rather than sqrt(float32 max)
    full = ids[:, -1] >= 0
    upper = np.where(full, np.sqrt(upper_sq), np.float32(INF))
    lower = np.where(full, np.sqrt(lower_sq),
                     np.sqrt(np.maximum(rem_sq, 0.0)))
    return AnytimeCertificate(upper=upper.astype(np.float32),
                              lower=lower.astype(np.float32),
                              exact=exact,
                              blocks_deferred=n_live.astype(np.int64))


class AnytimeResult(NamedTuple):
    """An anytime answer: the current top-k, its certificate, and the
    continuation that upgrades it to exact.

    The leading fields match ``storage.OocSearchResult``, so an anytime
    answer drops into any consumer of one; ``certificate`` bounds the
    true k-th distance; ``resume`` is the session-scoped continuation
    (a ``storage.PreparedRound``).  ``refine_to_exact()`` consumes it:
    dist, idx and stats bit-identical to an exact cold search of the
    same queries, refining only the blocks the deadline deferred.
    """
    dist: torch.Tensor           # (Q, K) current k-NN distances, ascending
    idx: torch.Tensor            # (Q, K) candidate ids; -1 = empty slot
    stats: SearchStats
    io: IOStats
    certificate: AnytimeCertificate
    resume: object               # storage.PreparedRound
    queries: torch.Tensor        # the submitted batch, for the continuation

    @property
    def nn_dist(self) -> torch.Tensor:
        return self.dist[..., 0]

    @property
    def nn_idx(self) -> torch.Tensor:
        return self.idx[..., 0]

    def refine_to_exact(self):
        """Resume the deferred walk to the exact answer. -> OocSearchResult.

        Runs on the session that produced this answer, through the same
        cache: blocks the anytime phase fetched (or speculated) are served
        warm.  The result is bit-identical to a from-scratch exact search
        of the same queries (dist, idx and cumulative stats), but refines
        strictly fewer blocks.  Its ``io`` is its own bill: the anytime
        phase's reads were billed to the anytime result.
        """
        r = self.resume
        if r is None or r.consumed:
            raise ValueError("this anytime answer's continuation is already "
                             "consumed — refine_to_exact resumes exactly "
                             "once (keep the returned exact result)")
        return r.session.search(self.queries, k=r.plan.k,
                                metric=r.plan.metric, prepared=r)
