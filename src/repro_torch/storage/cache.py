"""Device-resident LRU block cache + stateful serving sessions
(``repro.storage.cache``).

The paper's serving claim is two-sided: ParIS+ answers from disk in
seconds by overlapping I/O with compute, MESSI answers from memory in
milliseconds by assuming a hot working set.  A serving process sits
between the two: the dataset does not fit on the device, but query
traffic repeats, so the blocks that keep surviving pruning ARE a working
set.  This module makes that working set explicit:

  * ``BlockCache`` — a capacity-bounded LRU of device-resident raw
    blocks, keyed by *block id*.  Every fetch and prefetch goes through
    it: a speculative read lands in the cache under its id, so a block
    whose schedule slot is pruned before its turn waits there for a
    later query or batch.  Reads run on a pool of ``readers`` threads
    with a bounded in-flight set.  On the card each reader copies
    through two reusable pinned host buffers on its own side stream and
    records an event; ``get`` makes the consumer's stream wait on that
    event and records the block on the consumer's stream, so eviction
    never recycles memory a queued kernel still reads.

  * ``SearchSession`` — a stateful wrapper holding one ``BlockCache``
    across query batches.  The walk is ``engine.run_cached``: the same
    block-major schedule as the device backend, driven through this
    session's fetch/speculate callbacks, so the session is
    metric-generic (``metric=DTW(r)``, ``metric=Cosine()``).

Accounting is per batch: ``IOStats.bytes_read`` / ``blocks_fetched``
count actual disk reads only (each block at most once per batch: the
``pipeline_depth + group_blocks`` capacity floor and the bounded
in-flight set rule out an evict-refetch cycle), while
``IOStats.cache_hits`` counts surviving blocks served from the cache.
A two-round run is ONE billing unit: ``approximate_threshold`` returns a
``PreparedRound`` owning round 1's touch-set and disk reads, and the
``search(..., prepared=...)`` that consumes it bills them.  A coalesced
drain (``submit`` / ``drain``, the ``serve`` package) is one unit too,
billed once for all the batches it answers.  ``search(deadline_blocks=...)``
returns a certified ``serve.AnytimeResult`` whose ``refine_to_exact()``
resumes the walk through this session.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core import engine
from repro_torch.core import frontier as frontier_lib
from repro_torch.core.index import BlockIndex, HostRawBlocks
from repro_torch.device import resolve_device
from repro_torch.storage.ooc_search import IOStats, OocSearchResult

class _Staging(threading.local):
    """A reader thread's copy state on the card: its side stream, two
    pinned (C, n) host buffers used in turn, and each buffer's last copy
    event (the buffer is refilled only after that copy has landed)."""
    stream = None
    pinned = None
    copied = None
    slot = 0


@sanitize.guarded
class BlockCache:
    """Capacity-bounded LRU of device-resident raw blocks, keyed by block id.

    A pool of ``readers`` background threads serves ``prefetch``/``get``
    misses in request order; a completed read inserts itself into the
    LRU under the lock, so an in-flight block is never orphaned: whoever
    requested it (or nobody: a pruned speculation) finds it cached.
    Eviction just drops the reference.

    Speculative reads are *bounded*: ``prefetch`` declines (a silent
    no-op) once ``max_inflight`` reads are outstanding; demand ``get``
    misses are never declined.

    ``disk_blocks`` / ``disk_bytes`` are cumulative disk-read counters
    (sessions take per-batch deltas); ``demand_misses`` counts ``get``
    calls that found their block neither resident nor in flight — the
    stalls the pipeline was supposed to hide.
    """

    def __init__(self, host: HostRawBlocks, capacity_blocks: int, *,
                 readers: int = 2, max_inflight: int | None = None,
                 device: str | torch.device | None = "cuda"):
        if capacity_blocks < 2:
            # one block in refinement plus one outstanding prefetch; below
            # 2 the prefetch could evict the block it was meant to overlap
            raise ValueError(
                f"capacity_blocks must be >= 2, got {capacity_blocks}")
        if readers < 1:
            raise ValueError(f"readers must be >= 1, got {readers}")
        if max_inflight is None:
            max_inflight = 2 * readers
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.host = host
        self.capacity_blocks = capacity_blocks
        self.readers = readers
        self.max_inflight = max_inflight
        self.device = resolve_device(device)
        self._staging = _Staging()
        self._lock = sanitize.create_lock()
        self._closed = False                       # guarded by: _lock
        # block id -> (tensor, copy event or None)
        self._lru: OrderedDict[int, tuple] = OrderedDict()  # guarded by: _lock
        self._inflight: dict[int, Future] = {}     # guarded by: _lock
        self._reader = ThreadPoolExecutor(readers,
                                          thread_name_prefix="block-read")
        self.disk_blocks = 0                       # guarded by: _lock
        self.disk_bytes = 0                        # guarded by: _lock
        self.demand_misses = 0                     # guarded by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def __contains__(self, block_id: int) -> bool:
        """Resident or in flight — either way no new disk read is needed."""
        with self._lock:
            return block_id in self._lru or block_id in self._inflight

    def _side(self) -> _Staging:
        """This reader thread's staging state, made on its first read."""
        st = self._staging
        if st.stream is None:
            torch.cuda.set_device(self.device)
            _, c, n = self.host.blocks.shape
            st.stream = torch.cuda.Stream(self.device)
            st.pinned = [torch.empty((c, n), dtype=torch.float32,
                                     pin_memory=True) for _ in range(2)]
            st.copied = [None, None]
        return st

    def _to_device(self, block: np.ndarray) -> tuple:
        """Host block -> (device tensor, copy event or None)."""
        if self.device.type != "cuda":
            return torch.from_numpy(
                np.require(block, np.float32, ["C", "W"])), None
        st = self._side()
        slot, st.slot = st.slot, 1 - st.slot
        if st.copied[slot] is not None:
            st.copied[slot].synchronize()        # its last copy has landed
        st.pinned[slot].numpy()[...] = block
        with torch.cuda.stream(st.stream):
            dev = torch.empty(block.shape, dtype=torch.float32,
                              device=self.device)
            dev.copy_(st.pinned[slot], non_blocking=True)
            done = torch.cuda.Event()
            done.record(st.stream)
        st.copied[slot] = done
        return dev, done

    def _read(self, block_id: int) -> tuple:
        """Reader-thread body: disk -> host copy -> device, then publish."""
        try:
            blk = self._to_device(self.host.fetch(block_id))
        except BaseException:
            # a failed read must not poison the cache: drop the in-flight
            # entry so the block no longer looks present and the next
            # request retries; whoever waits on this future sees the error
            with self._lock:
                self._inflight.pop(block_id, None)
            raise
        with self._lock:
            self.disk_blocks += 1
            self.disk_bytes += self.host.block_nbytes
            if self._inflight.pop(block_id, None) is not None:
                self._insert(block_id, blk)
        return blk

    def _insert(self, block_id: int, blk: tuple) -> None:
        # caller holds self._lock
        self._lru[block_id] = blk
        while len(self._lru) > self.capacity_blocks:
            self._lru.popitem(last=False)

    def _consume(self, blk: tuple) -> torch.Tensor:
        """Hand a block to the calling thread's stream: wait for its copy,
        and tie its memory to this stream's queued work."""
        dev, done = blk
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            dev.record_stream(stream)
        return dev

    def prefetch(self, block_id: int) -> None:
        """Start reading ``block_id`` in the background; no-op if present,
        in flight, at the ``max_inflight`` bound, or after ``close``."""
        with self._lock:
            if self._closed:
                return                   # a late speculation is droppable
            if block_id in self._lru:
                self._lru.move_to_end(block_id)
                return
            if (block_id not in self._inflight
                    and len(self._inflight) < self.max_inflight):
                self._inflight[block_id] = self._reader.submit(
                    self._read, block_id)

    def get(self, block_id: int) -> torch.Tensor:
        """The (C, n) device block; blocks only if a disk read is needed."""
        with self._lock:
            if self._closed:
                raise ValueError("BlockCache is closed")
            blk = self._lru.get(block_id)
            if blk is not None:
                self._lru.move_to_end(block_id)
            else:
                fut = self._inflight.get(block_id)
                if fut is None:
                    # a demand miss is never declined, and is exactly a
                    # pipeline stall: nothing had speculated the read
                    self.demand_misses += 1
                    fut = self._reader.submit(self._read, block_id)
                    self._inflight[block_id] = fut
        if blk is None:
            blk = fut.result()
        return self._consume(blk)

    def drain(self) -> None:
        """Wait for every in-flight read to land (settles the counters).

        Each round snapshots ALL outstanding futures and waits them out,
        looping in case a racing ``prefetch`` submitted more.  A failed
        read is swallowed here: it was speculative, read no bytes, and
        removed its own in-flight entry.
        """
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            if not futs:
                return
            for f in futs:
                try:
                    f.result()
                except Exception:
                    pass

    def clear(self) -> None:
        """Drop every cached block once the reads in flight have landed
        (the counters keep their totals)."""
        self.drain()
        with self._lock:
            self._lru.clear()

    def close(self) -> None:
        """Stop the readers and drop every cached block (idempotent, and
        safe with reads still in flight: outstanding reads finish and
        publish, the pool shuts down, THEN the LRU drops — so no reader
        can resurrect an entry after the clear, and the disk counters
        settle to exactly the reads performed)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True          # new prefetches decline from here
        self.drain()
        self._reader.shutdown(wait=True)
        with self._lock:
            self._lru.clear()


class PreparedRound:
    """Round-1 state plus its bill, scoped to one two-round run.

    Returned by ``SearchSession.approximate_threshold`` and consumed by
    exactly one ``SearchSession.search(..., prepared=...)`` on the SAME
    session: the engine's resumable ``PreparedSearch`` together with the
    disk reads round 1 made and its touch-set.  If round 2 never runs,
    the object is dropped and its reads are billed to no batch.

    ``np.asarray(prepared)`` yields the (Q,) squared k-th-best threshold.
    """

    def __init__(self, session: "SearchSession", plan, qsig,
                 state, carry_blocks: int, carry_bytes: int,
                 touched: set, hits: int):
        self.session = session
        self.plan = plan
        self.qsig = qsig
        self.state = state                   # engine.PreparedSearch
        self.carry_blocks = carry_blocks
        self.carry_bytes = carry_bytes
        self.touched = touched
        self.hits = hits
        self.consumed = False
        self.threshold = state.front.threshold().cpu().numpy()   # (Q,)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.threshold, dtype=dtype)


def _query_signature(queries: torch.Tensor) -> tuple:
    """Cheap content fingerprint binding a PreparedRound to its batch."""
    q = queries.cpu().numpy()
    return (q.shape, str(q.dtype), hash(q.tobytes()))


class _TouchTracker:
    """One accounting unit's fetch/speculate callbacks over a cache.

    The first touch of each block id decides hit vs miss exactly once per
    unit; later touches count nothing.  A resumed round 2 constructs the
    tracker from round 1's carried touch-set, continuing the same unit.
    """

    def __init__(self, cache: BlockCache, touched: set | None = None,
                 hits: int = 0):
        self.cache = cache
        self.touched = set() if touched is None else touched
        self.hits = hits
        # snapshot the disk counters so the unit's deltas are its own
        self._reads0 = cache.disk_blocks
        self._bytes0 = cache.disk_bytes

    def _touch(self, b: int) -> None:
        if b not in self.touched:
            self.touched.add(b)
            if b in self.cache:
                self.hits += 1

    def fetch(self, b: int) -> torch.Tensor:
        self._touch(b)
        return self.cache.get(b)

    def speculate(self, b: int) -> None:
        self._touch(b)
        self.cache.prefetch(b)

    @property
    def disk_blocks(self) -> int:
        return self.cache.disk_blocks - self._reads0

    @property
    def disk_bytes(self) -> int:
        return self.cache.disk_bytes - self._bytes0


@sanitize.guarded
class SearchSession:
    """Stateful out-of-core serving: one block cache across query batches.

    >>> sess = SearchSession(storage.open_index(path), cache_blocks=64)
    >>> r1 = sess.search(queries, k=5)          # cold: disk reads
    >>> r2 = sess.search(queries, k=5)          # warm: cache hits
    >>> assert r2.io.bytes_read == 0            # when all survivors fit

    Results are bit-identical to ``ooc_search`` on the same index and
    queries — the cache changes what is read, never what is answered.
    ``device`` (the card unless the caller asks for the CPU) is where the
    walk runs; the index must have been opened there.
    """

    def __init__(self, index: BlockIndex, *, cache_blocks: int = 64,
                 readers: int = 2, pipeline_depth: int = 1,
                 group_blocks: int = 1,
                 device: str | torch.device | None = "cuda"):
        if index.host_raw is None:
            raise ValueError("index has no host_raw — open it with "
                             "storage.open_index (or pass a built index to "
                             "core.search instead)")
        self.device = resolve_device(device)
        if index.device != self.device:
            raise ValueError(f"the index was opened on {index.device}, "
                             f"not on {self.device}")
        if pipeline_depth < 1 or group_blocks < 1:
            raise ValueError(
                f"pipeline_depth and group_blocks must be >= 1, got "
                f"({pipeline_depth}, {group_blocks})")
        if cache_blocks < pipeline_depth + group_blocks:
            # one group of G blocks being refined plus D speculative reads
            # landing behind it; below D + G a landing speculation could
            # evict a group member and force a same-batch re-read
            raise ValueError(
                f"cache_blocks must cover the pipeline: >= pipeline_depth "
                f"+ group_blocks = {pipeline_depth + group_blocks}, got "
                f"{cache_blocks}")
        self.index = index
        self.pipeline_depth = pipeline_depth
        self.group_blocks = group_blocks
        self.cache = BlockCache(
            index.host_raw, cache_blocks, readers=readers,
            max_inflight=max(2 * readers, pipeline_depth + group_blocks),
            device=self.device)
        self.batches = 0
        self.cache_hits = 0
        self.blocks_fetched = 0
        self.last_telemetry: dict = {}
        self._closed = False
        # built lazily on first submit()
        self._coalescer = None         # guarded by: _coalescer_lock
        self._coalescer_lock = sanitize.create_lock()

    def _knobs(self, pipeline_depth: int | None,
               group_blocks: int | None) -> tuple[int, int]:
        """Per-call override of the session's pipeline knobs (None =
        session default), validated against the cache capacity."""
        d = self.pipeline_depth if pipeline_depth is None else pipeline_depth
        g = self.group_blocks if group_blocks is None else group_blocks
        if d < 1 or g < 1:
            raise ValueError(f"pipeline_depth and group_blocks must be "
                             f">= 1, got ({d}, {g})")
        if d + g > self.cache.capacity_blocks:
            raise ValueError(
                f"pipeline_depth + group_blocks = {d + g} exceeds the "
                f"session's cache capacity ({self.cache.capacity_blocks} "
                "blocks); enlarge cache_blocks or shrink the pipeline")
        return d, g

    @property
    def hit_rate(self) -> float:
        """Fraction of surviving-block touches served without disk I/O."""
        return self.cache_hits / max(self.cache_hits + self.blocks_fetched, 1)

    def close(self) -> None:
        """Release the cache's reader threads and device blocks
        (idempotent).  Submitted but undrained tickets are NOT answered:
        drain first."""
        if self._closed:
            return
        self._closed = True
        self.cache.close()

    def __enter__(self) -> "SearchSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _bill(self, tracker: _TouchTracker, *, carry_blocks: int = 0,
              carry_bytes: int = 0, batches: int = 1,
              blocks_refined: int = 0) -> IOStats:
        """Close out one accounting unit: its ``IOStats``, rolled into the
        session totals.  ``carry_*`` are disk reads billed into this unit
        from a resumed round 1; ``batches`` is how many query batches the
        unit answered (a coalesced drain bills once for N);
        ``blocks_refined`` is how many distinct blocks the unit's walks
        refined."""
        fetched = tracker.disk_blocks + carry_blocks
        io = IOStats(bytes_read=tracker.disk_bytes + carry_bytes,
                     bytes_scan=(self.index.n_real * self.index.n
                                 * self.index.host_raw.dtype.itemsize),
                     blocks_fetched=fetched,
                     blocks_total=self.index.n_blocks,
                     cache_hits=tracker.hits,
                     blocks_refined=blocks_refined)
        self.batches += batches
        self.cache_hits += tracker.hits
        self.blocks_fetched += fetched
        return io

    def _plan(self, k: int, lb_filter: bool, normalize_queries: bool,
              metric) -> engine.QueryPlan:
        if metric is None:
            metric = engine.ED(normalize=normalize_queries,
                               lb_filter=lb_filter)
        return engine.QueryPlan(metric=metric, schedule="block_major", k=k)

    def approximate_threshold(self, queries, *, k: int = 1,
                              lb_filter: bool = True,
                              normalize_queries: bool = True,
                              metric=None,
                              pipeline_depth: int | None = None,
                              group_blocks: int | None = None
                              ) -> PreparedRound:
        """Stage A only -> a resumable ``PreparedRound`` (round 1).

        Each query's best-envelope block is refined;
        ``PreparedRound.threshold`` is the (Q,) squared k-th best.  Pass
        the object to ``search(..., prepared=...)`` and round 2 resumes
        it — no re-prep, no re-ranking, no re-fetch or re-refine of
        stage-A blocks — with round 1's disk reads billed into that
        batch's ``IOStats``.
        """
        queries = torch.as_tensor(queries, device=self.device)
        plan = self._plan(k, lb_filter, normalize_queries, metric)
        d, g = self._knobs(pipeline_depth, group_blocks)
        tracker = _TouchTracker(self.cache)
        state = engine.run_cached_stage_a(
            self.index, queries, plan,
            fetch=tracker.fetch, speculate=tracker.speculate,
            pipeline_depth=d, group_blocks=g)
        self.cache.drain()
        return PreparedRound(self, plan, _query_signature(queries), state,
                             carry_blocks=tracker.disk_blocks,
                             carry_bytes=tracker.disk_bytes,
                             touched=tracker.touched, hits=tracker.hits)

    def _check_prepared(self, prepared: PreparedRound, plan, qsig) -> None:
        if prepared.session is not self:
            raise ValueError("prepared round belongs to a different "
                             "SearchSession — round 2 must run on the "
                             "session whose approximate_threshold made it")
        if prepared.consumed:
            raise ValueError("prepared round already consumed — each "
                             "PreparedRound resumes exactly one search()")
        if prepared.plan != plan:
            raise ValueError(f"prepared round was built for plan "
                             f"{prepared.plan} but search() asks {plan}; "
                             "k/metric/lb_filter must match round 1")
        if prepared.qsig != qsig:
            raise ValueError("prepared round was built for a different "
                             "query batch — its frontier and block "
                             "ranking do not apply to these queries")

    def search(self, queries, *, k: int = 1, lb_filter: bool = True,
               normalize_queries: bool = True, metric=None,
               initial_threshold=None,
               prepared: PreparedRound | None = None,
               deadline_blocks: int | None = None,
               pipeline_depth: int | None = None,
               group_blocks: int | None = None):
        """Exact k-NN for one (Q, n) query batch through the cache.

        The walk is ``engine.run_cached``: envelope ranking, stage-A
        seeding and suffix-min stopping, with every fetch and speculative
        prefetch going through the id-keyed cache.  ``metric`` picks the
        plan's metric (default ``ED``; ``lb_filter`` /
        ``normalize_queries`` fold into the default and are ignored when
        a metric is given).  ``initial_threshold`` (squared) seeds the
        pruning bound and never appears in the result.  ``prepared``
        resumes a round-1 ``PreparedRound`` from this session's
        ``approximate_threshold`` (same queries and plan) or an anytime
        answer's continuation: the walk skips stage A and every refined
        block, and this batch's ``IOStats`` bills the round's carried
        reads and continues its touch-set.

        ``deadline_blocks`` caps the refines after stage A and makes the
        result a certified ``serve.AnytimeResult`` (the current top-k, a
        two-sided bound on the true k-th distance, and a
        ``refine_to_exact()`` continuation); ``None`` returns the exact
        ``OocSearchResult``.  A deadline cannot be combined with
        ``initial_threshold`` or ``prepared``: an anytime answer starts a
        fresh batch.

        ``pipeline_depth`` / ``group_blocks`` override the session's walk
        pipeline for this batch; answers are bit-identical for every
        setting.  The walk's host-side counters land in
        ``session.last_telemetry``.
        """
        queries = torch.as_tensor(queries, device=self.device)
        plan = self._plan(k, lb_filter, normalize_queries, metric)
        d, g = self._knobs(pipeline_depth, group_blocks)
        if deadline_blocks is not None:
            if deadline_blocks < 1:
                raise ValueError(f"deadline_blocks must be >= 1 (or None "
                                 f"for an exact search), "
                                 f"got {deadline_blocks}")
            if initial_threshold is not None or prepared is not None:
                raise ValueError("deadline_blocks cannot be combined with "
                                 "initial_threshold or prepared — an "
                                 "anytime answer starts a fresh batch")

        # one touch-set per two-round run (see _TouchTracker), so a block
        # round 1 fetched is never re-counted as a warm hit in round 2
        if prepared is not None:
            self._check_prepared(prepared, plan, _query_signature(queries))
            prepared.consumed = True
            tracker = _TouchTracker(self.cache, prepared.touched,
                                    prepared.hits)
            carry_blocks, carry_bytes = (prepared.carry_blocks,
                                         prepared.carry_bytes)
        else:
            tracker = _TouchTracker(self.cache)
            carry_blocks = carry_bytes = 0

        run_plan = (plan if deadline_blocks is None else
                    dataclasses.replace(plan,
                                        deadline_blocks=deadline_blocks))
        tel: dict = {}
        front, stats, state = engine.run_cached(
            self.index, queries, run_plan,
            fetch=tracker.fetch, speculate=tracker.speculate,
            initial_threshold=initial_threshold,
            prepared=None if prepared is None else prepared.state,
            pipeline_depth=d, group_blocks=g, telemetry=tel)
        self.last_telemetry = tel

        self.cache.drain()  # settle the last speculation into this bill
        io = self._bill(tracker, carry_blocks=carry_blocks,
                        carry_bytes=carry_bytes,
                        blocks_refined=len(state.refined))
        dist = frontier_lib.result_dists(front)
        if deadline_blocks is None:
            return OocSearchResult(dist=dist, idx=front.ids, stats=stats,
                                   io=io)
        from repro_torch.serve.anytime import AnytimeResult, certify
        resume = PreparedRound(self, plan, _query_signature(queries), state,
                               carry_blocks=0, carry_bytes=0,
                               touched=set(), hits=0)
        return AnytimeResult(dist=dist, idx=front.ids, stats=stats, io=io,
                             certificate=certify(state), resume=resume,
                             queries=queries)

    # -- concurrent serving (serve.AdmissionCoalescer) -------------------

    def submit(self, queries, *, k: int = 1, lb_filter: bool = True,
               normalize_queries: bool = True, metric=None):
        """Admit a query batch for coalesced serving -> ``serve.Ticket``.

        Thread-safe and non-blocking: concurrent callers each get a ticket
        at once; the next ``drain()`` (or the first caller to block on
        ``Ticket.result()``) answers every pending ticket in ONE coalesced
        priority walk, each block read from disk at most once for all of
        them.  Answers are bit-identical to ``search`` on each batch
        alone.
        """
        return self._get_coalescer().submit(
            queries, self._plan(k, lb_filter, normalize_queries, metric))

    def _get_coalescer(self):
        """The session's coalescer, made on first use.  The whole
        check-create-read runs under the lock, so no thread can see the
        reference before the coalescer's own fields."""
        with self._coalescer_lock:
            if self._coalescer is None:
                from repro_torch.serve.coalescer import AdmissionCoalescer
                self._coalescer = AdmissionCoalescer(self)
            return self._coalescer

    def drain(self, *, deadline_blocks: int | None = None) -> list:
        """Answer every pending ``submit`` in one coalesced walk.

        Returns the resolved tickets (an empty list if nothing is
        pending).  With ``deadline_blocks`` the shared walk stops after
        that many refines past stage A, and unfinished tickets resolve to
        certified ``serve.AnytimeResult``s instead of exact results.
        """
        with self._coalescer_lock:
            co = self._coalescer
        if co is None:
            return []
        return co.drain(deadline_blocks=deadline_blocks)
