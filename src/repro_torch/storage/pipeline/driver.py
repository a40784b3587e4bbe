"""The staged, sharded, resumable build driver
(``repro.storage.pipeline.driver``).

Orchestrates the full write path as restartable stages over recorded
units of work:

  runs       parallel pass-1 workers (one per source shard) each stream
             their shard through the summarize kernel and publish a
             sorted summary run file               (unit = one shard)
  merge      k-way external merge of the runs into the global block
             order, never materializing all summaries (unit = the merge)
  summaries  ids/slo/shi/elo/ehi sections computed from the merged sax
             words in block groups and written into the PARTIAL index
             file                                  (unit = the stage)
  permute    pass 2: gather each unit's rows off the source memmap in
             merged order (random reads), z-normalize on the device the
             caller names (the card by default), and positioned-write
             into the raw section (sequential writes)
                                                   (unit = a row range)
  publish    fsync + atomic rename of the partial onto the final name

Every unit records its completion in the JSON manifest (manifest.py)
only after its bytes are flushed, and every output file publishes via
temp + atomic rename — so a build killed at ANY instant resumes from
the last completed unit instead of restarting, and redoing the one
interrupted unit rewrites identical bytes (positioned writes are
idempotent).  The finished file is byte-identical to
``save_index(core.build(...))`` on the same data, whatever the shard
count, worker count, or kill/resume history (tests/test_torch_pipeline.py).

Test/bench instrumentation: the ``REPRO_BUILD_KILL_AFTER`` env var
("<stage>:<k>") SIGKILLs the process after the k-th completed unit of a
stage — a real, uncatchable kill for the crash-resume tests — and the
``fault=`` hook lets benchmarks raise ``BuildInterrupted`` in-process at
the same points.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core import index as index_lib
from repro_torch.core import isax
from repro_torch.core.index import RAW_PAD, BlockIndex
from repro_torch.device import resolve_device
from repro_torch.storage import format as format_lib
from repro_torch.storage.format import IndexFileWriter, SeriesStore
from repro_torch.storage.pipeline import merge as merge_lib
from repro_torch.storage.pipeline import runs as runs_lib
from repro_torch.storage.pipeline.manifest import (Manifest, file_ok,
                                                    file_record)

KILL_ENV = "REPRO_BUILD_KILL_AFTER"
STAGES = ("runs", "merge", "summaries", "permute", "publish")


class BuildInterrupted(RuntimeError):
    """Raised by a ``fault=`` hook to interrupt a build in-process (the
    bench's injected kill); the partial state is kept for resume."""


@dataclasses.dataclass
class StageCounters:
    built: int = 0     # units executed in THIS invocation
    reused: int = 0    # units skipped because the manifest proved them done
    seconds: float = 0.0   # wall seconds the stage took in THIS invocation


@dataclasses.dataclass
class BuildReport:
    """Instrumented per-stage unit accounting of one driver invocation —
    the resume tests assert 'only incomplete units were redone' on it.
    ``digest_s`` is the share of the wall time spent hashing files for
    the manifest (``manifest.file_digest``: records and resume checks)."""
    resumed: bool
    stages: dict[str, StageCounters]
    wall_s: float = 0.0
    digest_s: float = 0.0

    def as_dict(self) -> dict:
        return {"resumed": self.resumed, "wall_s": self.wall_s,
                "digest_s": self.digest_s,
                **{f"{s}_{f}": getattr(c, f) for s, c in self.stages.items()
                   for f in ("built", "reused", "seconds")}}


@sanitize.guarded
class _DigestClock:
    """Wall seconds spent in the manifest's file digests (worker threads
    hash concurrently, so the sum may exceed the stage's seconds)."""

    def __init__(self, report: BuildReport):
        self._lock = sanitize.create_lock()
        self._report = report    # guarded by: _lock

    def record(self, path) -> dict:
        t0 = time.perf_counter()
        rec = file_record(path)
        self._add(time.perf_counter() - t0)
        return rec

    def ok(self, path, rec: dict) -> bool:
        t0 = time.perf_counter()
        good = file_ok(path, rec)
        self._add(time.perf_counter() - t0)
        return good

    def _add(self, secs: float) -> None:
        with self._lock:
            self._report.digest_s += secs


def _maybe_kill(stage: str, done_units: int, fault) -> None:
    if fault is not None:
        fault(stage, done_units)
    spec = os.environ.get(KILL_ENV)
    if spec:
        st, _, k = spec.partition(":")
        if st == stage and done_units >= int(k):
            os.kill(os.getpid(), signal.SIGKILL)   # no cleanup, by design


@sanitize.guarded
class _UnitRecorder:
    """The one mutation point shared by concurrent stage workers:
    manifest record + report counter + fault hook, as a single atomic
    step under one lock.  ``flush`` runs inside the same critical
    section so 'recorded' still implies 'survives a SIGKILL'."""

    def __init__(self, man: Manifest, report: BuildReport, fault):
        self._lock = sanitize.create_lock()
        self._man = man          # guarded by: _lock
        self._report = report    # guarded by: _lock
        self._fault = fault

    def record(self, stage: str, uid, rec: dict | None = None, *,
               flush=None) -> None:
        with self._lock:
            if flush is not None:
                flush()          # recorded == survives a SIGKILL
            self._man.record_unit(stage, uid, rec)
            self._report.stages[stage].built += 1
            _maybe_kill(stage, self._report.stages[stage].built,
                        self._fault)


def _plan_layout(n_series: int, capacity: int, chunk: int,
                 n_shards: int) -> dict:
    cap, n_blocks, n_padded = index_lib.block_layout(n_series, capacity)
    shards = [[(i * n_series) // n_shards, ((i + 1) * n_series) // n_shards]
              for i in range(n_shards)]
    # permute unit = the monolithic builder's pass-2 step size: whole
    # blocks, at least `chunk` rows — unit boundaries are layout, recorded
    # in the manifest, so resume can never shift them under done work
    unit_rows = max(1, max(chunk, cap) // cap) * cap
    return {"cap": cap, "n_blocks": n_blocks, "n_padded": n_padded,
            "chunk": chunk, "unit_rows": unit_rows, "shards": shards}


def _lap(report: BuildReport, stage: str, t0: float) -> float:
    """Book the seconds since ``t0`` to ``stage``; -> now."""
    now = time.perf_counter()
    report.stages[stage].seconds += now - t0
    return now


def _jsonable(d: dict) -> dict:
    return json.loads(json.dumps(d))


def run_pipeline(source, out_path: str | Path, *, length: int | None = None,
                 w: int = isax.W, card: int = isax.CARD, capacity: int = 512,
                 chunk: int = 1 << 14, normalize: bool = True,
                 extra: dict | None = None, workers: int = 1,
                 shards: int | None = None,
                 work_dir: str | Path | None = None, resume: bool = True,
                 keep_work: bool = False, progress=None,
                 fault=None, device: str | torch.device | None = "cuda"
                 ) -> tuple[Path, BuildReport]:
    """Run (or resume) the staged build; -> (index path, stage report).

    Pass 1 summarizes and pass 2 z-normalizes on ``device`` (the card
    unless the caller asks for the CPU); the file's bytes equal
    ``save_index(core.build(...))`` on the same device.

    ``shards`` defaults to ``workers``; both default to the monolithic
    shape (1), which ``ooc_build.build_on_disk`` wraps.  ``work_dir``
    (default ``<out_path>.build/``) holds the manifest, run files, merge
    file, and the partial index — it must live on the same filesystem as
    ``out_path`` for the atomic publish.  On resume the manifest's
    recorded layout wins: changing ``chunk``/``workers``/``shards``
    between attempts re-sizes nothing that is already done.
    """
    dev = resolve_device(device)
    store = source if isinstance(source, SeriesStore) else \
        SeriesStore(path=Path(source), length=length)
    out_path = Path(out_path)
    n_series, n = store.n_series, store.length
    say = progress or (lambda msg: None)
    t0 = time.perf_counter()
    report = BuildReport(resumed=False,
                         stages={s: StageCounters() for s in STAGES})
    digests = _DigestClock(report)

    fingerprint = _jsonable({
        "format_version": format_lib.VERSION,
        "source": str(Path(store.path).resolve()),
        "source_bytes": store.nbytes,
        "n_series": n_series, "length": n, "w": w, "card": card,
        "capacity": capacity, "normalize": normalize,
        "extra": dict(extra or {}),
        # the card's z-norm and the CPU's differ in the last bit: a build
        # resumed on the other kind of device would mix the two
        "device": dev.type,
    })
    n_shards = max(1, min(shards if shards is not None else max(workers, 1),
                          n_series))
    layout = _plan_layout(n_series, capacity, chunk, n_shards)

    work_dir = Path(work_dir) if work_dir is not None else \
        out_path.with_name(out_path.name + ".build")
    work_dir.mkdir(parents=True, exist_ok=True)
    man = Manifest.load(work_dir / "manifest.json") if resume else None
    if man is not None and man.fingerprint == fingerprint:
        layout = man.layout                      # recorded layout wins
        report.resumed = any(man.units(s) for s in STAGES)
        if report.resumed:
            say(f"resuming from manifest: "
                + ", ".join(f"{s} {len(man.units(s))} done" for s in STAGES
                            if man.units(s)))
    else:
        if man is not None:
            say("manifest does not match this build's parameters/source — "
                "starting fresh")
        man = Manifest.fresh(work_dir / "manifest.json",
                             fingerprint=fingerprint, layout=_jsonable(layout))

    # a previous invocation finished everything but was killed between
    # publish and cleanup: the output is already complete and verified
    pub = man.units("publish").get("0")
    if pub and out_path.exists() and digests.ok(out_path, pub):
        for s in STAGES:
            report.stages[s].reused = len(man.units(s))
        report.wall_s = time.perf_counter() - t0
        say(f"{out_path} already published and verified — nothing to do")
        if not keep_work:
            shutil.rmtree(work_dir, ignore_errors=True)
        return out_path, report

    cap, n_blocks, n_padded = \
        layout["cap"], layout["n_blocks"], layout["n_padded"]
    recorder = _UnitRecorder(man, report, fault)

    # -- stage 1: sorted summary runs, one unit per shard ----------------
    t_stage = time.perf_counter()
    run_path = lambda i: work_dir / f"run-{i:05d}.dsix"
    todo = []
    for i, (a, b) in enumerate(layout["shards"]):
        rec = man.units("runs").get(str(i))
        if rec and digests.ok(run_path(i), rec):
            report.stages["runs"].reused += 1
        else:
            todo.append((i, a, b))
    if todo:
        say(f"pass 1: building {len(todo)} of {len(layout['shards'])} "
            f"sorted runs ({report.stages['runs'].reused} reused), "
            f"{workers} worker(s)")

    def _one_run(i: int, a: int, b: int) -> None:
        runs_lib.build_run(store, run_path(i), row_start=a, row_stop=b,
                           w=w, card=card, chunk=layout["chunk"],
                           normalize=normalize, device=dev)
        recorder.record("runs", i, digests.record(run_path(i)))

    if workers > 1 and len(todo) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda t: _one_run(*t), todo))
    else:
        for t in todo:
            _one_run(*t)

    t_stage = _lap(report, "runs", t_stage)

    # -- stage 2: k-way external merge -> global block order -------------
    merged_path = work_dir / "merged.dsix"
    rec = man.units("merge").get("0")
    if rec and digests.ok(merged_path, rec):
        report.stages["merge"].reused += 1
    else:
        say(f"merging {len(layout['shards'])} runs -> global block order")
        merge_lib.merge_runs([run_path(i)
                              for i in range(len(layout["shards"]))],
                             merged_path, w=w)
        recorder.record("merge", "0", digests.record(merged_path))
    t_stage = _lap(report, "merge", t_stage)
    _, merged = merge_lib.open_merge(merged_path)
    order_mm, sax_mm = merged["ids"], merged["sax"]

    # -- the partial index file (stable temp name, resumable) ------------
    wr = IndexFileWriter(out_path, n=n, w=w, card=card, capacity=cap,
                         n_real=n_series, n_blocks=n_blocks, extra=extra,
                         tmp_path=work_dir / "index.partial", resume=True)
    if not wr.resumed and (man.units("summaries") or man.units("permute")):
        # the partial vanished (or its header changed): records about its
        # contents are stale — redo those stages into the fresh file
        man.clear_stage("summaries", "permute")
        say("partial index file missing — rebuilding its sections")
    try:
        # -- stage 3: summary sections, streamed in block groups ---------
        if "0" in man.units("summaries"):
            report.stages["summaries"].reused += 1
        else:
            say("writing summary sections (ids/slo/shi/elo/ehi)")
            lo_t, hi_t = isax.region_tables(card)     # the bounds' lookup
            elo = np.empty((w, n_blocks), np.float32)
            ehi = np.empty((w, n_blocks), np.float32)
            group = max(1, layout["unit_rows"] // cap)     # blocks at once
            for g0 in range(0, n_blocks, group):
                g1 = min(g0 + group, n_blocks)
                r0, r1 = g0 * cap, g1 * cap                # padded rows
                real = min(r1, n_series) - r0
                ids_rows = np.full((r1 - r0,), -1, np.int32)
                lo = np.full((r1 - r0, w), isax.SENTINEL, np.float32)
                hi = np.full((r1 - r0, w), isax.SENTINEL, np.float32)
                if real > 0:
                    ids_rows[:real] = np.array(order_mm[r0:r0 + real])
                    sax = np.array(sax_mm[r0:r0 + real]).astype(np.int64)
                    lo[:real], hi[:real] = lo_t[sax], hi_t[sax]
                ids_b = ids_rows.reshape(g1 - g0, cap)
                slo = np.ascontiguousarray(
                    np.transpose(lo.reshape(g1 - g0, cap, w), (0, 2, 1)))
                shi = np.ascontiguousarray(
                    np.transpose(hi.reshape(g1 - g0, cap, w), (0, 2, 1)))
                el, eh = index_lib.block_envelopes(
                    torch.from_numpy(slo), torch.from_numpy(shi),
                    torch.from_numpy(ids_b))
                elo[:, g0:g1] = el.numpy()
                ehi[:, g0:g1] = eh.numpy()
                wr.write_rows("ids", g0, ids_b)
                wr.write_rows("slo", g0, slo)
                wr.write_rows("shi", g0, shi)
            wr.write_section("elo", elo)
            wr.write_section("ehi", ehi)
            recorder.record("summaries", "0", flush=wr.flush)
        t_stage = _lap(report, "summaries", t_stage)

        # -- stage 4: external permute of raw rows, unit = row range -----
        mm = store.memmap()
        unit_rows = layout["unit_rows"]
        units = [(str(u), s, min(s + unit_rows, n_series))
                 for u, s in enumerate(range(0, n_series, unit_rows))]
        if n_padded > n_series:
            units.append(("pad", n_series, n_padded))
        todo_u = [u for u in units if u[0] not in man.units("permute")]
        report.stages["permute"].reused = len(units) - len(todo_u)
        if todo_u:
            say(f"pass 2: permuting {len(todo_u)} of {len(units)} raw "
                f"units ({report.stages['permute'].reused} reused)")

        def _one_unit(uid: str, s: int, e: int) -> None:
            if uid == "pad":
                rows = np.full((e - s, n), RAW_PAD, np.float32)
            else:
                gather = torch.from_numpy(mm[np.array(order_mm[s:e])])
                x = gather.to(dev)
                x = isax.znorm(x) if normalize else x.to(torch.float32)
                rows = x.cpu().numpy()
            wr.write_raw_rows(s, rows)
            recorder.record("permute", uid, flush=wr.flush)

        if workers > 1 and len(todo_u) > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(lambda t: _one_unit(*t), todo_u))
        else:
            for t in todo_u:
                _one_unit(*t)
        t_stage = _lap(report, "permute", t_stage)
    except BaseException:
        wr.keep_partial()          # everything recorded stays resumable
        raise

    # -- stage 5: publish (fsync + atomic rename) ------------------------
    wr.close()
    man.record_unit("publish", "0", digests.record(out_path))
    report.stages["publish"].built += 1
    _lap(report, "publish", t_stage)
    report.wall_s = time.perf_counter() - t0
    say(f"published {out_path} ({n_blocks} blocks, {n_series} series) "
        f"in {report.wall_s:.1f}s")
    if not keep_work:
        shutil.rmtree(work_dir, ignore_errors=True)
    return out_path, report


def pipeline_build(source, out_path: str | Path, *,
                   device: str | torch.device | None = "cuda",
                   **kw) -> BlockIndex:
    """Build (or resume) via the staged pipeline on ``device`` and open the
    result out-of-core there — the sharded/resumable form of
    ``ooc_build.build_on_disk`` (which wraps this with one worker)."""
    path, _ = run_pipeline(source, out_path, device=device, **kw)
    return format_lib.open_index(path, device=device)
