"""Stage 2 of the build pipeline: k-way external merge of sorted runs
(``repro.storage.pipeline.merge``).

Produces the GLOBAL block order — the permutation a one-shot build gets
from one sort — without materializing all summaries: each run is read
through a buffer of ``buffer_rows`` rows, and the merged rows go out
through the writer in the same steps.  Peak memory is
O(buffer_rows · n_runs), independent of N.

Output is one ``kind="merge"`` DSIX file, the bytes of the reference's:

    sax (N, w) u2   iSAX words in global block order (pass 2 recomputes
                    per-series bounds + envelopes from these)
    ids (N,)   i8   source row ids in global block order — THE permutation

The reference merges one row at a time through ``heapq.merge`` with a
Python tuple a row; here each step is vectorized.  Every run is sorted
by (keys, id), so any row of any buffer that is <= the smallest LAST
row among the buffers that do not yet reach their run's end is <= every
row not yet read.  A step lexsorts the buffered rows by (keys, id) and
emits that prefix: at least one whole buffer, the same rows in the same
order as the heap merge.  Ids are unique, so (keys, id) is a total order
and the merged sequence equals one global stable sort by keys alone:
``isax.sort_order`` on the full array.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from repro_torch.storage import format as format_lib
from repro_torch.storage.pipeline import runs as runs_lib

MERGE_KIND = "merge"


def _sort_columns(keys: np.ndarray, ids: np.ndarray) -> tuple:
    """np.lexsort columns for the (keys, id) order: pairs of u4 key
    columns packed into u8 (fewer passes), the id as the last tie-break.
    np.lexsort takes the primary key LAST."""
    cols = []
    for i in range(0, keys.shape[0], 2):
        hi = keys[i].astype(np.uint64) << np.uint64(32)
        cols.append(hi | keys[i + 1] if i + 1 < keys.shape[0] else hi)
    return (ids, *reversed(cols))


def _merged(run_paths: list[Path], buffer_rows: int
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (sax rows, ids) of the merged order, one step at a time."""
    runs = [runs_lib.open_run(p)[1] for p in run_paths]
    sizes = [r["ids"].shape[0] for r in runs]
    pos = [0] * len(runs)
    while True:
        live = [i for i in range(len(runs)) if pos[i] < sizes[i]]
        if not live:
            return
        stops = [min(pos[i] + buffer_rows, sizes[i]) for i in live]
        keys = np.concatenate([np.array(runs[i]["keys"][:, pos[i]:e])
                               for i, e in zip(live, stops)], axis=1)
        sax = np.concatenate([np.array(runs[i]["sax"][pos[i]:e])
                              for i, e in zip(live, stops)])
        ids = np.concatenate([np.array(runs[i]["ids"][pos[i]:e])
                              for i, e in zip(live, stops)])
        lens = np.array([e - pos[i] for i, e in zip(live, stops)])
        ends = np.cumsum(lens)
        perm = np.lexsort(_sort_columns(keys, ids))
        # a buffer that does not reach its run's end bounds what is safe:
        # its last row is <= every row still unread in its run
        bounded = [ends[j] - 1 for j, (i, e) in enumerate(zip(live, stops))
                   if e < sizes[i]]
        if bounded:
            rank = np.empty_like(perm)
            rank[perm] = np.arange(perm.size)
            take = perm[:int(rank[bounded].min()) + 1]
        else:
            take = perm
        yield sax[take], ids[take]
        owner = np.repeat(np.arange(len(live)), lens)
        for j, c in enumerate(np.bincount(owner[take], minlength=len(live))):
            pos[live[j]] += int(c)


def merge_runs(run_paths: list[str | Path], out_path: str | Path, *,
               w: int, buffer_rows: int = 1 << 16) -> Path:
    """K-way merge sorted runs into one global-order merge file (atomic)."""
    run_paths = [Path(p) for p in run_paths]
    n_total = sum(runs_lib.open_run(p)[0]["sections"]["ids"]["shape"][0]
                  for p in run_paths)
    specs = format_lib._generic_specs({
        "sax": ((n_total, w), "<u2"),
        "ids": ((n_total,), "<i8"),
    })
    out_path = Path(out_path)
    wr = format_lib.ArrayFileWriter(out_path, kind=MERGE_KIND, specs=specs,
                                    extra={"n_runs": len(run_paths)})
    try:
        row = 0
        for sax_rows, ids_rows in _merged(run_paths, buffer_rows):
            wr.write_rows("sax", row, sax_rows)
            wr.write_rows("ids", row, ids_rows)
            row += ids_rows.shape[0]
        if row != n_total:
            raise ValueError(f"merge produced {row} of {n_total} rows")
    except BaseException:
        wr.abort()
        raise
    wr.close()
    return out_path


def open_merge(path: str | Path) -> tuple[dict, dict]:
    """-> (meta, {sax, ids}) memmaps — pass 2 streams slices of these."""
    return format_lib.open_arrays(path, kind=MERGE_KIND, mmap=True)


def merge_order(run_paths: list[str | Path], buffer_rows: int = 1 << 16
                ) -> np.ndarray:
    """The merged global permutation alone (property tests, small inputs)."""
    parts = [ids for _, ids in _merged([Path(p) for p in run_paths],
                                       buffer_rows)]
    return np.concatenate(parts).astype(np.int64)
