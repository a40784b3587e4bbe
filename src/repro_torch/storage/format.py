"""Persisted index file format + raw-series store (``repro.storage.format``).

The paper's on-disk systems (ParIS/ParIS+) hold only the iSAX summaries in
memory and leave the raw series on disk; queries touch raw bytes only for
the leaves that survive pruning.  This module is the serialization layer
that makes the same split possible here:

  * ``save_index`` persists a built ``BlockIndex`` into one versioned file;
  * ``load_index`` reads it back fully onto the device (the in-memory
    paths);
  * ``open_index`` reads ONLY the summaries/envelopes/ids onto the device
    and leaves the raw blocks as an ``np.memmap`` over the file — the
    out-of-core view that storage/ooc_search.py streams from.

The bytes are those of ``repro.storage.format``, meta JSON included (same
keys, order and separators), so a file written by either package opens
in the other.

File layout (all little-endian; one file, mmap-friendly):

    0:4    magic  b"DSIX"
    4:8    u32    format version
    8:16   u64    meta length L (bytes of UTF-8 JSON)
    16:24  u64    data_start (absolute, page-aligned)
    24:24+L       meta JSON: file kind, index meta (n, w, card, capacity,
                  n_real, n_blocks), caller ``extra`` dict, and per-section
                  {offset (relative to data_start), shape, dtype}

    data_start +  ids (B, C) i4 · slo (B, w, C) f4 · shi · elo (w, B) f4
                  · ehi — each 64-aligned — then, page-aligned and LAST,
                  raw (B, C, n) f4, so the memmap window is one contiguous
                  aligned span and appending raw during a streaming build
                  (the pipeline's pass 2) needs no backpatching.

Format v2 (this repo's second on-disk generation) adds a ``kind`` field to
the meta JSON so the SAME container carries the build pipeline's
intermediate files: ``kind="run"`` sorted summary runs and ``kind="merge"``
merged global orders (storage/pipeline/), alongside ``kind="index"``.
v1 files (no ``kind``) are still read bit-exactly: the section layout is
unchanged, so ``read_meta`` just defaults their kind to "index"
(back-compat locked by tests/test_pipeline.py).

Every writer here publishes atomically: bytes go to a temp path and
``os.replace`` onto the final name only after a full flush+fsync, so a
file that EXISTS under its final name is complete — and the readers
enforce the contrapositive, rejecting truncated/partial files (from an
interrupted copy, external truncation, or a foreign writer) loudly via
``check_complete`` instead of mmapping garbage.

``SeriesStore`` handles the other file kind in play: headerless raw-series
datasets (row-major float32 (N, n), the standard data-series benchmark
format), so builds can start from a path instead of an in-RAM array.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core.index import BlockIndex, HostRawBlocks
from repro_torch.device import resolve_device

MAGIC = b"DSIX"
VERSION = 2          # v2: meta "kind" field (run/merge pipeline files)
_ALIGN = 64          # section alignment
_PAGE = 4096         # raw-section (memmap window) alignment
_FIXED = 24          # bytes before the meta JSON

# Index-file section order is part of the format: raw last (see docstring).
_SECTIONS = ("ids", "slo", "shi", "elo", "ehi", "raw")


def _align(off: int, align: int) -> int:
    return (off + align - 1) // align * align


def _section_specs(*, n_blocks: int, capacity: int, w: int, n: int) -> dict:
    """name -> {offset (relative), shape, dtype} for the index layout."""
    b, c = n_blocks, capacity
    shapes = {
        "ids": ((b, c), "<i4"),
        "slo": ((b, w, c), "<f4"),
        "shi": ((b, w, c), "<f4"),
        "elo": ((w, b), "<f4"),
        "ehi": ((w, b), "<f4"),
        "raw": ((b, c, n), "<f4"),
    }
    specs, off = {}, 0
    for name in _SECTIONS:
        shape, dtype = shapes[name]
        off = _align(off, _PAGE if name == "raw" else _ALIGN)
        specs[name] = {"offset": off, "shape": list(shape), "dtype": dtype}
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return specs


def _generic_specs(shapes: dict) -> dict:
    """name -> spec for a generic (run/merge) file: 64-aligned, dict order."""
    specs, off = {}, 0
    for name, (shape, dtype) in shapes.items():
        off = _align(off, _ALIGN)
        specs[name] = {"offset": off, "shape": list(shape), "dtype": dtype}
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return specs


def _section_nbytes(spec: dict) -> int:
    return int(np.prod(spec["shape"])) * np.dtype(spec["dtype"]).itemsize


def data_end(meta: dict) -> int:
    """Absolute end offset of the last section — the complete file size."""
    return meta["data_start"] + max(
        s["offset"] + _section_nbytes(s) for s in meta["sections"].values())


def check_complete(path: str | Path, meta: dict) -> None:
    """Loudly reject a truncated/partial file before any section is read.

    Writers publish via write-to-temp + atomic rename, so a file under its
    final name is normally complete; a short file means an interrupted
    copy, external truncation, or a foreign writer — mmapping it would
    serve garbage (or crash later, deep in a search).
    """
    expected = data_end(meta)
    actual = os.path.getsize(path)
    if actual < expected:
        raise ValueError(
            f"{path}: truncated/partial file — {actual} bytes on disk but "
            f"the header promises {expected}.  Builds publish atomically "
            f"(temp + rename), so this file was likely produced by an "
            f"interrupted copy or external truncation; rebuild or re-copy "
            f"it.")


@sanitize.guarded
class ArrayFileWriter:
    """Incremental positioned writer for the DSIX container.

    Serves every file kind: the index itself (``IndexFileWriter``), the
    pipeline's sorted summary runs and merged order (storage/pipeline/).
    Three properties the build pipeline leans on:

      * **atomic publish** — bytes go to a temp path; ``close()`` flushes,
        fsyncs and ``os.replace``s onto the final name, so a kill mid-write
        never leaves a partial file under the final name;
      * **positioned row writes** — ``write_rows(name, start, rows)`` seeks
        to the section row, so independent units of work (pipeline permute
        units, possibly on worker threads — writes are lock-serialized)
        can fill disjoint spans in any order, and REDOING a unit rewrites
        identical bytes (idempotent resume);
      * **stable-temp resume** — with ``tmp_path=``/``resume=True`` a later
        process reopens the surviving partial (after verifying the header
        bytes match, i.e. same layout/params) and continues instead of
        restarting; ``keep_partial()`` closes the fd without publishing.
    """

    def __init__(self, path: str | Path, *, kind: str, specs: dict,
                 meta_fields: dict | None = None, extra: dict | None = None,
                 tmp_path: str | Path | None = None, resume: bool = False):
        self.path = Path(path)
        meta = {"kind": kind}
        meta.update(meta_fields or {})
        meta["extra"] = dict(extra or {})
        meta["sections"] = specs
        blob = json.dumps(meta).encode()
        self.sections = specs
        self.data_start = _align(_FIXED + len(blob), _PAGE)
        self._header = (MAGIC + struct.pack("<I", VERSION)
                        + struct.pack("<QQ", len(blob), self.data_start)
                        + blob)
        # write-to-tmp + rename publish (same property train/checkpoint.py
        # relies on): a killed build never clobbers an existing good file
        # and never leaves a partial file at the final path.  A caller that
        # wants crash-RESUME passes a stable tmp_path (the pid-salted
        # default is unfindable by the next process, by design: one-shot
        # writers must never collide).
        self._tmp = Path(tmp_path) if tmp_path is not None else \
            self.path.with_name(f".tmp-{os.getpid()}-{self.path.name}")
        self._lock = sanitize.create_lock()
        self.resumed = False
        if resume and self._tmp.exists():
            f = open(self._tmp, "r+b")
            if f.read(len(self._header)) == self._header:
                self._f, self.resumed = f, True
            else:                      # stale partial: other params/layout
                f.close()
        if not self.resumed:
            self._f = open(self._tmp, "wb")   # guarded by: _lock
            self._f.write(self._header)

    @property
    def end_offset(self) -> int:
        return self.data_start + max(
            s["offset"] + _section_nbytes(s) for s in self.sections.values())

    def write_rows(self, name: str, start: int, rows: np.ndarray) -> None:
        """Write ``rows`` at row ``start`` of section ``name`` (axis 0)."""
        spec = self.sections[name]
        shape, dtype = spec["shape"], np.dtype(spec["dtype"])
        rows = np.ascontiguousarray(rows, dtype=dtype)
        if list(rows.shape[1:]) != shape[1:]:
            raise ValueError(f"{name}: row shape {rows.shape[1:]} != "
                             f"{tuple(shape[1:])}")
        if start < 0 or start + rows.shape[0] > shape[0]:
            raise ValueError(f"{name}: rows [{start}, "
                             f"{start + rows.shape[0]}) overflow {shape[0]}")
        row_bytes = _section_nbytes(spec) // max(shape[0], 1)
        with self._lock:
            self._f.seek(self.data_start + spec["offset"] + start * row_bytes)
            self._f.write(rows.tobytes())

    def write_section(self, name: str, array: np.ndarray) -> None:
        spec = self.sections[name]
        arr = np.asarray(array)
        if list(arr.shape) != spec["shape"]:
            raise ValueError(f"{name}: shape {arr.shape} != {spec['shape']}")
        self.write_rows(name, 0, arr)

    def flush(self) -> None:
        """Push buffered bytes to the OS — a unit recorded in the build
        manifest after ``flush`` survives a SIGKILL of this process."""
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        """Finalize and atomically publish under the final name."""
        with self._lock:
            # extend to the full span even if the last rows were all-zero
            # (sparse positioned writes must not shorten the file)
            self._f.truncate(self.end_offset)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        os.replace(self._tmp, self.path)   # atomic publish

    def keep_partial(self) -> None:
        """Close the fd but KEEP the temp file for a later resume."""
        with self._lock:
            self._f.flush()
            self._f.close()

    def abort(self) -> None:
        with self._lock:
            self._f.close()
        self._tmp.unlink(missing_ok=True)

    def __enter__(self) -> "ArrayFileWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


@sanitize.guarded
class IndexFileWriter(ArrayFileWriter):
    """Incremental writer for the index file kind.

    ``save_index`` uses it in one shot; the build pipeline
    (storage/pipeline/driver.py) uses its positioned writes to fill the
    summary sections and raw permute units — resumably, via a stable
    ``tmp_path``.  ``append_raw_rows`` keeps the simple sequential-append
    surface for one-shot writers.
    """

    def __init__(self, path: str | Path, *, n: int, w: int, card: int,
                 capacity: int, n_real: int, n_blocks: int,
                 extra: dict | None = None,
                 tmp_path: str | Path | None = None, resume: bool = False):
        self.meta = dict(n=n, w=w, card=card, capacity=capacity,
                         n_real=n_real, n_blocks=n_blocks)
        super().__init__(
            path, kind="index",
            specs=_section_specs(n_blocks=n_blocks, capacity=capacity,
                                 w=w, n=n),
            meta_fields=self.meta, extra=extra,
            tmp_path=tmp_path, resume=resume)
        self._raw_rows = 0                      # guarded by: _lock

    def write_raw_rows(self, start: int, rows: np.ndarray) -> None:
        """Write (m, n) f32 series rows at series-row ``start`` of the raw
        section — SERIES granularity, not block granularity, so permute
        units need not align to block boundaries."""
        spec = self.sections["raw"]
        b, c, n = spec["shape"]
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != n:
            raise ValueError(f"raw rows must be (m, {n}), got {rows.shape}")
        if start < 0 or start + rows.shape[0] > b * c:
            raise ValueError("raw section overflow")
        with self._lock:
            self._f.seek(self.data_start + spec["offset"] + start * n * 4)
            self._f.write(rows.tobytes())

    def append_raw_rows(self, rows: np.ndarray) -> None:
        """Append (m, n) f32 series rows to the raw section, in block order.

        Reserve-then-write: the row counter advances under the lock (the
        lock is not reentrant, so the reservation releases before the
        positioned write re-acquires it), then the write lands in the
        reserved span, so concurrent appenders get disjoint spans.
        """
        m = rows.shape[0]
        b, c, _ = self.sections["raw"]["shape"]
        with self._lock:
            if self._raw_rows + m > b * c:
                raise ValueError("raw section overflow")
            start = self._raw_rows
            self._raw_rows += m
        self.write_raw_rows(start, rows)

    def close(self) -> None:
        b, c, _ = self.sections["raw"]["shape"]
        with self._lock:
            raw_rows = self._raw_rows
        # append-mode completeness guard; positioned writers (the pipeline)
        # track completeness through their manifest instead
        if raw_rows not in (0, b * c):
            self.abort()
            raise ValueError(
                f"raw section incomplete: {raw_rows} of {b * c} rows")
        super().close()


def write_arrays(path: str | Path, *, kind: str, arrays: dict,
                 extra: dict | None = None) -> Path:
    """One-shot atomic write of a generic (run/merge) DSIX file."""
    path = Path(path)
    specs = _generic_specs({name: (arr.shape, arr.dtype.str)
                            for name, arr in arrays.items()})
    with ArrayFileWriter(path, kind=kind, specs=specs, extra=extra) as wr:
        for name, arr in arrays.items():
            wr.write_section(name, arr)
    return path


def open_arrays(path: str | Path, *, kind: str | None = None,
                mmap: bool = True) -> tuple[dict, dict]:
    """-> (meta, {section: array}) for a generic DSIX file.

    ``mmap=True`` returns read-only memmaps (the merge streams runs
    through these without materializing them); completeness is checked
    first so a partial file fails loudly, not at some later page fault.
    """
    path = Path(path)
    meta = read_meta(path)
    if kind is not None and meta["kind"] != kind:
        raise ValueError(f"{path}: kind {meta['kind']!r}, expected {kind!r}")
    check_complete(path, meta)
    out = {}
    for name, spec in meta["sections"].items():
        shape = tuple(spec["shape"])
        if mmap:
            out[name] = np.memmap(path, dtype=np.dtype(spec["dtype"]),
                                  mode="r",
                                  offset=meta["data_start"] + spec["offset"],
                                  shape=shape)
        else:
            with open(path, "rb") as f:
                out[name] = _read_section(f, meta, name)
    return meta, out


def spec_row_bytes(spec: dict) -> int:
    """Bytes of one trailing-dim row of a section (raw: one series)."""
    return spec["shape"][-1] * np.dtype(spec["dtype"]).itemsize


def read_meta(path: str | Path) -> dict:
    """Parse the header; -> meta dict (incl. 'kind', 'extra', 'sections',
    'data_start').  v1 files (pre-pipeline) carry no 'kind' field and
    default to "index" — the section layout is identical, so they load
    bit-exactly through the same readers."""
    with open(path, "rb") as f:
        head = f.read(_FIXED)
        if len(head) < _FIXED or head[:4] != MAGIC:
            raise ValueError(f"{path}: not an index file (bad magic)")
        version, = struct.unpack("<I", head[4:8])
        if version > VERSION:
            raise ValueError(f"{path}: format version {version} is newer "
                             f"than supported ({VERSION})")
        meta_len, data_start = struct.unpack("<QQ", head[8:24])
        blob = f.read(meta_len)
        if len(blob) < meta_len:
            raise ValueError(f"{path}: truncated header ({len(blob)} of "
                             f"{meta_len} meta bytes)")
        meta = json.loads(blob.decode())
    meta.setdefault("kind", "index")
    meta["version"] = version
    meta["data_start"] = data_start
    return meta


def _read_section(f, meta: dict, name: str) -> np.ndarray:
    spec = meta["sections"][name]
    f.seek(meta["data_start"] + spec["offset"])
    count = int(np.prod(spec["shape"]))
    arr = np.fromfile(f, dtype=np.dtype(spec["dtype"]), count=count)
    if arr.size != count:
        raise ValueError(f"{name}: truncated index file")
    return arr.reshape(spec["shape"])


def _read_index_meta(path: Path) -> dict:
    meta = read_meta(path)
    if meta["kind"] != "index":
        raise ValueError(
            f"{path}: this is a {meta['kind']!r} file (a build-pipeline "
            f"intermediate, storage/pipeline/), not an index")
    check_complete(path, meta)
    return meta


def save_index(index: BlockIndex, path: str | Path, *,
               extra: dict | None = None) -> Path:
    """Persist a built (device-resident) index into one file."""
    if not index.device_resident:
        raise ValueError("index is already out-of-core; nothing to save")
    path = Path(path)
    with IndexFileWriter(path, n=index.n, w=index.w, card=index.card,
                         capacity=index.capacity, n_real=index.n_real,
                         n_blocks=index.n_blocks, extra=extra) as wr:
        for name in _SECTIONS:
            wr.write_section(name, getattr(index, name).cpu().numpy())
    return path


def _load_summaries(path: Path, meta: dict, dev: torch.device) -> dict:
    with open(path, "rb") as f:
        return {name: torch.from_numpy(_read_section(f, meta, name)).to(dev)
                for name in ("ids", "slo", "shi", "elo", "ehi")}


def load_index(path: str | Path,
               device: str | torch.device | None = "cuda") -> BlockIndex:
    """Full load: everything (raw included) onto ``device`` (the card
    unless the caller asks for the CPU) — the in-memory paths
    (``core.search``, ``paris``, …) work on the result unchanged."""
    dev = resolve_device(device)
    path = Path(path)
    meta = _read_index_meta(path)
    parts = _load_summaries(path, meta, dev)
    with open(path, "rb") as f:
        raw = torch.from_numpy(_read_section(f, meta, "raw")).to(dev)
    return BlockIndex(raw=raw, **parts, n=meta["n"], w=meta["w"],
                      card=meta["card"], capacity=meta["capacity"],
                      n_real=meta["n_real"])


def open_index(path: str | Path,
               device: str | torch.device | None = "cuda") -> BlockIndex:
    """Out-of-core open: summaries/envelopes/ids to ``device`` (the card
    unless the caller asks for the CPU), raw blocks left on disk as an
    ``np.memmap`` behind ``BlockIndex.host_raw``.

    The device holds the summary footprint only — 2·w floats per series
    plus the envelopes — which is what lets a dataset far larger than
    device memory be searched (storage/ooc_search.py).  ``raw`` becomes
    a zero-width (B, 0, n) placeholder; the in-memory search paths
    reject it.
    """
    dev = resolve_device(device)
    path = Path(path)
    meta = _read_index_meta(path)
    parts = _load_summaries(path, meta, dev)
    spec = meta["sections"]["raw"]
    mm = np.memmap(path, dtype=np.dtype(spec["dtype"]), mode="r",
                   offset=meta["data_start"] + spec["offset"],
                   shape=tuple(spec["shape"]))
    b, _, n = spec["shape"]
    return BlockIndex(
        raw=torch.zeros((b, 0, n), dtype=torch.float32, device=dev),
        **parts, n=meta["n"], w=meta["w"], card=meta["card"],
        capacity=meta["capacity"], n_real=meta["n_real"],
        host_raw=HostRawBlocks(mm, path=str(path)))


@dataclasses.dataclass
class SeriesStore:
    """A headerless raw-series file: row-major (n_series, length) float32.

    The standard interchange format of the data-series benchmarks (the
    paper's 100GB datasets ship exactly like this).  Gives builds a file
    source: ``memmap()`` for random access (the pass-2 permute),
    ``read`` for the sequential pass-1 stream (plugs into
    ``data.ChunkedLoader`` as a reader, or just pass the path — the loader
    mmaps it itself).  ``write`` takes one array; ``append`` builds a
    store in row chunks, for a collection larger than host memory.
    """
    path: Path
    length: int
    dtype: np.dtype = np.dtype(np.float32)

    def __post_init__(self):
        self.path = Path(self.path)
        self.dtype = np.dtype(self.dtype)
        size = os.path.getsize(self.path)
        row = self.length * self.dtype.itemsize
        if row <= 0 or size % row:
            raise ValueError(
                f"{self.path}: size {size} is not a multiple of "
                f"length {self.length} x itemsize {self.dtype.itemsize}")
        self.n_series = size // row
        self._mm: np.memmap | None = None

    def __len__(self) -> int:
        return self.n_series

    @property
    def nbytes(self) -> int:
        return self.n_series * self.length * self.dtype.itemsize

    def memmap(self) -> np.memmap:
        # one mapping for the store's lifetime: ``read`` is the pass-1
        # per-chunk reader, so remapping per call would be pure syscall
        # overhead on the streaming hot path
        if self._mm is None:
            self._mm = np.memmap(self.path, dtype=self.dtype, mode="r",
                                 shape=(self.n_series, self.length))
        return self._mm

    def read(self, start: int, stop: int) -> np.ndarray:
        """Copy rows [start, stop) off disk (a ChunkedLoader reader)."""
        return np.array(self.memmap()[start:stop])

    @classmethod
    def write(cls, path: str | Path, series: np.ndarray) -> "SeriesStore":
        """Write an (N, n) array as a headerless store (tests/benchmarks)."""
        arr = np.ascontiguousarray(series, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"series must be 2-D, got {arr.shape}")
        with open(path, "wb") as f:
            f.write(arr.tobytes())
        return cls(path=Path(path), length=arr.shape[1])

    @staticmethod
    def append(path: str | Path, rows: np.ndarray) -> None:
        """Append (m, n) rows to a headerless store (created if absent);
        open the finished file with ``SeriesStore(path, length=n)``."""
        arr = np.ascontiguousarray(rows, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(f"rows must be 2-D, got {arr.shape}")
        with open(path, "ab") as f:
            f.write(arr.tobytes())
