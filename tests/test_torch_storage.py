"""The port's DSIX format and out-of-core search against repro's.

Files cross both ways: a ``repro`` index carried across with ``interop``
is saved by both packages and the two files must hash the same (sha256);
each package opens the other's file, and ``ooc_search`` over the same
file answers identically.  ``repro`` runs in ref mode (the jnp oracles
``ops`` "auto" picks off-TPU).  Ids, every ``SearchStats`` counter and
the ``IOStats`` of the serial walk must be equal; squared distances agree
to rtol 1e-5 / atol 1e-4 (``tests/_torch_parity.py``).
"""
import hashlib
import json
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro import storage as jst
from repro_torch import storage as tst
from repro_torch.core import dtw as tdtw
from repro_torch.core import engine as tengine
from repro_torch.core import paris as tparis
from repro_torch.core.index import flat_view
from repro_torch.core.search import search as t_search_qm
from repro_torch.core.search import search_block_major as t_search
from repro_torch.data import random_walk

from _torch_parity import carry, close_sq, same

N, LEN, CAP = 2000, 128, 64
FIELDS = ("raw", "slo", "shi", "elo", "ehi", "ids")
META = ("n", "w", "card", "capacity", "n_real")


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def dataset():
    raw = random_walk(N, LEN, seed=31)
    rng = np.random.default_rng(5)
    qs = raw[rng.choice(N, 6, replace=False)] \
        + 0.05 * rng.standard_normal((6, LEN)).astype(np.float32)
    return raw, qs


@pytest.fixture(scope="module")
def files(dataset, tmp_path_factory):
    """The same index saved by repro (``j``) and by the port (``t``)."""
    td = tmp_path_factory.mktemp("dsix")
    ji = jcore.build(jnp.asarray(dataset[0]), capacity=CAP)
    jst.save_index(ji, td / "j.dsix", extra={"dataset": "rw2000"})
    tst.save_index(carry(ji), td / "t.dsix", extra={"dataset": "rw2000"})
    return ji, td / "j.dsix", td / "t.dsix"


def test_save_index_writes_repro_bytes(files):
    _, jpath, tpath = files
    assert _sha(jpath) == _sha(tpath)
    assert tst.read_meta(tpath) == jst.read_meta(jpath)


@pytest.mark.parametrize("opener", ["load_index", "open_index"])
def test_repro_file_opens_in_port(files, opener):
    ji, jpath, _ = files
    got = getattr(tst, opener)(jpath, device="cpu")
    fields = FIELDS if opener == "load_index" else FIELDS[1:]
    for f in fields:
        a, b = getattr(got, f).numpy(), np.array(getattr(ji, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in META:
        assert getattr(got, f) == getattr(ji, f), f
    assert got.device_resident == (opener == "load_index")


def test_port_file_opens_in_repro(files, dataset):
    ji, _, tpath = files
    loaded = jst.load_index(tpath)
    for f in FIELDS:
        assert np.array_equal(np.array(getattr(loaded, f)),
                              np.array(getattr(ji, f))), f
    # and answers as the port does over its own file
    qs = dataset[1]
    want = jst.ooc_search(jst.open_index(tpath), jnp.asarray(qs), k=5)
    got = tst.ooc_search(tst.open_index(tpath, device="cpu"),
                         torch.from_numpy(qs), k=5, device="cpu")
    same(got, want)
    assert tuple(got.io) == tuple(want.io)


def test_open_index_is_out_of_core(files, dataset):
    _, jpath, _ = files
    opened = tst.open_index(jpath, device="cpu")
    assert not opened.device_resident
    assert opened.raw.shape == (opened.n_blocks, 0, LEN)
    assert isinstance(opened.host_raw.blocks, np.memmap)
    block = opened.host_raw.fetch(3)
    assert block.flags.writeable and block.shape == (CAP, LEN)
    assert opened.host_raw.block_nbytes == CAP * LEN * 4


@pytest.mark.parametrize("k", [1, 5, 32])
def test_ooc_search_matches_repro(files, dataset, k):
    """Same file, serial walk: ids, every counter and the I/O bill equal."""
    _, jpath, _ = files
    qs = dataset[1]
    want = jst.ooc_search(jst.open_index(jpath), jnp.asarray(qs), k=k)
    got = tst.ooc_search(tst.open_index(jpath, device="cpu"),
                         torch.from_numpy(qs), k=k, device="cpu")
    same(got, want)
    assert tuple(got.io) == tuple(want.io)
    assert got.io.bytes_scan == N * LEN * 4
    assert got.io.read_fraction == pytest.approx(want.io.read_fraction)


def test_ooc_search_equals_in_memory_search(files, dataset):
    """The streaming walk answers what the in-memory block-major walk
    answers over the loaded index: the same ids, distances to rounding."""
    _, jpath, _ = files
    qs = torch.from_numpy(dataset[1])
    got = tst.ooc_search(tst.open_index(jpath, device="cpu"), qs, k=5,
                         device="cpu")
    want = t_search(tst.load_index(jpath, device="cpu"), qs, k=5,
                    device="cpu")
    assert torch.equal(got.idx, want.idx)
    close_sq(got.dist, want.dist.numpy())


def test_ooc_search_k_exceeds_n_real(tmp_path):
    raw = random_walk(20, 64, seed=9)
    ji = jcore.build(jnp.asarray(raw), capacity=8)
    jst.save_index(ji, tmp_path / "tiny.dsix")
    want = jst.ooc_search(jst.open_index(tmp_path / "tiny.dsix"),
                          jnp.asarray(raw[:3] * 1.01), k=32)
    got = tst.ooc_search(tst.open_index(tmp_path / "tiny.dsix",
                                        device="cpu"),
                         torch.from_numpy(raw[:3] * 1.01), k=32,
                         device="cpu")
    same(got, want)
    assert (got.idx[:, 20:] == -1).all()          # padded tail


def test_meta_layout(files):
    _, _, tpath = files
    meta = tst.read_meta(tpath)
    assert meta["extra"] == {"dataset": "rw2000"}
    assert meta["version"] == 2 and meta["kind"] == "index"
    raw_off = meta["sections"]["raw"]["offset"]
    assert (meta["data_start"] + raw_off) % 4096 == 0
    assert raw_off >= max(s["offset"] for n, s in meta["sections"].items()
                          if n != "raw")


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.dsix"
    p.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        tst.read_meta(p)


def test_truncated_file_rejected(files, tmp_path):
    _, jpath, _ = files
    bad = tmp_path / "trunc.dsix"
    bad.write_bytes(jpath.read_bytes()[:-4097])   # torn copy: tail missing
    for opener in (tst.load_index, tst.open_index):
        with pytest.raises(ValueError, match="truncated/partial"):
            opener(bad, device="cpu")
    bad.write_bytes(jpath.read_bytes()[:40])
    with pytest.raises(ValueError, match="truncated header"):
        tst.read_meta(bad)


def test_run_file_rejected_as_index(dataset, tmp_path):
    from repro.storage.pipeline import build_run
    store = jst.SeriesStore.write(tmp_path / "s.f32", dataset[0][:200])
    p = tmp_path / "arun.dsix"
    build_run(store, p, row_start=0, row_stop=100, w=16, card=256,
              chunk=64, normalize=True)
    for opener in (tst.load_index, tst.open_index):
        with pytest.raises(ValueError, match="not an index"):
            opener(p, device="cpu")


def _downgrade_to_v1(src: Path, dst: Path) -> None:
    """Rewrite a v2 index file as its v1 bytes: v2 only added the meta
    'kind' field (its first key); the section layout is unchanged."""
    blob_all = src.read_bytes()
    meta_len, data_start = struct.unpack("<QQ", blob_all[8:24])
    meta = json.loads(blob_all[24:24 + meta_len].decode())
    assert meta.pop("kind") == "index"
    blob = json.dumps(meta).encode()
    new_start = -(-(24 + len(blob)) // 4096) * 4096
    out = bytearray(b"DSIX" + struct.pack("<I", 1)
                    + struct.pack("<QQ", len(blob), new_start) + blob)
    out += b"\0" * (new_start - len(out))
    out += blob_all[data_start:]
    dst.write_bytes(bytes(out))


def test_v1_file_loads_bit_exact(files, dataset, tmp_path):
    ji, jpath, _ = files
    v1 = tmp_path / "legacy.dsix"
    _downgrade_to_v1(jpath, v1)
    meta = tst.read_meta(v1)
    assert meta["version"] == 1 and meta["kind"] == "index"
    a = tst.load_index(v1, device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(a, f).numpy(),
                              np.array(getattr(ji, f))), f
    qs = torch.from_numpy(dataset[1][:3])
    got = tst.ooc_search(tst.open_index(v1, device="cpu"), qs, k=3,
                         device="cpu")
    want = tst.ooc_search(tst.open_index(jpath, device="cpu"), qs, k=3,
                          device="cpu")
    assert torch.equal(got.idx, want.idx) and torch.equal(got.dist,
                                                          want.dist)


def test_in_memory_entry_points_reject_an_opened_index(files, dataset):
    _, jpath, _ = files
    opened = tst.open_index(jpath, device="cpu")
    qs = torch.from_numpy(dataset[1])
    calls = [
        lambda: t_search(opened, qs, device="cpu"),
        lambda: t_search_qm(opened, qs, device="cpu"),
        lambda: tparis.search_paris(opened, qs, device="cpu"),
        lambda: tdtw.search_dtw(opened, qs, r=4, device="cpu"),
        lambda: tengine.run(opened, qs, tengine.QueryPlan(), device="cpu"),
        lambda: flat_view(opened),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="ooc_search"):
            call()
    with pytest.raises(ValueError, match="out-of-core"):
        tst.save_index(opened, jpath)


def test_ooc_search_requires_host_raw(files, dataset):
    ji, _, _ = files
    with pytest.raises(ValueError, match="host_raw"):
        tst.ooc_search(carry(ji), torch.from_numpy(dataset[1]),
                       device="cpu")


def test_series_store_write_and_append(tmp_path):
    raw = random_walk(50, 64, seed=1)
    s = tst.SeriesStore.write(tmp_path / "a.f32", raw)
    for i in range(0, 50, 16):
        tst.SeriesStore.append(tmp_path / "b.f32", raw[i:i + 16])
    t = tst.SeriesStore(tmp_path / "b.f32", length=64)
    assert len(s) == len(t) == 50 and s.nbytes == t.nbytes == 50 * 64 * 4
    assert np.array_equal(t.read(3, 40), raw[3:40])
    assert _sha(s.path) == _sha(t.path)
    with pytest.raises(ValueError, match="multiple"):
        tst.SeriesStore(tmp_path / "a.f32", length=63)


def _writers(path_j, path_t, ji):
    kw = dict(n=ji.n, w=ji.w, card=ji.card, capacity=ji.capacity,
              n_real=ji.n_real, n_blocks=ji.n_blocks)
    from repro.storage.format import IndexFileWriter as JWriter
    from repro_torch.storage.format import IndexFileWriter as TWriter
    return JWriter(path_j, **kw), TWriter(path_t, **kw)


def test_append_raw_rows_writes_repro_bytes(files, tmp_path):
    """One-shot appends in uneven pieces give the bytes repro's writer
    gives; an incomplete raw section is refused at close."""
    ji, _, _ = files
    raw = np.asarray(ji.raw).reshape(-1, ji.n)
    jw, tw = _writers(tmp_path / "j.dsix", tmp_path / "t.dsix", ji)
    for wr in (jw, tw):
        for name in ("ids", "slo", "shi", "elo", "ehi"):
            wr.write_section(name, np.asarray(getattr(ji, name)))
        for a, b in ((0, 1), (1, 700), (700, 2000), (2000, raw.shape[0])):
            wr.append_raw_rows(raw[a:b])
        with pytest.raises(ValueError, match="overflow"):
            wr.append_raw_rows(raw[:1])
        wr.close()
    assert _sha(tmp_path / "t.dsix") == _sha(tmp_path / "j.dsix")
    _, tw = _writers(tmp_path / "j2.dsix", tmp_path / "t2.dsix", ji)
    tw.append_raw_rows(raw[:5])
    with pytest.raises(ValueError, match="incomplete"):
        tw.close()
    assert not (tmp_path / "t2.dsix").exists()


def test_append_raw_rows_concurrent_appenders_get_disjoint_spans(files,
                                                                 tmp_path):
    """Eight threads append one-row pieces tagged with their own value:
    every row lands whole, once, in a span of its own."""
    import sys
    import threading
    ji, _, _ = files
    _, tw = _writers(tmp_path / "unused", tmp_path / "t.dsix", ji)
    total = ji.n_blocks * ji.capacity
    n_threads = 8
    per = total // n_threads
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def appender(t):
            for i in range(per):
                tw.append_raw_rows(np.full((1, ji.n), t * per + i,
                                           np.float32))

        threads = [threading.Thread(target=appender, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        tw.append_raw_rows(np.full((total - n_threads * per, ji.n), -1.0,
                                   np.float32))
    finally:
        sys.setswitchinterval(old)
    tw.close()
    meta = tst.read_meta(tmp_path / "t.dsix")
    spec = meta["sections"]["raw"]
    rows = np.fromfile(tmp_path / "t.dsix", dtype=np.float32,
                       count=total * ji.n,
                       offset=meta["data_start"] + spec["offset"]
                       ).reshape(total, ji.n)
    assert (rows == rows[:, :1]).all()                 # no torn row
    tags = rows[:, 0]
    assert sorted(tags[tags >= 0].astype(int).tolist()) \
        == list(range(n_threads * per))                # each exactly once


def test_spec_row_bytes_equals_repro(files):
    from repro.storage.format import spec_row_bytes as jrow
    from repro_torch.storage.format import spec_row_bytes as trow
    _, jpath, tpath = files
    jmeta, tmeta = jst.read_meta(jpath), tst.read_meta(tpath)
    for name, spec in tmeta["sections"].items():
        assert trow(spec) == jrow(jmeta["sections"][name])
    assert trow(tmeta["sections"]["raw"]) == LEN * 4
