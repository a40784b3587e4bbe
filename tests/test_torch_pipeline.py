"""The port's staged build pipeline: byte identity, the merge, resume.

The pipeline's file must be byte-identical (sha256) to the port's own
``save_index(core.build(...))`` on the same data, for any shard count,
worker count or kill/resume history; its merge file byte-identical to
``repro``'s ``merge_runs`` on the same run files.  Against ``repro``'s
whole pipeline file the summaries must be equal and ``raw`` (the
z-normed series, reduced in another order by each framework) within
rtol 1e-6 / atol 1e-6; a symbol may differ only where the PAA lies
within 1e-5 of a breakpoint (as ``tests/test_torch_index.py`` checks),
and none does on this data.
"""
import hashlib
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro import storage as jst
from repro.core import isax as jisax
from repro.storage.pipeline import build_run as j_build_run
from repro.storage.pipeline import merge_runs as j_merge_runs
from repro_torch import storage as tst
from repro_torch.core import isax as tisax
from repro_torch.core.index import build as t_build
from repro_torch.data import ChunkedLoader, build_streaming, random_walk
from repro_torch.storage.pipeline import (BuildInterrupted, build_run,
                                          merge_order, merge_runs,
                                          run_pipeline)
from _torch_parity import one_intra_op_thread  # noqa: F401

CAP, CHUNK, LEN = 32, 128, 64
SECTIONS = ("ids", "slo", "shi", "elo", "ehi")


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    raw = random_walk(600, LEN, seed=23)       # 600 % 32 != 0: a pad unit
    td = tmp_path_factory.mktemp("pipe")
    store = tst.SeriesStore.write(td / "series.f32", raw)
    golden = td / "golden.dsix"
    tst.save_index(t_build(raw, capacity=CAP, device="cpu"), golden)
    return raw, store, _sha(golden)


def _pipeline(store, out, **kw):
    return run_pipeline(store, out, capacity=CAP, chunk=CHUNK,
                        device="cpu", **kw)


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("shards", [1, 3])
def test_pipeline_file_equals_save_index_of_build(dataset, tmp_path,
                                                  shards, workers):
    _, store, golden = dataset
    out = tmp_path / "p.dsix"
    path, rep = _pipeline(store, out, shards=shards, workers=workers)
    assert _sha(path) == golden
    assert not rep.resumed
    assert rep.stages["runs"].built == shards
    assert rep.stages["merge"].built == rep.stages["publish"].built == 1
    assert rep.wall_s >= sum(c.seconds for c in rep.stages.values())
    assert 0 < rep.digest_s < rep.wall_s
    assert not (tmp_path / "p.dsix.build").exists()     # work dir gone


@pytest.mark.parametrize("runs_by", ["port", "repro"])
@pytest.mark.parametrize("buffer_rows", [7, 1 << 16])
def test_merge_file_equals_repro(dataset, tmp_path, runs_by, buffer_rows):
    """The vectorized merge writes the heap merge's bytes, whichever
    package wrote the runs, at a buffer that takes many steps or one."""
    _, store, _ = dataset
    bounds = [0, 150, 151, 420, 600]
    paths = []
    for i in range(len(bounds) - 1):
        p = tmp_path / f"run{i}.dsix"
        if runs_by == "port":
            build_run(store, p, row_start=bounds[i], row_stop=bounds[i + 1],
                      w=16, card=256, chunk=CHUNK, normalize=True,
                      device="cpu")
        else:
            j_build_run(jst.SeriesStore(store.path, length=LEN), p,
                        row_start=bounds[i], row_stop=bounds[i + 1], w=16,
                        card=256, chunk=CHUNK, normalize=True)
        paths.append(p)
    merge_runs(paths, tmp_path / "t.merge", w=16, buffer_rows=buffer_rows)
    j_merge_runs(paths, tmp_path / "j.merge", w=16)
    assert _sha(tmp_path / "t.merge") == _sha(tmp_path / "j.merge")


def test_runs_equal_repro_runs(dataset, tmp_path):
    """Run files: keys, sax and ids equal to repro's for the same shard."""
    _, store, _ = dataset
    build_run(store, tmp_path / "t.run", row_start=100, row_stop=400, w=16,
              card=256, chunk=CHUNK, normalize=True, device="cpu")
    j_build_run(jst.SeriesStore(store.path, length=LEN), tmp_path / "j.run",
                row_start=100, row_stop=400, w=16, card=256, chunk=CHUNK,
                normalize=True)
    assert _sha(tmp_path / "t.run") == _sha(tmp_path / "j.run")


def test_merge_order_of_random_splits_is_sort_order(dataset, tmp_path):
    """Any shard split merges to isax.sort_order over the whole array."""
    raw, store, _ = dataset
    _, sax, _ = tisax.summarize(torch.from_numpy(raw))
    want = tisax.sort_order(sax).numpy()
    rng = np.random.default_rng(0)
    for trial in range(3):
        cuts = np.sort(rng.choice(np.arange(1, len(store)),
                                  int(rng.integers(1, 6)), replace=False))
        bounds = [0, *cuts.tolist(), len(store)]
        paths = [tmp_path / f"t{trial}-{i}.run" for i in range(len(bounds) - 1)]
        for i, p in enumerate(paths):
            build_run(store, p, row_start=bounds[i], row_stop=bounds[i + 1],
                      w=16, card=256, chunk=CHUNK, normalize=True,
                      device="cpu")
        got = merge_order(paths, buffer_rows=int(rng.integers(5, 90)))
        np.testing.assert_array_equal(got, want, err_msg=f"{bounds}")


def test_pipeline_file_matches_repro_pipeline(dataset, tmp_path):
    raw, store, _ = dataset
    pj, sj, _ = jisax.summarize(jnp.asarray(raw))
    _, st, _ = tisax.summarize(torch.from_numpy(raw))
    flips = np.array(sj) != st.numpy()
    bp = jisax.breakpoints(256)[np.minimum(np.array(sj), st.numpy())[flips]]
    assert np.all(np.abs(np.array(pj)[flips] - bp) < 1e-5)
    assert not flips.any()

    tpath, _ = _pipeline(store, tmp_path / "t.dsix", shards=2, workers=2)
    jpath, _ = jst.run_pipeline(jst.SeriesStore(store.path, length=LEN),
                                tmp_path / "j.dsix", capacity=CAP,
                                chunk=CHUNK, shards=2)
    assert tst.read_meta(tpath) == jst.read_meta(jpath)
    got = tst.load_index(tpath, device="cpu")
    want = jst.load_index(jpath)
    for name in SECTIONS:
        assert np.array_equal(getattr(got, name).numpy(),
                              np.array(getattr(want, name))), name
    np.testing.assert_allclose(got.raw.numpy(), np.array(want.raw),
                               rtol=1e-6, atol=1e-6)


_KILLED_BUILD = (
    "import sys\n"
    "from repro_torch.storage import SeriesStore\n"
    "from repro_torch.storage.pipeline import run_pipeline\n"
    "store = SeriesStore(path=sys.argv[1], length=int(sys.argv[2]))\n"
    "run_pipeline(store, sys.argv[3], capacity=int(sys.argv[4]),\n"
    "             chunk=int(sys.argv[5]), shards=3, device='cpu')\n")


@pytest.mark.parametrize("kill_after,expect", [
    # runs built, runs reused, merge reused, summaries reused, permute reused
    ("runs:1", (2, 1, 0, 0, 0)),
    ("merge:1", (0, 3, 1, 0, 0)),
    ("summaries:1", (0, 3, 1, 1, 0)),
    ("permute:1", (0, 3, 1, 1, 1)),
])
def test_sigkill_resume_byte_identical(dataset, tmp_path, kill_after,
                                       expect):
    """A real SIGKILL after the first completed unit of a stage: nothing
    is published, and the resume redoes only what was not recorded."""
    _, store, golden = dataset
    out = tmp_path / "killed.dsix"
    env = dict(os.environ, REPRO_BUILD_KILL_AFTER=kill_after,
               PYTHONPATH=str(Path(__file__).parent.parent / "src"))
    r = subprocess.run(
        [sys.executable, "-c", _KILLED_BUILD, str(store.path), str(LEN),
         str(out), str(CAP), str(CHUNK)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr
    assert not out.exists()                      # never a partial publish
    assert (out.with_name(out.name + ".build") / "manifest.json").exists()

    messages = []
    path, rep = _pipeline(store, out, shards=3, progress=messages.append)
    assert rep.resumed
    assert any("resuming from manifest" in m for m in messages)
    got = (rep.stages["runs"].built, rep.stages["runs"].reused,
           rep.stages["merge"].reused, rep.stages["summaries"].reused,
           rep.stages["permute"].reused)
    assert got == expect
    assert _sha(path) == golden


def test_inprocess_interrupt_resume_counters(dataset, tmp_path):
    _, store, golden = dataset
    out = tmp_path / "fault.dsix"

    def fault(stage, done):
        if stage == "permute" and done >= 2:
            raise BuildInterrupted(f"{stage}:{done}")

    with pytest.raises(BuildInterrupted):
        _pipeline(store, out, shards=2, fault=fault)
    n_units = -(-len(store) // CHUNK) + 1        # + the pad unit
    path, rep = _pipeline(store, out, shards=2)
    assert rep.resumed
    assert rep.stages["permute"].reused == 2
    assert rep.stages["permute"].built == n_units - 2
    assert rep.stages["runs"].reused == 2 and rep.stages["runs"].built == 0
    assert _sha(path) == golden


def test_rerun_is_a_verified_noop(dataset, tmp_path):
    _, store, golden = dataset
    out = tmp_path / "noop.dsix"
    _pipeline(store, out, keep_work=True)
    path, rep = _pipeline(store, out, keep_work=True)
    assert rep.stages["publish"].reused == 1     # verified, nothing redone
    assert rep.stages["runs"].built == 0 and rep.stages["permute"].built == 0
    assert rep.digest_s > 0                      # the verification hashed
    assert _sha(path) == golden


def test_manifest_mismatch_starts_fresh(dataset, tmp_path):
    raw, store, _ = dataset
    out = tmp_path / "fresh.dsix"

    def fault(stage, done):
        if stage == "merge":
            raise BuildInterrupted(stage)

    with pytest.raises(BuildInterrupted):
        _pipeline(store, out, shards=2, fault=fault)
    messages = []
    path, rep = run_pipeline(store, out, capacity=CAP * 2, chunk=CHUNK,
                             shards=2, progress=messages.append,
                             device="cpu")
    assert not rep.resumed
    assert any("starting fresh" in m for m in messages)
    assert rep.stages["runs"].built == 2 and rep.stages["runs"].reused == 0
    golden = tmp_path / "g2.dsix"
    tst.save_index(t_build(raw, capacity=CAP * 2, device="cpu"), golden)
    assert _sha(path) == _sha(golden)


def test_build_on_disk_opens_out_of_core(dataset, tmp_path):
    raw, store, golden = dataset
    opened = tst.build_on_disk(store, tmp_path / "b.dsix", capacity=CAP,
                               chunk=CHUNK, device="cpu")
    assert not opened.device_resident and opened.host_raw is not None
    assert _sha(tmp_path / "b.dsix") == golden
    res = tst.ooc_search(opened, torch.from_numpy(raw[:3] * 1.01), k=2,
                         device="cpu")
    assert torch.equal(res.idx[:, 0], torch.arange(3, dtype=torch.int32))


@pytest.mark.parametrize("source", ["array", "reader", "path"])
def test_chunked_loader_and_build_streaming(dataset, source):
    raw, store, _ = dataset
    src = {"array": raw, "reader": store.read, "path": store.path}[source]
    kw = {"array": {}, "reader": {"n_series": len(raw)},
          "path": {"length": LEN}}[source]
    loader = ChunkedLoader(src, chunk=CHUNK, device="cpu", **kw)
    chunks = list(loader)
    assert len(chunks) == len(loader) == -(-len(raw) // CHUNK)
    assert torch.equal(torch.cat(chunks), torch.from_numpy(raw))
    if source == "array":
        got = build_streaming(raw, chunk=CHUNK, capacity=CAP, device="cpu")
        want = t_build(raw, capacity=CAP, device="cpu")
        for name in SECTIONS + ("raw",):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
