"""The port's cached walk and block cache against repro's.

Both packages walk the same ``repro``-written file.  The pipelined walk
is pure overlap: at every (pipeline_depth, group_blocks) of
``tests/test_pipeline_walk.py``'s grid the port must answer as
``repro``'s serial walk does — ids and every ``SearchStats`` counter
equal, squared distances within rtol 1e-5 / atol 1e-4
(``tests/_torch_parity.py``) — and bitwise as its own serial walk does.
``repro`` runs in ref mode.  The rest holds the cache's contracts:
at-most-once billing, a failed read that does not poison the cache, the
bounded speculation, ``close()`` under reads in flight, and a warm
repeat that reads 0 bytes.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro import storage as jst
from repro.core import engine as jengine
from repro.core import vector as jvector
from repro_torch import storage as tst
from repro_torch.core import engine as tengine
from repro_torch.data import random_walk

from _torch_parity import same

N, LEN, CAP, R = 2000, 128, 64, 4
DTW_N, DTW_LEN, DTW_CAP = 600, 64, 32
GRID = [(d, g) for d in (1, 2, 4) for g in (1, 2, 8)]
METRICS = {"ed": (None, None), "dtw": (jengine.DTW(r=R), tengine.DTW(r=R)),
           "cosine": (jengine.Cosine(), tengine.Cosine())}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The walks run many small tensor ops, fastest on one intra-op
    thread when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Random walks and embeddings, each indexed and saved by repro."""
    td = tmp_path_factory.mktemp("cache")
    raw = jnp.asarray(random_walk(N, LEN, seed=41))
    rng = np.random.default_rng(13)
    qs = np.asarray(raw)[rng.choice(N, 8, replace=False)] \
        + 0.05 * rng.standard_normal((8, LEN)).astype(np.float32)
    jst.save_index(jcore.build(raw, capacity=CAP), td / "rw.dsix")
    vrng = np.random.default_rng(5)
    embs = vrng.standard_normal((1024, 64)).astype(np.float32)
    vqs = vrng.standard_normal((6, 64)).astype(np.float32)
    jst.save_index(jvector.build_vector_index(jnp.asarray(embs), capacity=64),
                   td / "vec.dsix")
    # DTW on shorter series and fewer queries: its plain banded DP on the
    # CPU sets the file's time
    draw = random_walk(DTW_N, DTW_LEN, seed=43)
    dqs = draw[rng.choice(DTW_N, 3, replace=False)] \
        + 0.05 * rng.standard_normal((3, DTW_LEN)).astype(np.float32)
    jst.save_index(jcore.build(jnp.asarray(draw), capacity=DTW_CAP),
                   td / "dtw.dsix")
    return {"ed": (td / "rw.dsix", qs), "dtw": (td / "dtw.dsix", dqs),
            "cosine": (td / "vec.dsix", vqs)}


def _opened(path):
    return tst.open_index(path, device="cpu")


def _search(opened, qs, *, d, g, metric=None, k=5, readers=2):
    with tst.SearchSession(opened, cache_blocks=opened.n_blocks,
                           readers=readers, pipeline_depth=d,
                           group_blocks=g, device="cpu") as sess:
        res = sess.search(torch.from_numpy(qs), k=k, metric=metric)
        return res, sess.last_telemetry


def _bitwise(got, want):
    assert torch.equal(got.idx, want.idx) and torch.equal(got.dist,
                                                          want.dist)
    for f, a, b in zip(got.stats._fields, got.stats, want.stats):
        assert torch.equal(a, b), f


@pytest.fixture(scope="module")
def goldens(files):
    """Per metric: repro's serial session and the port's serial walk."""
    out = {}
    for name, (jm, tm) in METRICS.items():
        path, qs = files[name]
        with jst.SearchSession(jst.open_index(path),
                               cache_blocks=64) as sess:
            want = sess.search(jnp.asarray(qs), k=5, metric=jm)
        serial, _ = _search(_opened(path), qs, d=1, g=1, metric=tm)
        out[name] = (want, serial)
    return out


@pytest.mark.parametrize("d,g", GRID)
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_exactness_grid(files, goldens, metric, d, g):
    path, qs = files[metric]
    want, serial = goldens[metric]
    got, tel = _search(_opened(path), qs, d=d, g=g,
                       metric=METRICS[metric][1])
    same(got, want)
    _bitwise(got, serial)
    assert tel["pipeline_depth"] == d and tel["group_blocks"] == g


@pytest.mark.parametrize("g", [1, 8])
def test_telemetry_and_io_equal_repro(files, g):
    """Same sync and dispatch cadence as repro's walk; at (1, 1) the same
    I/O bill too (deeper pipelines may speculate differently by timing)."""
    path, qs = files["ed"]
    with jst.SearchSession(jst.open_index(path), cache_blocks=64,
                           group_blocks=g) as sess:
        want = sess.search(jnp.asarray(qs), k=5)
        jtel = sess.last_telemetry
    got, tel = _search(_opened(path), qs, d=1, g=g)
    same(got, want)
    assert tel == jtel
    if g == 1:
        assert tuple(got.io) == tuple(want.io)
        assert tel["syncs"] == tel["walk_blocks"] + 1
    else:
        assert tel["dispatches"] == tel["syncs"] - 1


def _fetchers(path):
    host = jst.open_index(path).host_raw
    return (lambda b: jnp.asarray(host.fetch(b)),
            lambda b: torch.from_numpy(np.array(host.fetch(b))))


@pytest.mark.parametrize("deadline", [1, 3, 7])
def test_deadline_cut_and_resume_equal_repro(files, deadline):
    """run_cached's own deadline cut (an anytime frontier plus its
    continuation) and the resume to exact, against repro's, at a
    pipelined (D, G)."""
    path, qs = files["ed"]
    jfetch, tfetch = _fetchers(path)
    jplan = jengine.QueryPlan(k=5, deadline_blocks=deadline)
    tplan = tengine.QueryPlan(k=5, deadline_blocks=deadline)
    jopened, topened = jst.open_index(path), _opened(path)
    jf, js, jstate = jengine.run_cached(jopened, jnp.asarray(qs), jplan,
                                        fetch=jfetch, pipeline_depth=2,
                                        group_blocks=4)
    tel = {}
    tf, ts, tstate = tengine.run_cached(topened, torch.from_numpy(qs), tplan,
                                        fetch=tfetch, pipeline_depth=2,
                                        group_blocks=4, telemetry=tel)
    assert tel["walk_blocks"] <= deadline
    assert tstate.refined == jstate.refined
    assert np.array_equal(tf.ids.numpy(), np.array(jf.ids))
    for a, b in zip(ts, js):
        assert np.array_equal(a.numpy(), np.array(b))
    # resume both to exact: equal to each other and to a fresh exact walk
    jplan_x = jengine.QueryPlan(k=5)
    tplan_x = tengine.QueryPlan(k=5)
    jf2, js2, _ = jengine.run_cached(jopened, jnp.asarray(qs), jplan_x,
                                     fetch=jfetch, prepared=jstate)
    tf2, ts2, _ = tengine.run_cached(topened, torch.from_numpy(qs), tplan_x,
                                     fetch=tfetch, prepared=tstate)
    assert np.array_equal(tf2.ids.numpy(), np.array(jf2.ids))
    np.testing.assert_allclose(tf2.dists.numpy().astype(np.float64),
                               np.array(jf2.dists).astype(np.float64),
                               rtol=1e-5, atol=1e-4)
    for a, b in zip(ts2, js2):
        assert np.array_equal(a.numpy(), np.array(b))
    tf3, ts3, _ = tengine.run_cached(topened, torch.from_numpy(qs), tplan_x,
                                     fetch=tfetch)
    assert torch.equal(tf2.ids, tf3.ids) and torch.equal(tf2.dists,
                                                         tf3.dists)


def test_prepared_two_round_equals_repro(files):
    """approximate_threshold -> search(prepared=...) at a pipelined (D, G):
    the answer, every counter and the one bill equal repro's protocol."""
    path, qs = files["ed"]
    with jst.SearchSession(jst.open_index(path), cache_blocks=16) as sess:
        prep = sess.approximate_threshold(jnp.asarray(qs), k=3)
        want = sess.search(jnp.asarray(qs), k=3, prepared=prep,
                           initial_threshold=jnp.asarray(prep.threshold))
    with tst.SearchSession(_opened(path), cache_blocks=16, pipeline_depth=4,
                           group_blocks=8, device="cpu") as sess:
        q = torch.from_numpy(qs)
        tprep = sess.approximate_threshold(q, k=3)
        np.testing.assert_allclose(np.asarray(tprep), np.asarray(prep),
                                   rtol=1e-5, atol=1e-4)
        got = sess.search(q, k=3, prepared=tprep,
                          initial_threshold=torch.from_numpy(tprep.threshold))
        with pytest.raises(ValueError, match="already consumed"):
            sess.search(q, k=3, prepared=tprep)
    same(got, want)
    assert got.io.blocks_refined == want.io.blocks_refined


def test_at_most_once_billing_with_depth_speculation(files):
    path, qs = files["ed"]
    opened = _opened(path)
    calls: list[int] = []
    orig = opened.host_raw.fetch
    opened.host_raw.fetch = lambda b: (calls.append(int(b)), orig(b))[1]
    with tst.SearchSession(opened, cache_blocks=opened.n_blocks, readers=3,
                           pipeline_depth=4, group_blocks=2,
                           device="cpu") as sess:
        res = sess.search(torch.from_numpy(qs), k=5)
    counts = np.bincount(calls, minlength=opened.n_blocks)
    assert counts.max() <= 1
    assert res.io.blocks_fetched == len(calls)
    assert res.io.bytes_read == len(calls) * opened.host_raw.block_nbytes
    assert res.io.blocks_refined <= res.io.blocks_fetched + res.io.cache_hits


def test_warm_repeat_reads_zero_bytes(files):
    path, qs = files["ed"]
    opened = _opened(path)
    with tst.SearchSession(opened, cache_blocks=opened.n_blocks,
                           device="cpu") as sess:
        cold = sess.search(torch.from_numpy(qs), k=5)
        warm = sess.search(torch.from_numpy(qs), k=5)
    _bitwise(warm, cold)
    assert cold.io.blocks_fetched > 0 and cold.io.cache_hits == 0
    assert warm.io.bytes_read == 0 and warm.io.blocks_fetched == 0
    assert warm.io.cache_hits == cold.io.blocks_fetched
    assert sess.hit_rate == pytest.approx(0.5)


def test_failed_read_does_not_poison_the_cache(files):
    path, qs = files["ed"]
    opened = _opened(path)

    def broken(b):
        raise OSError("transient read failure")

    with tst.SearchSession(opened, cache_blocks=8, device="cpu") as sess:
        opened.host_raw.fetch = broken
        try:
            with pytest.raises(OSError, match="transient"):
                sess.search(torch.from_numpy(qs), k=3)
        finally:
            del opened.host_raw.fetch          # restore the class method
        sess.cache.drain()
        assert not sess.cache._inflight        # nothing stale left behind
        got = sess.search(torch.from_numpy(qs), k=3)
    with jst.SearchSession(jst.open_index(path), cache_blocks=8) as js:
        want = js.search(jnp.asarray(qs), k=3)
    same(got, want)


def test_prefetch_declines_at_max_inflight_but_get_never_does(files):
    opened = _opened(files["ed"][0])
    gate = threading.Event()
    orig = opened.host_raw.fetch
    opened.host_raw.fetch = lambda b: (gate.wait(10), orig(b))[1]
    cache = tst.BlockCache(opened.host_raw, opened.n_blocks, readers=2,
                           max_inflight=2, device="cpu")
    try:
        cache.prefetch(0)
        cache.prefetch(1)
        cache.prefetch(2)                      # at the bound: declined
        assert len(cache._inflight) == 2 and 2 not in cache
        gate.set()
        cache.drain()
        assert len(cache) == 2 and cache.demand_misses == 0
        got = cache.get(2)                     # demand is never declined
        assert torch.equal(got, torch.from_numpy(orig(2)))
        assert cache.demand_misses == 1
    finally:
        del opened.host_raw.fetch
        cache.close()


def test_close_under_reads_in_flight(files):
    opened = _opened(files["ed"][0])
    gate = threading.Event()
    orig = opened.host_raw.fetch
    opened.host_raw.fetch = lambda b: (gate.wait(10), orig(b))[1]
    cache = tst.BlockCache(opened.host_raw, 8, readers=3, max_inflight=4,
                           device="cpu")
    try:
        for b in range(4):
            cache.prefetch(b)
        assert len(cache._inflight) == 4
        closer = threading.Thread(target=cache.close)
        closer.start()
        gate.set()
        closer.join(timeout=10)
        assert not closer.is_alive(), "close() deadlocked on reads in flight"
    finally:
        del opened.host_raw.fetch
    cache.close()                              # idempotent
    assert len(cache) == 0 and not cache._inflight
    assert cache.disk_blocks == 4              # counters settled first
    cache.prefetch(5)                          # late speculation: no-op
    assert not cache._inflight
    with pytest.raises(ValueError, match="closed"):
        cache.get(5)


def test_serving_entry_points_name_the_missing_layer(files):
    """The serving layer is ported: the entry points that raised before it
    (``search(deadline_blocks=...)``, ``submit``, ``drain``) answer."""
    from repro_torch import serve as tserve
    path, qs = files["ed"]
    with tst.SearchSession(_opened(path), cache_blocks=8,
                           device="cpu") as sess:
        q = torch.from_numpy(qs)
        assert isinstance(sess.search(q, deadline_blocks=3),
                          tserve.AnytimeResult)
        t = sess.submit(q)
        assert sess.drain() == [t] and t.done
        assert t.result().idx.shape == (q.shape[0], 1)


def test_knob_validation(files):
    path, qs = files["ed"]
    opened = _opened(path)
    q = torch.from_numpy(qs)
    with pytest.raises(ValueError, match=">= 1"):
        tst.SearchSession(opened, pipeline_depth=0, device="cpu")
    with pytest.raises(ValueError, match="cover the pipeline"):
        tst.SearchSession(opened, cache_blocks=4, pipeline_depth=2,
                          group_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="readers"):
        tst.BlockCache(opened.host_raw, 4, readers=0, device="cpu")
    with pytest.raises(ValueError, match="capacity_blocks"):
        tst.BlockCache(opened.host_raw, 1, device="cpu")
    with tst.SearchSession(opened, cache_blocks=4, device="cpu") as sess:
        with pytest.raises(ValueError, match="cache capacity"):
            sess.search(q, k=1, pipeline_depth=2, group_blocks=8)
    with pytest.raises(ValueError, match=">= 1"):
        tengine.run_cached(opened, q, tengine.QueryPlan(),
                           fetch=lambda b: None, group_blocks=0)
    with pytest.raises(ValueError, match="block-major"):
        tengine.run_cached(opened, q, tengine.QueryPlan(schedule="flat"),
                           fetch=lambda b: None)


def test_concurrent_gets_and_prefetches_read_each_block_once(files):
    """Stress: more threads than cores hammer one cache that holds every
    block, with a short switch interval.  Nothing is evicted, so every
    block is read from disk at most once: the reads equal the resident
    blocks, which cover every block a get asked for, and every get
    returns its block's bytes."""
    import sys
    opened = _opened(files["ed"][0])
    nb = opened.n_blocks
    cache = tst.BlockCache(opened.host_raw, nb, readers=4, max_inflight=6,
                           device="cpu")
    errors, asked = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for b in rng.integers(0, nb, 60).tolist():
                cache.prefetch(int(rng.integers(0, nb)))
                asked.append(b)
                if not torch.equal(cache.get(b), torch.from_numpy(
                        opened.host_raw.fetch(b))):
                    errors.append(b)
        except Exception as e:             # reported by the assert below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        cache.drain()
        resident = len(cache)
    finally:
        sys.setswitchinterval(old)
        cache.close()
    assert not errors
    assert cache.disk_blocks == resident >= len(set(asked))
    assert cache.disk_bytes == cache.disk_blocks * opened.host_raw.block_nbytes
