"""The port's serving layer (``repro_torch.serve``, ``SearchSession``'s
``submit`` / ``drain`` and ``search(deadline_blocks=...)``) against
repro's, on the CPU.

Both packages serve the same repro-written ``.dsix`` file (the data of
``tests/test_serve.py``), at (pipeline_depth, group_blocks) = (1, 1) and
(4, 8).  The port's coalesced drain answers bitwise as its isolated
sessions do and fetches fewer blocks; against repro's drain (mixed
metrics and k, same-plan tickets merged) ids, every ``SearchStats``
counter and every ``IOStats`` field are equal and squared distances agree
to rtol 1e-5 / atol 1e-4 (``tests/_torch_parity.py``'s bar).  Anytime
certificates equal repro's (bounds within rtol / atol 1e-5, ``exact``
flags and deferred-block counts equal), bracket the truth and tighten
with the deadline; ``refine_to_exact`` is bitwise the exact answer,
cheaper, and consumable once.  repro runs in ref mode (its default on the
CPU).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from conftest import run_subprocess
from repro import serve as jserve
from repro import storage as jst
from repro.core import engine as jengine
from repro_torch import serve as tserve
from repro_torch import storage as tst
from repro_torch.core import engine as tengine
from repro_torch.core.ucr import search_scan
from repro_torch.data import random_walk

N, LEN, CAP = 4000, 128, 128
GRID = [(1, 1), (4, 8)]
# enough readers that no speculative read is declined at the in-flight
# bound: which reads a walk makes must not depend on timing when two
# walks' IOStats are compared
READERS = 8


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    raw = random_walk(N, LEN, seed=31)
    rng = np.random.default_rng(17)
    picks = rng.choice(N, 12, replace=False)
    qs = raw[picks] + 0.05 * rng.standard_normal((12, LEN)).astype(np.float32)
    return raw, qs


@pytest.fixture(scope="module")
def path(dataset, tmp_path_factory):
    raw, _ = dataset
    p = tmp_path_factory.mktemp("serve") / "rw.dsix"
    jst.save_index(jcore.build(jnp.asarray(raw), capacity=CAP), p)
    return p


@pytest.fixture(scope="module")
def opened(path):
    return tst.open_index(path, device="cpu")


@pytest.fixture
def qs(dataset):
    return torch.from_numpy(dataset[1])


def _session(opened, d=1, g=1, cache_blocks=64):
    return tst.SearchSession(opened, cache_blocks=cache_blocks,
                             readers=READERS, pipeline_depth=d,
                             group_blocks=g, device="cpu")


def _jsession(path, d=1, g=1, cache_blocks=64):
    return jst.SearchSession(jst.open_index(path), cache_blocks=cache_blocks,
                             readers=READERS, pipeline_depth=d,
                             group_blocks=g)


def _bitwise(got, want):
    assert torch.equal(got.idx, want.idx)
    assert torch.equal(got.dist, want.dist)


def _same(got, want):
    """The parity bar against a repro result."""
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.dist.numpy().astype(np.float64) ** 2,
                               np.asarray(want.dist).astype(np.float64) ** 2,
                               rtol=1e-5, atol=1e-4)
    for f, a, b in zip(got.stats._fields, got.stats, want.stats):
        assert np.array_equal(a.numpy(), np.asarray(b)), f


def _isolated(opened, batches, d=1, g=1):
    """Each batch through its own fresh session -> (results, total disk
    blocks over all the sessions)."""
    results, fetched = [], 0
    for q, kw in batches:
        with _session(opened, d, g) as sess:
            results.append(sess.search(q, **kw))
            fetched += sess.blocks_fetched
    return results, fetched


# ---------------------------------------------------------------------------
# coalesced serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,g", GRID)
def test_coalesced_drain_bit_identical_to_isolated(opened, qs, d, g):
    batches = [(qs[0:4], dict(k=5)), (qs[4:8], dict(k=1)),
               (qs[8:12], dict(k=3))]
    want, isolated_fetches = _isolated(opened, batches, d, g)
    with _session(opened, d, g) as sess:
        tickets = [sess.submit(q, **kw) for q, kw in batches]
        resolved = sess.drain()
        assert set(resolved) == set(tickets)
        for t, w in zip(tickets, want):
            _bitwise(t.result(), w)
        assert sess.blocks_fetched < isolated_fetches
        assert sess.batches == len(batches)


MIXED = [  # (query rows, search kwargs for repro, for the port)
    (slice(0, 2), dict(k=5), dict(k=5)),
    (slice(2, 4), dict(k=5), dict(k=5)),          # same plan: merged
    (slice(4, 8), dict(k=1), dict(k=1)),
    (slice(8, 10), dict(k=3, metric=jengine.DTW(r=4)),
     dict(k=3, metric=tengine.DTW(r=4))),
    (slice(10, 12), dict(k=2, lb_filter=False), dict(k=2, lb_filter=False)),
]


@pytest.mark.parametrize("d,g", GRID)
def test_coalesced_drain_equals_reference(path, opened, dataset, d, g):
    """Mixed metrics and k, two same-plan tickets merged into one tenant:
    every ticket's answer, stats and the drain's one bill equal repro's."""
    _, qs_np = dataset
    with _jsession(path, d, g) as js:
        jt = [js.submit(jnp.asarray(qs_np[sl]), **jkw)
              for sl, jkw, _ in MIXED]
        js.drain()
        want = [t.result() for t in jt]
        jtotals = (js.batches, js.blocks_fetched, js.cache_hits)
    with _session(opened, d, g) as ts:
        tt = [ts.submit(torch.from_numpy(qs_np[sl]), **tkw)
              for sl, _, tkw in MIXED]
        ts.drain()
        got = [t.result() for t in tt]
        assert (ts.batches, ts.blocks_fetched, ts.cache_hits) == jtotals
    for g_, w in zip(got, want):
        _same(g_, w)
        assert tuple(g_.io) == tuple(w.io)


def test_coalesced_drain_matches_oracle(dataset, opened, qs):
    raw, _ = dataset
    with _session(opened) as sess:
        t = sess.submit(qs, k=5)
        sess.drain()
        got = t.result()
    want = search_scan(raw, qs, k=5, device="cpu")
    assert torch.equal(got.idx, want.idx)


@pytest.mark.parametrize("d,g", GRID)
def test_threaded_submitters_one_drain(opened, qs, d, g):
    """Tenant threads submit at once and block on their own ticket; the
    first to ask drains for everyone."""
    batches = [(qs[i:i + 3], dict(k=2)) for i in range(0, 12, 3)]
    want, _ = _isolated(opened, batches, d, g)
    got = [None] * len(batches)
    errs = []
    with _session(opened, d, g) as sess:
        barrier = threading.Barrier(len(batches))

        def tenant(i, q, kw):
            try:
                t = sess.submit(q, **kw)
                barrier.wait(timeout=60)   # all admitted before any drain
                got[i] = t.result(timeout=120)
            except BaseException as e:     # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=tenant, args=(i, q, kw))
                   for i, (q, kw) in enumerate(batches)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not any(th.is_alive() for th in threads)
        assert sess.batches == len(batches)
    assert not errs
    assert all(g_.io is got[0].io for g_ in got)      # one drain, one bill
    for g_, w in zip(got, want):
        _bitwise(g_, w)



def _submit_from_threads(opened, qs, n_threads=6):
    """``n_threads`` threads ``submit`` one batch to one session at once
    -> (how many coalescers their tickets hold, the session's
    ``search`` answer, every ticket's answer, the type of the session's
    coalescer lock).  Self-contained: the sanitized test runs its source
    in a subprocess."""
    import threading
    from repro_torch import storage
    with storage.SearchSession(opened, cache_blocks=16, readers=8,
                               device="cpu") as sess:
        want = sess.search(qs, k=3)
        start = threading.Barrier(n_threads)
        tickets = [None] * n_threads

        def submitter(i):
            start.wait(timeout=60)
            tickets[i] = sess.submit(qs, k=3)

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        coalescers = {id(t._coalescer) for t in tickets}
        sess.drain()
        got = [t.result(timeout=60) for t in tickets]
        lock = type(sess._coalescer_lock).__name__
    return len(coalescers), want, got, lock


def test_concurrent_submit_builds_one_coalescer(opened, qs):
    """Concurrent submitters share ONE coalescer (the check-create-read
    of ``_get_coalescer`` runs under its lock) and every ticket resolves
    bitwise to ``search``'s answer."""
    from repro_torch.analysis import sanitize
    n_coalescers, want, got, lock = _submit_from_threads(opened, qs[:4])
    assert n_coalescers == 1
    assert (lock == "InstrumentedLock") == sanitize.enabled()
    for g_ in got:
        _bitwise(g_, want)


def test_concurrent_submit_under_the_sanitizer(path, qs, tmp_path):
    """The same, in a subprocess with ``REPRO_SANITIZE=1``: the session's
    locks are instrumented and no guarded write raises ``SanitizeError``."""
    import inspect
    np.save(tmp_path / "qs.npy", qs[:4].numpy())
    code = "\n".join([
        "import os; os.environ['REPRO_SANITIZE'] = '1'",
        "import numpy as np, torch",
        "from repro_torch import storage",
        "from repro_torch.analysis import sanitize",
        inspect.getsource(_submit_from_threads),
        f"opened = storage.open_index({str(path)!r}, device='cpu')",
        f"qs = torch.from_numpy(np.load({str(tmp_path / 'qs.npy')!r}))",
        "n, want, got, lock = _submit_from_threads(opened, qs)",
        "same = all(torch.equal(g.idx, want.idx) and "
        "torch.equal(g.dist, want.dist) for g in got)",
        "print('RESULT', sanitize.enabled(), n, lock, same)",
    ])
    out = run_subprocess(code, devices=1, timeout=300)
    assert "RESULT True 1 InstrumentedLock True" in out

def test_drain_empty_and_ticket_reuse(opened, qs):
    with _session(opened) as sess:
        assert sess.drain() == []
        t = sess.submit(qs[:2], k=1)
        sess.drain()
        r1 = t.result()
        assert t.result() is r1          # a resolved ticket answers again
        assert sess.drain() == []        # nothing pending any more


def test_submit_rejects_per_ticket_deadline(opened, qs):
    with _session(opened) as sess:
        coal = tserve.AdmissionCoalescer(sess)
        plan = tengine.QueryPlan(metric=tengine.ED(), k=1,
                                 deadline_blocks=3)
        with pytest.raises(ValueError, match="drain"):
            coal.submit(qs[:1], plan)
        with pytest.raises(ValueError, match="deadline_blocks"):
            coal.drain(deadline_blocks=0)


def test_drain_error_reaches_every_ticket(opened, qs, monkeypatch):
    """A walk that raises resolves every ticket of its drain to the error,
    and the session serves the next drain."""
    from repro_torch.serve import coalescer

    def broken(*a, **kw):
        raise RuntimeError("walk failed")

    with _session(opened) as sess:
        tickets = [sess.submit(qs[:2], k=1), sess.submit(qs[2:4], k=3)]
        with monkeypatch.context() as m:
            m.setattr(coalescer, "coalesced_walk", broken)
            with pytest.raises(RuntimeError, match="walk failed"):
                sess.drain()
        for t in tickets:
            assert t.done
            with pytest.raises(RuntimeError, match="walk failed"):
                t.result()
        t = sess.submit(qs[:2], k=1)
        sess.drain()
        assert t.result().idx.shape == (2, 1)


# ---------------------------------------------------------------------------
# anytime answers and certificates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exact_k5(opened, dataset):
    with _session(opened) as sess:
        return sess.search(torch.from_numpy(dataset[1]), k=5)


@pytest.mark.parametrize("deadline", [1, 2, 4, 8, 16])
def test_anytime_certificate_equals_reference(path, opened, qs, exact_k5,
                                              deadline):
    """The certificate equals repro's and brackets the true k-th."""
    with _jsession(path) as js:
        want = js.search(jnp.asarray(qs.numpy()), k=5,
                         deadline_blocks=deadline)
    with _session(opened) as sess:
        got = sess.search(qs, k=5, deadline_blocks=deadline)
    assert isinstance(got, tserve.AnytimeResult)
    assert isinstance(want, jserve.AnytimeResult)
    _same(got, want)
    assert tuple(got.io) == tuple(want.io)
    c, w = got.certificate, want.certificate
    np.testing.assert_allclose(c.upper, w.upper, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.lower, w.lower, rtol=1e-5, atol=1e-5)
    assert np.array_equal(c.exact, w.exact)
    assert np.array_equal(c.blocks_deferred, w.blocks_deferred)
    true_kth = exact_k5.dist[:, -1].numpy()
    assert (c.upper >= true_kth - 1e-5 * np.abs(true_kth)).all()
    assert (c.lower <= true_kth + 1e-5 * np.abs(true_kth)).all()
    assert (c.lower <= c.upper).all() and (c.gap >= 0).all()
    assert np.allclose(c.gap[c.exact], 0.0)


def test_anytime_tightens_monotonically(opened, qs):
    prev = None
    for deadline in (1, 2, 4, 8, 16, 32):
        with _session(opened) as sess:
            c = sess.search(qs, k=5, deadline_blocks=deadline).certificate
        if prev is not None:
            assert (c.upper <= prev.upper + 1e-6).all()
            assert (c.lower >= prev.lower - 1e-6).all()
            assert (c.blocks_deferred <= prev.blocks_deferred).all()
        prev = c


@pytest.mark.parametrize("d,g", GRID)
def test_refine_to_exact_bit_identical_and_cheaper(opened, qs, d, g):
    with _session(opened, d, g) as ref:
        want = ref.search(qs, k=5)
        cold_fetches = ref.blocks_fetched
    with _session(opened, d, g) as sess:
        a = sess.search(qs, k=5, deadline_blocks=3)
        deferred_before = int(a.certificate.blocks_deferred.max())
        got = a.refine_to_exact()
    _bitwise(got, want)
    for x, y in zip(got.stats, want.stats):
        assert torch.equal(x, y)
    assert got.io.blocks_fetched < cold_fetches
    assert deferred_before > 0           # the deadline did cut


def test_refine_to_exact_consumes_once(opened, qs):
    with _session(opened) as sess:
        a = sess.search(qs[:3], k=2, deadline_blocks=1)
        assert torch.equal(a.nn_idx, a.idx[:, 0])
        a.refine_to_exact()
        with pytest.raises(ValueError, match="consumed"):
            a.refine_to_exact()


@pytest.mark.parametrize("d,g", GRID)
def test_budgeted_drain_mixes_exact_and_anytime(path, opened, qs, d, g):
    """A deadline-cut drain resolves finished tenants exact and cut ones
    anytime, as repro's does; each anytime continuation lands on its
    isolated exact answer bitwise."""
    batches = [(slice(0, 4), 5), (slice(4, 8), 3), (slice(8, 9), 1)]
    want, _ = _isolated(opened, [(qs[sl], dict(k=k)) for sl, k in batches],
                        d, g)
    with _jsession(path, d, g) as js:
        jt = [js.submit(jnp.asarray(qs[sl].numpy()), k=k)
              for sl, k in batches]
        js.drain(deadline_blocks=2)
        jres = [t.result() for t in jt]
    with _session(opened, d, g) as sess:
        tickets = [sess.submit(qs[sl], k=k) for sl, k in batches]
        sess.drain(deadline_blocks=2)
        kinds = []
        for t, w, jr in zip(tickets, want, jres):
            r = t.result()
            anytime = isinstance(r, tserve.AnytimeResult)
            kinds.append(anytime)
            assert anytime == isinstance(jr, jserve.AnytimeResult)
            _same(r, jr)
            if anytime:
                c = r.certificate
                true_kth = w.dist[:, -1].numpy()
                assert (c.upper >= true_kth - 1e-5 * np.abs(true_kth)).all()
                assert (c.lower <= true_kth + 1e-5 * np.abs(true_kth)).all()
                np.testing.assert_allclose(c.lower, jr.certificate.lower,
                                           rtol=1e-5, atol=1e-5)
                _bitwise(r.refine_to_exact(), w)
            else:
                _bitwise(r, w)
    assert any(kinds)


def test_session_deadline_validation(opened, qs):
    with _session(opened) as sess:
        with pytest.raises(ValueError, match="deadline_blocks"):
            sess.search(qs[:2], k=1, deadline_blocks=0)
        prep = sess.approximate_threshold(qs[:2], k=1)
        with pytest.raises(ValueError, match="fresh batch"):
            sess.search(qs[:2], k=1, prepared=prep, deadline_blocks=2)
        with pytest.raises(ValueError, match="fresh batch"):
            sess.search(qs[:2], k=1, deadline_blocks=2,
                        initial_threshold=torch.ones(2))


def test_close_is_idempotent(opened, qs):
    sess = _session(opened, cache_blocks=8)
    sess.search(qs[:2], k=1)
    sess.close()
    sess.close()
    with _session(opened, cache_blocks=8) as cm:
        cm.search(qs[:2], k=1)
        cm.close()                        # explicit close inside the block


# ---------------------------------------------------------------------------
# the block cache's clear() and the session's bill (against repro's)
# ---------------------------------------------------------------------------

def test_block_cache_clear_equals_reference(path, opened):
    jhost = jst.open_index(path).host_raw
    jc = jst.BlockCache(jhost, 4)
    tc = tst.BlockCache(opened.host_raw, 4, device="cpu")
    try:
        for c in (jc, tc):
            for b in (0, 1, 2):
                c.prefetch(b)
            c.get(3)
            c.clear()
        assert (len(tc), tc.disk_blocks, tc.disk_bytes, tc.demand_misses) \
            == (len(jc), jc.disk_blocks, jc.disk_bytes, jc.demand_misses) \
            == (0, 4, 4 * opened.host_raw.block_nbytes, 1)
        assert 3 not in tc
        assert torch.equal(tc.get(3), torch.from_numpy(
            np.array(jc.get(3))))            # a read again after the clear
        assert tc.disk_blocks == jc.disk_blocks == 5
    finally:
        jc.close()
        tc.close()


def test_bill_counts_batches_as_reference(path, opened):
    """A coalesced drain bills once for N batches (``_bill(batches=N)``)."""
    from repro.storage.cache import _TouchTracker as JTracker
    from repro_torch.storage.cache import _TouchTracker as TTracker
    with _jsession(path) as js, _session(opened) as ts:
        jio = js._bill(JTracker(js.cache), batches=3, blocks_refined=2)
        tio = ts._bill(TTracker(ts.cache), batches=3, blocks_refined=2)
        assert tuple(tio) == tuple(jio)
        assert (ts.batches, ts.blocks_fetched, ts.cache_hits) \
            == (js.batches, js.blocks_fetched, js.cache_hits) == (3, 0, 0)
