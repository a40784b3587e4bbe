"""The engine's other cells: repro_torch against repro on the CPU.

Query-major ED (k in {1, 5, 32} and its knobs), ED without the filter,
the ParIS flat scan (seeded from the block view and standalone), the UCR
scan, Cosine, and the padding case k > n_real.  A ``repro`` index is
carried across with ``interop``, so both packages search identical
arrays; the reference runs in ref mode (the jnp versions ``ops`` "auto"
picks off the TPU).  Ids and every SearchStats counter must be equal;
squared distances agree to rtol 1e-5 / atol 1e-4 (see _torch_parity).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro.core import paris as jparis
from repro.core import vector as jvector
from repro.core.ucr import search_scan as j_scan
from _torch_parity import carry, carry_flat, same
from repro_torch import core as tcore
from repro_torch.core import engine as tengine
from repro_torch.core import paris as tparis
from repro_torch.core import vector as tvector
from repro_torch.data import random_walk
from _torch_parity import one_intra_op_thread  # noqa: F401

KS = (1, 5, 32)


@pytest.fixture(scope="module")
def data():
    raw = random_walk(1024, 128, seed=13)
    rng = np.random.default_rng(29)
    qs = raw[rng.choice(1024, 6, replace=False)] \
        + 0.1 * rng.standard_normal((6, 128)).astype(np.float32)
    return raw, qs


@pytest.fixture(scope="module")
def indexes(data):
    ji = jcore.build(jnp.asarray(data[0]), capacity=64)
    return ji, carry(ji)


@pytest.fixture(scope="module")
def threshold(indexes, data):
    """A seeded pruning bound a little above each query's k=1 distance."""
    ji, _ = indexes
    d1 = np.array(jcore.search(ji, jnp.asarray(data[1]), k=1).dist[:, 0])
    return (d1.astype(np.float64) ** 2 + 1e-3).astype(np.float32)


@pytest.mark.parametrize("k", KS)
def test_query_major_matches_reference(indexes, data, k):
    ji, ti = indexes
    qs = data[1]
    same(tcore.search(ti, qs, k=k, device="cpu"),
         jcore.search(ji, jnp.asarray(qs), k=k))


@pytest.mark.parametrize("knob", ["lb_filter", "blocks_per_iter",
                                  "deadline", "threshold"])
def test_query_major_knobs(indexes, data, threshold, knob):
    ji, ti = indexes
    qs = data[1]
    kw = {"lb_filter": dict(lb_filter=False),
          "blocks_per_iter": dict(blocks_per_iter=3),
          "deadline": dict(deadline_blocks=3),
          "threshold": dict(initial_threshold=threshold)}[knob]
    jkw = {key: jnp.asarray(v) if key == "initial_threshold" else v
           for key, v in kw.items()}
    same(tcore.search(ti, qs, k=5, device="cpu", **kw),
         jcore.search(ji, jnp.asarray(qs), k=5, **jkw))


def test_block_major_without_filter(indexes, data):
    """ED(lb_filter=False): shared panels through batch_l2 + block_topk."""
    ji, ti = indexes
    qs = data[1]
    same(tcore.search_block_major(ti, qs, k=5, lb_filter=False, device="cpu"),
         jcore.search_block_major(ji, jnp.asarray(qs), k=5, lb_filter=False))


@pytest.mark.parametrize("k", KS)
def test_flat_seeded_matches_reference(indexes, data, k):
    ji, ti = indexes
    qs = data[1]
    same(tparis.search_paris(ti, qs, k=k, chunk=256, device="cpu"),
         jparis.search_paris(ji, jnp.asarray(qs), k=k, chunk=256))


def test_flat_standalone_ragged_chunk(data):
    """No block view: an empty frontier at the start, and 1024 series in
    chunks of 200, so the last chunk is ragged."""
    raw, qs = data
    jf = jcore.build_flat(jnp.asarray(raw))
    tf = carry_flat(jf)
    same(tparis.search_flat(tf, qs, k=5, chunk=200, device="cpu"),
         jparis.search_flat(jf, jnp.asarray(qs), k=5, chunk=200))


def test_flat_deadline_and_threshold(indexes, data, threshold):
    ji, ti = indexes
    qs = data[1]
    same(tparis.search_paris(ti, qs, k=5, chunk=128,
                             initial_threshold=torch.from_numpy(threshold),
                             device="cpu"),
         jparis.search_paris(ji, jnp.asarray(qs), k=5, chunk=128,
                             initial_threshold=jnp.asarray(threshold)))
    plan = tengine.QueryPlan(schedule="flat", k=5, chunk=128,
                             deadline_blocks=2)
    jplan = jcore.engine.QueryPlan(schedule="flat", k=5, chunk=128,
                                   deadline_blocks=2)
    same(tengine.run_flat(tcore.flat_view(ti), qs, plan, device="cpu"),
         jcore.engine.run_flat(jcore.flat_view(ji), jnp.asarray(qs), jplan))


def test_build_flat_matches_reference(data):
    raw = data[0][:300]
    jf = jcore.build_flat(jnp.asarray(raw))
    tf = tcore.build_flat(raw, device="cpu")
    np.testing.assert_allclose(tf.raw.numpy(), np.array(jf.raw),
                               rtol=1e-6, atol=1e-6)
    for name in ("lo", "hi", "ids"):
        assert np.array_equal(getattr(tf, name).numpy(),
                              np.array(getattr(jf, name))), name


@pytest.mark.parametrize("k", (1, 10))
def test_ucr_scan_matches_reference(data, k):
    raw, qs = data
    same(tcore.search_scan(raw, qs, k=k, chunk=300, device="cpu"),
         j_scan(jnp.asarray(raw), jnp.asarray(qs), k=k, chunk=300))


@pytest.mark.parametrize("k", KS)
def test_cosine_matches_reference(k):
    rng = np.random.default_rng(3)
    embs = rng.standard_normal((1024, 64)).astype(np.float32)
    qs = embs[:5] + 0.3 * rng.standard_normal((5, 64)).astype(np.float32)
    ji = jvector.build_vector_index(jnp.asarray(embs), capacity=64)
    got = tvector.search_vectors(carry(ji), qs, k=k, device="cpu")
    want = jvector.search_vectors(ji, jnp.asarray(qs), k=k)
    same(got, want)
    np.testing.assert_allclose(tvector.cosine_scores(got, 64).numpy(),
                               np.array(jvector.cosine_scores(want, 64)),
                               rtol=1e-5, atol=1e-5)
    # the engine's Cosine plan is the same search
    plan = tengine.QueryPlan(metric=tengine.Cosine(), schedule="query_major",
                             k=k)
    same(tengine.run(carry(ji), qs, plan, device="cpu"), want)


def test_own_vector_index_matches_reference():
    rng = np.random.default_rng(8)
    embs = rng.standard_normal((256, 32)).astype(np.float32)
    ji = jvector.build_vector_index(jnp.asarray(embs), capacity=32)
    ti = tvector.build_vector_index(embs, capacity=32, device="cpu")
    np.testing.assert_allclose(ti.raw.numpy(), np.array(ji.raw),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(ti.ids.numpy(), np.array(ji.ids))


def test_padding_k_gt_n_real():
    """20 real series and k = 32: the (INF, -1) rows on both new
    schedules."""
    raw = random_walk(20, 64, seed=5)
    qs = random_walk(3, 64, seed=6)
    ji = jcore.build(jnp.asarray(raw), capacity=8)
    ti = carry(ji)
    got = tcore.search(ti, qs, k=32, device="cpu")
    same(got, jcore.search(ji, jnp.asarray(qs), k=32))
    assert np.all(got.idx.numpy()[:, 20:] == -1)
    same(tparis.search_paris(ti, qs, k=32, chunk=8, device="cpu"),
         jparis.search_paris(ji, jnp.asarray(qs), k=32, chunk=8))
    same(tcore.search_scan(raw, qs, k=32, chunk=8, device="cpu"),
         j_scan(jnp.asarray(raw), jnp.asarray(qs), k=32, chunk=8))


@pytest.mark.parametrize("lb_filter", [True, False])
def test_refine_panel_shim(indexes, data, lb_filter):
    """search.refine_panel: one block against every query, as the
    reference's shim refines it."""
    import importlib
    from repro.core import frontier as jfront
    from repro_torch.core import frontier as tfront
    from repro_torch.core import isax
    # the packages export a ``search`` function that shadows the module
    jsearch = importlib.import_module("repro.core.search")
    tsearch = importlib.import_module("repro_torch.core.search")
    ji, ti = indexes
    q = isax.znorm(torch.from_numpy(data[1]))
    q_paa = isax.paa(q, 16)
    thr = np.full(6, 60.0, np.float32)
    active = np.array([1, 0, 1, 1, 1, 0], bool)
    b = 3
    got_f, got_s = tsearch.refine_panel(
        q, q_paa, tfront.init(6, 5, torch.device("cpu")),
        tfront.stats_init(6, torch.device("cpu")), ti.raw[b], ti.ids[b],
        ti.slo[b], ti.shi[b], torch.from_numpy(active), torch.from_numpy(thr),
        n=128, w=16, lb_filter=lb_filter)
    want_f, want_s = jsearch.refine_panel(
        jnp.asarray(q.numpy()), jnp.asarray(q_paa.numpy()),
        jfront.init(6, 5), jfront.stats_init(6), ji.raw[b], ji.ids[b],
        ji.slo[b], ji.shi[b], jnp.asarray(active), jnp.asarray(thr),
        n=128, w=16, lb_filter=lb_filter)
    assert np.array_equal(got_f.ids.numpy(), np.array(want_f.ids))
    np.testing.assert_allclose(got_f.dists.numpy(), np.array(want_f.dists),
                               rtol=1e-5, atol=1e-4)
    for g, w in zip(got_s, want_s):
        assert np.array_equal(g.numpy(), np.array(w))


def test_run_refuses_flat_plan(indexes, data):
    _, ti = indexes
    with pytest.raises(ValueError, match="run_flat"):
        tengine.run(ti, data[1], tengine.QueryPlan(schedule="flat"),
                    device="cpu")
