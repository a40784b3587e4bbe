"""The slice end to end: repro_torch's block-major search against repro's.

A ``repro`` index is carried across with ``interop``, so both packages
search the identical arrays; the reference runs in ref mode (the jnp
oracles ``ops`` "auto" picks off-TPU).  Ids and every SearchStats counter
must be equal.  Squared distances agree to rtol 1e-5 / atol 1e-4: the
expanded form cancels two terms of size ~n (64 or 128), so each carries
an absolute error of a few ulps of n.  The results hold sqrt'd
distances, so they are squared back (in float64) before the comparison;
near zero the sqrt would magnify that error to ~sqrt(1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro.core import engine as jengine
from repro.core.search import search_block_major as j_search
from repro.core.ucr import search_scan
from repro_torch import interop
from repro_torch.core import engine as tengine
from repro_torch.core.index import build as t_build
from repro_torch.core.search import search_block_major as t_search
from repro_torch.data import random_walk

KS = (1, 5, 32)


@pytest.fixture(scope="module")
def data():
    raw = random_walk(1024, 128, seed=13)
    rng = np.random.default_rng(29)
    qs = raw[rng.choice(1024, 6, replace=False)] \
        + 0.1 * rng.standard_normal((6, 128)).astype(np.float32)
    return raw, qs


def _carry(ji):
    arrays = {name: np.array(getattr(ji, name)) for name in interop.ARRAYS}
    return interop.block_index_from_arrays(
        arrays, n=ji.n, w=ji.w, card=ji.card, capacity=ji.capacity,
        n_real=ji.n_real, device="cpu")


@pytest.fixture(scope="module")
def indexes(data):
    ji = jcore.build(jnp.asarray(data[0]), capacity=64)
    return ji, _carry(ji)


@pytest.fixture(scope="module")
def tiny():
    """20 real series: k=32 > n_real exercises the (INF, -1) padding rows."""
    raw = random_walk(20, 64, seed=5)
    ji = jcore.build(jnp.asarray(raw), capacity=8)
    return ji, _carry(ji), raw[:3] * 1.01


def _close_sq(got_dist, want_dist):
    g = got_dist.numpy().astype(np.float64)
    w = np.array(want_dist).astype(np.float64)
    np.testing.assert_allclose(g ** 2, w ** 2, rtol=1e-5, atol=1e-4)


def _same(got, want):
    assert np.array_equal(got.idx.numpy(), np.array(want.idx))
    _close_sq(got.dist, want.dist)
    for name, g, w in zip(got.stats._fields, got.stats, want.stats):
        assert np.array_equal(g.numpy(), np.array(w)), name


@pytest.mark.parametrize("k", KS)
def test_block_major_matches_reference(indexes, data, k):
    ji, ti = indexes
    qs = data[1]
    _same(t_search(ti, torch.from_numpy(qs), k=k, device="cpu"),
          j_search(ji, jnp.asarray(qs), k=k))


@pytest.mark.parametrize("k", [5, 32])
def test_tiny_padding_matches_reference(tiny, k):
    ji, ti, qs = tiny
    got = t_search(ti, qs, k=k, device="cpu")
    _same(got, j_search(ji, jnp.asarray(qs), k=k))
    if k > 20:
        assert np.all(got.idx.numpy()[:, 20:] == -1)


def test_tiny_k1_zero_distance_noise_moves_only_stats(tiny):
    """Known parity limit: each tiny query is a scaled copy of an indexed
    series, so after z-normalization its true nearest distance is 0.  Both
    packages clamp the expanded form at 0, but the reference's fp32
    products land a few ulps of ||q||^2 + ||x||^2 either side of 0 while
    the port's float64 evaluation lands next to it, so the two k=1
    thresholds differ inside that noise band, and a block whose lower
    bound is 0.0 is visited by the side with the larger threshold.  Ids
    and distances still agree; only that query's counters move."""
    ji, ti, qs = tiny
    got = t_search(ti, qs, k=1, device="cpu")
    want = j_search(ji, jnp.asarray(qs), k=1)
    assert np.array_equal(got.idx.numpy(), np.array(want.idx))
    _close_sq(got.dist, want.dist)
    g_sq = got.dist.numpy()[:, 0].astype(np.float64) ** 2
    w_sq = np.array(want.dist)[:, 0].astype(np.float64) ** 2
    moved = np.zeros(len(qs), dtype=bool)
    for g, w in zip(got.stats[:3], want.stats[:3]):
        moved |= g.numpy() != np.array(w)
    # only queries whose thresholds differ inside the zero-noise band move
    assert np.all((np.maximum(g_sq, w_sq)[moved] < 1e-4)
                  & (g_sq[moved] != w_sq[moved]))


def test_initial_threshold_and_deadline(indexes, data):
    ji, ti = indexes
    qs = data[1]
    thr = np.array(j_search(ji, jnp.asarray(qs), k=1).dist[:, 0]) ** 2 + 1e-3
    _same(t_search(ti, qs, k=5, initial_threshold=torch.from_numpy(thr),
                   device="cpu"),
          j_search(ji, jnp.asarray(qs), k=5, initial_threshold=jnp.asarray(thr)))
    for deadline in (1, 3):
        _same(t_search(ti, qs, k=5, deadline_blocks=deadline, device="cpu"),
              j_search(ji, jnp.asarray(qs), k=5, deadline_blocks=deadline))


def test_prepared_resume(indexes, data):
    ji, ti = indexes
    qs = torch.from_numpy(data[1])
    plan = tengine.QueryPlan(k=5)
    prep = tengine.prepare(plan.metric, ti, qs, 5)
    resumed = tengine.run(ti, qs, plan, prepared=prep, device="cpu")
    _same(resumed, jengine.run(ji, jnp.asarray(data[1]), jengine.QueryPlan(k=5)))
    # resuming does not consume the prepared state
    again = tengine.run(ti, qs, plan, prepared=prep, device="cpu")
    assert torch.equal(again.idx, resumed.idx)
    with pytest.raises(ValueError, match="k=5"):
        tengine.run(ti, qs, tengine.QueryPlan(k=3), prepared=prep,
                    device="cpu")
    with pytest.raises(ValueError, match="queries"):
        tengine.run(ti, qs[:2], plan, prepared=prep, device="cpu")


def test_own_build_matches_scan_oracle(data):
    raw, qs = data
    ti = t_build(raw, capacity=64, device="cpu")
    got = t_search(ti, qs, k=5, device="cpu")
    want = search_scan(jnp.asarray(raw), jnp.asarray(qs), k=5)
    assert np.array_equal(got.idx.numpy(), np.array(want.idx))
    _close_sq(got.dist, want.dist)


def test_plan_validation_and_later_slices(indexes, data):
    _, ti = indexes
    with pytest.raises(ValueError, match="deadline_blocks"):
        tengine.QueryPlan(deadline_blocks=0)
    with pytest.raises(ValueError, match="schedule"):
        tengine.QueryPlan(schedule="nope")
    with pytest.raises(ValueError, match="run_flat"):
        tengine.run(ti, data[1], tengine.QueryPlan(schedule="flat"),
                    device="cpu")
    # the cached backend (the on-disk slice) walks block-major only, and
    # fed the resident blocks it answers as the in-memory walk does
    with pytest.raises(ValueError, match="block-major"):
        tengine.run_cached(ti, data[1], tengine.QueryPlan(schedule="flat"),
                           fetch=lambda b: ti.raw[b])
    front, _, _ = tengine.run_cached(ti, torch.from_numpy(data[1]),
                                     tengine.QueryPlan(k=5),
                                     fetch=lambda b: ti.raw[b])
    assert torch.equal(front.ids,
                       t_search(ti, data[1], k=5, device="cpu").idx)
