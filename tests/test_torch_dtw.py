"""The DTW metric over the unchanged index: repro_torch against repro.

The Keogh envelope, LB_Keogh and the interval-to-region block bound, then
``search_dtw`` (query-major), DTW on the block-major schedule and
``search_dtw_flat`` (seeded and standalone), with a deadline.  A ``repro``
index is carried across with ``interop``; the reference runs in ref mode.
Ids and every SearchStats counter must be equal; squared distances agree
to rtol 1e-5 / atol 1e-4 (the banded DP itself is bitwise the reference's,
see test_torch_kernels_ref, but each package z-normalizes the queries in
its own summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro.core import dtw as jdtw
from repro.core import engine as jengine
from _torch_parity import carry, carry_flat, same
from repro_torch import core as tcore
from repro_torch.core import dtw as tdtw
from repro_torch.core import engine as tengine
from repro_torch.core import isax
from repro_torch.data import random_walk

R = 4


@pytest.fixture(scope="module")
def data():
    raw = random_walk(512, 64, seed=17)
    rng = np.random.default_rng(31)
    qs = raw[rng.choice(512, 5, replace=False)] \
        + 0.2 * rng.standard_normal((5, 64)).astype(np.float32)
    return raw, qs


@pytest.fixture(scope="module")
def indexes(data):
    ji = jcore.build(jnp.asarray(data[0]), capacity=32)
    return ji, carry(ji)


def test_envelope_and_bounds_match_reference(indexes, data):
    ji, ti = indexes
    raw, qs = data
    q = isax.znorm(torch.from_numpy(qs))
    u, l = tdtw.query_envelope(q, R)
    ju, jl = jdtw.query_envelope(jnp.asarray(q.numpy()), R)
    assert np.array_equal(u.numpy(), np.array(ju))
    assert np.array_equal(l.numpy(), np.array(jl))
    x = torch.from_numpy(np.array(ji.raw[0]))
    np.testing.assert_allclose(tdtw.lb_keogh((u, l), x).numpy(),
                               np.array(jdtw.lb_keogh((ju, jl),
                                                      jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)
    got = tdtw.envelope_block_lb(ti, isax.paa(u, 16), isax.paa(l, 16))
    want = jdtw.envelope_block_lb(ji, jcore.isax.paa(ju, 16),
                                  jcore.isax.paa(jl, 16))
    np.testing.assert_allclose(got.numpy(), np.array(want),
                               rtol=1e-6, atol=1e-6)


def _envelopes_with_sentinel_edges(w, m, seed):
    """(w, m) block envelopes over random symbols with the extreme symbols
    forced in (their regions carry the +-SENTINEL edges), the last block a
    pure-padding one (SENTINEL, SENTINEL), as index.block_envelopes makes."""
    rng = np.random.default_rng(seed)
    sax = rng.integers(0, 256, (m, 5, w))
    sax[:, 0, 0] = 0
    sax[:, 1, w - 1] = 255
    b = isax.bounds_from_sax(torch.from_numpy(sax)).numpy()      # (m, 5, w, 2)
    lo, hi = b[..., 0].min(axis=1).T, b[..., 1].max(axis=1).T     # (w, m)
    lo[:, -1] = hi[:, -1] = isax.SENTINEL
    return lo.astype(np.float32).copy(), hi.astype(np.float32).copy()


@pytest.mark.parametrize("w", (8, 16))
@pytest.mark.parametrize("m", (1, 77, 300))
def test_interval_planar_lb_matches_reference(w, m):
    """The interval-to-region bound (two planar passes against planes of
    +-SENTINEL) on envelopes holding the SENTINEL edges, against repro's
    in ref mode."""
    from repro.kernels import ops as jops
    lo, hi = _envelopes_with_sentinel_edges(w, m, seed=w * 1000 + m)
    rng = np.random.default_rng(m)
    l_paa = rng.standard_normal((5, w)).astype(np.float32) * 2
    u_paa = l_paa + rng.random((5, w)).astype(np.float32)
    got = tengine.interval_planar_lb(
        torch.from_numpy(u_paa), torch.from_numpy(l_paa), torch.from_numpy(lo),
        torch.from_numpy(hi), n=64)
    with jops.kernel_mode("ref"):
        want = jengine.interval_planar_lb(
            jnp.asarray(u_paa), jnp.asarray(l_paa), jnp.asarray(lo),
            jnp.asarray(hi), n=64)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6,
                               atol=1e-6)
    assert float(got[:, -1].min()) > 1e17       # the padding block: never picked


@pytest.mark.parametrize("k", (1, 5))
def test_search_dtw_matches_reference(indexes, data, k):
    ji, ti = indexes
    qs = data[1]
    got = tdtw.search_dtw(ti, qs, r=R, k=k, device="cpu")
    same(got, jdtw.search_dtw(ji, jnp.asarray(qs), r=R, k=k))
    v = got.stats.blocks_visited
    assert torch.equal(got.stats.series_refined, v * ti.capacity)
    assert int(got.stats.iters) == 0


def test_search_dtw_deadline(indexes, data):
    ji, ti = indexes
    qs = data[1]
    same(tdtw.search_dtw(ti, qs, r=R, k=3, deadline_blocks=3, device="cpu"),
         jdtw.search_dtw(ji, jnp.asarray(qs), r=R, k=3, deadline_blocks=3))


def test_dtw_block_major_matches_reference(indexes, data):
    ji, ti = indexes
    qs = data[1]
    plan = tengine.QueryPlan(metric=tengine.DTW(r=R), k=3)
    jplan = jengine.QueryPlan(metric=jengine.DTW(r=R), k=3)
    same(tengine.run(ti, qs, plan, device="cpu"),
         jengine.run(ji, jnp.asarray(qs), jplan))


@pytest.mark.parametrize("seeded", [False, True])
def test_search_dtw_flat_matches_reference(indexes, data, seeded):
    ji, ti = indexes
    raw, qs = data
    jf = jcore.build_flat(jnp.asarray(raw))
    got = tdtw.search_dtw_flat(carry_flat(jf), qs, r=R, k=3,
                               block_index=ti if seeded else None,
                               chunk=100, device="cpu")
    same(got, jdtw.search_dtw_flat(jf, jnp.asarray(qs), r=R, k=3,
                                   block_index=ji if seeded else None,
                                   chunk=100))


def test_search_dtw_flat_deadline(indexes, data):
    ji, ti = indexes
    qs = data[1]
    same(tdtw.search_dtw_flat(tcore.flat_view(ti), qs, r=R, k=3, chunk=64,
                              deadline_blocks=2, device="cpu"),
         jdtw.search_dtw_flat(jcore.flat_view(ji), jnp.asarray(qs), r=R, k=3,
                              chunk=64, deadline_blocks=2))


def test_search_dtw_is_exact(data):
    """The walk's pruning against a full DTW scan of every series."""
    raw, qs = data
    ti = tcore.build(raw, capacity=32, device="cpu")
    got = tdtw.search_dtw(ti, qs, r=R, k=5, device="cpu")
    full = tdtw.dtw_band(isax.znorm(torch.from_numpy(qs))[:, None, :],
                         isax.znorm(torch.from_numpy(raw))[None], R)
    want = torch.sort(full, dim=1, stable=True)
    assert torch.equal(got.idx.long(), want.indices[:, :5])
    np.testing.assert_allclose(got.dist.numpy() ** 2,
                               want.values[:, :5].numpy(),
                               rtol=1e-6, atol=1e-6)
