"""repro_torch.core.isax against repro.core.isax on the same numpy inputs.

Tolerances: ``znorm`` and ``paa`` reduce in another order than XLA's CPU
reductions, so they agree to rtol 1e-6 / atol 1e-6 (z-normed values are
O(1)); everything downstream of a shared float input (symbols, region
bounds, sort keys, the sort permutation) must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.core import isax as jisax
from repro_torch.core import isax as tisax
from repro_torch.data import random_walk
from _torch_parity import one_intra_op_thread  # noqa: F401


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.array(t)


def test_breakpoint_tables_are_identical():
    assert np.array_equal(tisax.breakpoints(256), jisax.breakpoints(256))
    for a, b in zip(tisax.region_tables(256), jisax.region_tables(256)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [64, 128])
def test_znorm_and_paa(n):
    x = random_walk(97, n, seed=3)
    zt = tisax.znorm(torch.from_numpy(x))
    zj = jisax.znorm(jnp.asarray(x))
    np.testing.assert_allclose(_np(zt), _np(zj), rtol=1e-6, atol=1e-6)
    # PAA on one shared input
    np.testing.assert_allclose(_np(tisax.paa(torch.from_numpy(_np(zj)))),
                               _np(jisax.paa(zj)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [64, 100, 256])
def test_znorm_of_a_row_is_independent_of_the_call(n, monkeypatch):
    """A row's z-norm bits depend on its own values only: a call of 1, 2,
    7 or 300 gathered rows, or the whole array in steps of 64 rows,
    gives the bits of one call over every row (the build pipeline's
    pass 2 against ``core.build``)."""
    x = torch.from_numpy(random_walk(1000, n, seed=n))
    whole = tisax.znorm(x)
    rng = np.random.default_rng(n)
    for m in (1, 2, 7, 300):
        rows = torch.from_numpy(rng.choice(1000, m, replace=False))
        assert torch.equal(tisax.znorm(x[rows]), whole[rows]), m
    monkeypatch.setattr(tisax, "ZNORM_ROWS", 64)
    assert torch.equal(tisax.znorm(x), whole)


def test_symbols_and_bounds_on_shared_paa():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((500, 16)).astype(np.float32)
    # put some values exactly on breakpoints: '>=' counts them
    p[0, :8] = jisax.breakpoints(256)[:8 * 31:31]
    st = tisax.sax_from_paa(torch.from_numpy(p))
    sj = jisax.sax_from_paa(jnp.asarray(p))
    assert st.dtype == torch.int32
    assert np.array_equal(_np(st), _np(sj))
    assert np.array_equal(_np(tisax.bounds_from_sax(st)),
                          _np(jisax.bounds_from_sax(sj)))


def test_summarize_and_mindist():
    x = random_walk(64, 128, seed=11)
    pt, stt, bt = tisax.summarize(torch.from_numpy(x))
    pj, sj, bj = jisax.summarize(jnp.asarray(x))
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-6, atol=1e-6)
    flips = _np(stt) != _np(sj)
    near = np.abs(_np(pj)[flips]
                  - jisax.breakpoints(256)[np.minimum(_np(stt), _np(sj))[flips]])
    assert np.all(near < 1e-5)
    q = _np(pj)[:5]
    lb_t = tisax.mindist_paa_bounds_sq(torch.from_numpy(q)[:, None],
                                       torch.from_numpy(_np(bj))[None], 128)
    lb_j = jisax.mindist_paa_bounds_sq(jnp.asarray(q)[:, None],
                                       jnp.asarray(bj)[None], 128)
    np.testing.assert_allclose(_np(lb_t), _np(lb_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w", [4, 8, 16])
def test_interleaved_keys(w):
    rng = np.random.default_rng(w)
    sax = rng.integers(0, 256, (300, w)).astype(np.int32)
    kt = tisax.interleaved_keys(torch.from_numpy(sax), w)
    kj = jisax.interleaved_keys(jnp.asarray(sax), w)
    assert len(kt) == len(kj)
    for a, b in zip(kt, kj):
        assert a.dtype == torch.int64
        assert np.array_equal(_np(a), _np(b).astype(np.int64))


@pytest.mark.parametrize("distinct_words", [3, 40, 10_000])
def test_sort_order_is_the_stable_lexsort(distinct_words):
    """Few distinct words => many equal keys: stability decides the order."""
    rng = np.random.default_rng(distinct_words)
    words = rng.integers(0, 256, (distinct_words, 16)).astype(np.int32)
    sax = words[rng.integers(0, distinct_words, 2000)]
    pt = tisax.sort_order(torch.from_numpy(sax))
    pj = jisax.sort_order(jnp.asarray(sax))
    assert np.array_equal(_np(pt), _np(pj))


@pytest.mark.parametrize("n", [64, 256])
def test_paa_lb_sq_and_its_bound(n):
    """The squared PAA lower bound equals repro's on the same PAA, and
    bounds the squared distance of the z-normed series from below."""
    x = tisax.znorm(torch.from_numpy(random_walk(40, n, seed=9)))
    q = tisax.znorm(torch.from_numpy(random_walk(6, n, seed=10)))
    qp, sp = tisax.paa(q), tisax.paa(x)
    got = tisax.paa_lb_sq(qp[:, None], sp[None], n)
    want = jisax.paa_lb_sq(jnp.asarray(_np(qp))[:, None],
                           jnp.asarray(_np(sp))[None], n)
    assert got.shape == (6, 40)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    assert bool((got <= d * (1 + 1e-5) + 1e-5).all())
