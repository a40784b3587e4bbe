"""The port's plain kernel versions against repro.kernels.ref's.

The sweeps follow tests/test_kernels.py: Q in {1, 6, 13}, ragged C,
k in {1, 5, 32} including k > C, all-dead and thr = -inf rows, pad lanes
and distance ties (which must break toward the smaller id).  Selection
(ids, live counts, symbols) must be exactly equal.  Tolerances for
floats: PAA and lower bounds rtol 1e-6 / atol 1e-6 (reductions of O(1)
terms in another order); squared distances rtol 1e-5 / atol 1e-4 (the
expanded form cancels two terms of size ~n = 64, so a few ulps of n).
The banded DTW is elementwise arithmetic with no reduction and must be
bitwise equal: XLA does not contract its (a - b) * (a - b) + best into an
FMA here, because a select on the band mask sits between the two.  The
selective scan agrees to rtol / atol 1e-4, the bar of
tests/test_kernels.py's scan test, at that test's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.core import isax as jisax
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.data import random_walk
from _torch_parity import one_intra_op_thread  # noqa: F401

QS = (1, 6, 13)
KS = (1, 5, 32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("normalize", [False, True])
def test_isax_summarize_ref(normalize):
    x = random_walk(37, 64, seed=2)
    if not normalize:
        x = np.array(jisax.znorm(jnp.asarray(x)))
    pt, st = tref.isax_summarize_ref(_t(x), w=16, card=256, normalize=normalize)
    pj, sj = jref.isax_summarize_ref(jnp.asarray(x), w=16, card=256,
                                     normalize=normalize)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-6, atol=1e-6)
    flips = _np(st) != _np(sj)
    bp = jisax.breakpoints(256)[np.minimum(_np(st), _np(sj))[flips]]
    assert np.all(np.abs(_np(pj)[flips] - bp) < 1e-5)
    assert st.dtype == torch.int32


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape,w", [((77, 48), 16), ((33, 40), 8),
                                     ((13, 60), 4), ((5, 128), 64)])
def test_isax_summarize_ref_ragged_windows(normalize, shape, w):
    """Windows whose length is no multiple of 4, and w outside 16."""
    x = random_walk(*shape, seed=w)
    if not normalize:
        x = np.array(jisax.znorm(jnp.asarray(x)))
    pt, st = tref.isax_summarize_ref(_t(x), w=w, card=256, normalize=normalize)
    pj, sj = jref.isax_summarize_ref(jnp.asarray(x), w=w, card=256,
                                     normalize=normalize)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-6, atol=1e-6)
    flips = _np(st) != _np(sj)
    bp = jisax.breakpoints(256)[np.minimum(_np(st), _np(sj))[flips]]
    assert np.all(np.abs(_np(pj)[flips] - bp) < 1e-5)


@pytest.mark.parametrize("w", [4, 8, 16, 32])
@pytest.mark.parametrize("qn", QS)
@pytest.mark.parametrize("n_items", [1, 77, 300])
def test_lb_scan_ref(qn, n_items, w):
    rng = np.random.default_rng(qn * 1000 + n_items)
    q = rng.standard_normal((qn, w)).astype(np.float32)
    lo = rng.standard_normal((w, n_items)).astype(np.float32)
    hi = lo + rng.random((w, n_items)).astype(np.float32)
    lo[0, 0] = -jisax.SENTINEL
    hi[1, 0] = jisax.SENTINEL
    got = tref.lb_scan_ref(_t(q), _t(lo), _t(hi), n=128)
    want = jref.lb_scan_ref(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi),
                            n=128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def _panel(qn, c, seed):
    """Masked (Q, C) panel honouring the contract, with many ties."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (qn, c)).astype(np.float32)   # ties on purpose
    ids = np.stack([rng.permutation(10 * c)[:c] for _ in range(qn)]
                   ).astype(np.int32)
    pad = rng.random((qn, c)) < 0.2
    ids[pad] = -1
    d[pad] = float(tref.INF)
    if qn > 1:
        ids[1] = -1                    # an all-pad row
        d[1] = float(tref.INF)
    return d, ids


@pytest.mark.parametrize("qn", QS)
@pytest.mark.parametrize("c", [20, 37, 200])
@pytest.mark.parametrize("k", KS)
def test_block_topk_ref(qn, c, k):
    d, ids = _panel(qn, c, seed=qn * 31 + c + k)
    gd, gi = tref.block_topk_ref(_t(d), _t(ids), k)
    wd, wi = jref.block_topk_ref(jnp.asarray(d), jnp.asarray(ids), k)
    assert np.array_equal(_np(gd), _np(wd))
    assert np.array_equal(_np(gi), _np(wi))
    assert gi.dtype == torch.int32 and gd.shape == (qn, k)


@pytest.mark.parametrize("k", [1, 3, 6, 9, 12])
def test_block_topk_ref_signed_zero_negative_and_pad_lanes(k):
    """The order the CUDA kernel's 64-bit keys must reproduce: -0.0 and
    +0.0 tie and go by id (each keeps its own sign bit), negative
    distances come first, pad lanes (INF, id < 0) come after real lanes
    at INF and leave as (INF, -1), and k > C pads with (INF, -1)."""
    d = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -1.0, -0.0, 0.0, 0.0],
                  [-0.0, 0.0, -2.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
                 np.float32)
    ids = np.array([[7, 3, 5, 1, 0, 9, 11, -1, -1],
                    [4, 2, 8, 6, -1, -1, -1, -1, -1]], np.int32)
    d[0, 7:] = tref.INF
    d[0, 4] = tref.INF                    # a real lane at INF, before pads
    d[1, 4:] = tref.INF
    gd, gi = tref.block_topk_ref(_t(d), _t(ids), k)
    wd, wi = jref.block_topk_ref(jnp.asarray(d), jnp.asarray(ids), k)
    assert np.array_equal(_np(gi), _np(wi))
    assert np.array_equal(_np(gd).view(np.uint32), _np(wd).view(np.uint32))
    assert gi[0, :min(k, 6)].tolist() == [9, 1, 3, 5, 7, 11][:k]


def test_topk_by_dist_id_orders_ties_by_id():
    d = np.array([[3.0, 1.0, 1.0, 1.0, 2.0]], np.float32)
    ids = np.array([[0, 9, 4, -1, 7]], np.int32)
    sd, si = tref.topk_by_dist_id(_t(d), _t(ids), 7)
    assert si.tolist() == [[4, 9, -1, 7, 0, -1, -1]]
    assert sd[0, :5].tolist() == [1.0, 1.0, 1.0, 2.0, 3.0]
    assert np.all(_np(sd)[0, 5:] == tref.INF)


@pytest.mark.parametrize("qn", QS)
def test_batch_l2_ref(qn):
    rng = np.random.default_rng(4 + qn)
    q = rng.standard_normal((qn, 64)).astype(np.float32)
    x = rng.standard_normal((50, 64)).astype(np.float32)
    x[-2:] = 1.0e4                            # RAW_PAD rows stay finite
    got = _np(tref.batch_l2_ref(_t(q), _t(x)))
    np.testing.assert_allclose(
        got, _np(jref.batch_l2_ref(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-5, atol=1e-4)
    assert np.all(np.isfinite(got)) and got.dtype == np.float32


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("r", [0, 3, 63])
def test_dtw_band_panel_ref_bitwise(gathered, r):
    n, m = 64, 23
    rng = np.random.default_rng(r + 100 * gathered)
    q = np.array(jisax.znorm(jnp.asarray(random_walk(5, n, seed=r + 1))))
    shape = (5, m, n) if gathered else (m, n)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    x[..., 0, :] = 1.0e4                      # a RAW_PAD row
    got = _np(tref.dtw_band_panel_ref(_t(q), _t(x), r=r))
    want = _np(jref.dtw_band_panel_ref(jnp.asarray(q), jnp.asarray(x), r=r))
    assert got.shape == (5, m) and np.array_equal(got, want)


def test_dtw_band_ref_matches_the_dp():
    """The anti-diagonal order against the textbook row-by-row DP."""
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 20)).astype(np.float32)
    for r in (0, 2, 19):
        dp = np.full((21, 21), np.inf)
        dp[0, 0] = 0.0
        for i in range(1, 21):
            for j in range(max(1, i - r), min(20, i + r) + 1):
                dp[i, j] = (float(a[i - 1]) - float(b[j - 1])) ** 2 + min(
                    dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1])
        got = float(tref.dtw_band_ref(_t(a), _t(b), r))
        np.testing.assert_allclose(got, dp[20, 20], rtol=1e-5)


def _refine_inputs(qn, c, seed):
    n, w = 64, 16
    rng = np.random.default_rng(seed)
    block = np.array(jisax.znorm(jnp.asarray(random_walk(c, n, seed=seed))))
    block[c // 2] = block[0]                  # identical rows: a distance tie
    ids = rng.permutation(5 * c)[:c].astype(np.int32)
    ids[-3:] = -1                             # pad lanes
    block[-3:] = 1.0e4                        # RAW_PAD, as the index pads
    _, _, bounds = jisax.summarize(jnp.asarray(block), normalize=False)
    lo = np.ascontiguousarray(np.array(bounds[..., 0]).T)
    hi = np.ascontiguousarray(np.array(bounds[..., 1]).T)
    q = block[rng.integers(0, c - 3, qn)] \
        + 0.3 * rng.standard_normal((qn, n)).astype(np.float32)
    q_paa = np.array(jisax.paa(jnp.asarray(q), w))
    full = np.array(jref.batch_l2_ref(jnp.asarray(q), jnp.asarray(block)))
    thr = np.quantile(full[:, :-3], 0.3, axis=1).astype(np.float32)
    thr[0] = -np.inf                          # inactive query
    if qn > 2:
        thr[2] = 0.0                          # all-dead row
    return q, q_paa, block, lo, hi, ids, thr, n


@pytest.mark.parametrize("qn", QS)
@pytest.mark.parametrize("c", [37, 130])
@pytest.mark.parametrize("k", KS)
def test_fused_panel_topk_ref(qn, c, k):
    args = _refine_inputs(qn, c, seed=qn * 7 + c)
    *arrays, n = args
    gd, gi, gn = tref.fused_panel_topk_ref(*(_t(a) for a in arrays), k=k, n=n)
    wd, wi, wn = jref.fused_panel_topk_ref(*(jnp.asarray(a) for a in arrays),
                                           k=k, n=n)
    assert np.array_equal(_np(gn), _np(wn))
    assert np.array_equal(_np(gi), _np(wi))
    np.testing.assert_allclose(_np(gd), _np(wd), rtol=1e-5, atol=1e-4)
    assert _np(gn)[0] == 0 and np.all(_np(gi)[0] == -1)


@pytest.mark.parametrize("b,s,d,n", [(1, 16, 8, 4), (2, 32, 100, 16),
                                     (1, 64, 128, 8), (2, 24, 10, 1),
                                     (1, 33, 77, 3), (2, 16, 20, 12),
                                     (1, 12, 6, 64)])
def test_ssm_scan_ref(b, s, d, n):
    rng = np.random.default_rng(b * 1000 + s + d + n)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.5
    xc, dt = mk(b, s, d), np.abs(mk(b, s, d)) * 0.2
    bm, cm = mk(b, s, n), mk(b, s, n)
    a = -np.abs(mk(d, n)) - 0.1
    y, h_last = tref.ssm_scan_ref(*(_t(v) for v in (xc, dt, bm, cm, a)))
    want = jref.ssm_scan_ref(*(jnp.asarray(v) for v in (xc, dt, bm, cm, a)))
    np.testing.assert_allclose(_np(y), _np(want), rtol=1e-4, atol=1e-4)
    assert y.dtype == torch.float32 and tuple(h_last.shape) == (b, d, n)
    # a scan split in two, the second half from the first half's state,
    # is the scan of the whole
    half = s // 2
    cut = lambda v, lo, hi: _t(np.ascontiguousarray(v[:, lo:hi]))
    y1, h1 = tref.ssm_scan_ref(*(cut(v, 0, half) for v in (xc, dt, bm, cm)),
                               _t(a))
    y2, h2 = tref.ssm_scan_ref(*(cut(v, half, s) for v in (xc, dt, bm, cm)),
                               _t(a), h1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h_last)
