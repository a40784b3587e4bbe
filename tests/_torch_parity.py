"""Helpers shared by the port's parity tests: carry a ``repro`` index
across with ``interop`` and compare two SearchResults.

Ids and every SearchStats counter must be equal.  Squared distances agree
to rtol 1e-5 / atol 1e-4: the expanded form cancels two terms of size ~n
(64 or 128), so each carries an absolute error of a few ulps of n.  The
results hold sqrt'd distances, so they are squared back (in float64).
"""
import numpy as np

from repro_torch import interop


def carry(ji):
    """A ``repro`` BlockIndex -> the same arrays as a CPU BlockIndex."""
    arrays = {name: np.array(getattr(ji, name)) for name in interop.ARRAYS}
    return interop.block_index_from_arrays(
        arrays, n=ji.n, w=ji.w, card=ji.card, capacity=ji.capacity,
        n_real=ji.n_real, device="cpu")


def carry_flat(jf):
    """A ``repro`` FlatIndex -> the same arrays as a CPU FlatIndex."""
    arrays = {name: np.array(getattr(jf, name))
              for name in interop.FLAT_ARRAYS}
    return interop.flat_index_from_arrays(arrays, n=jf.n, w=jf.w,
                                          card=jf.card, n_real=jf.n_real,
                                          device="cpu")


def close_sq(got_dist, want_dist):
    g = got_dist.numpy().astype(np.float64)
    w = np.array(want_dist).astype(np.float64)
    np.testing.assert_allclose(g ** 2, w ** 2, rtol=1e-5, atol=1e-4)


def same(got, want):
    """Ids and counters equal, squared distances within tolerance."""
    assert np.array_equal(got.idx.numpy(), np.array(want.idx))
    close_sq(got.dist, want.dist)
    for name, g, w in zip(got.stats._fields, got.stats, want.stats):
        assert np.array_equal(g.numpy(), np.array(w)), name
