"""Helpers shared by the port's parity tests: carry a ``repro`` index
across with ``interop``, compare two SearchResults, build a
``jax.sharding.AbstractMesh`` under either jax's constructor, and the
``one_intra_op_thread`` fixture every port test module imports.

Ids and every SearchStats counter must be equal.  Squared distances agree
to rtol 1e-5 / atol 1e-4: the expanded form cancels two terms of size ~n
(64 or 128), so each carries an absolute error of a few ulps of n.  The
results hold sqrt'd distances, so they are squared back (in float64).
"""
import numpy as np
import pytest
import torch

from repro_torch import interop


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Torch on one intra-op thread for the importing test module.  The
    test run puts several worker processes on the machine's cores; torch's
    default of one thread per core in each oversubscribes them, and its
    many small ops then wait on each other (a smoke() train step of 8 x
    64 tokens took 0.4 s alone on 8 threads, 0.12 s on one, and ~2.3 s
    beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def abstract_mesh(shape: tuple, names: tuple):
    """A ``jax.sharding.AbstractMesh`` of ``shape`` over ``names``: jax
    0.9 takes (sizes, names), jax 0.4.37 one tuple of (name, size)
    pairs."""
    import inspect

    from jax.sharding import AbstractMesh
    params = inspect.signature(AbstractMesh.__init__).parameters
    if "axis_sizes" in params:
        return AbstractMesh(tuple(shape), tuple(names))
    return AbstractMesh(tuple(zip(names, shape)))


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
