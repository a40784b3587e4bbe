"""repro_torch.core.index.build against repro.core.build, and interop.

Both packages build from the same numpy series.  The permutation, ids and
the region bounds/envelopes must be equal; ``raw`` (the z-normed series)
agrees to rtol 1e-6 / atol 1e-6 because ``znorm`` reduces in another
order.  A symbol may differ between the packages only where the PAA lies
within 1e-5 of a breakpoint; each such flip is checked against that
condition, and none occurs on these inputs, so the arrays must match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro.core import isax as jisax
from repro_torch import interop
from repro_torch.core import index as tindex, isax as tisax
from repro_torch.data import random_walk
from _torch_parity import one_intra_op_thread  # noqa: F401

CASES = {
    "engine_data": (lambda: random_walk(1024, 128, seed=13), 64),
    "tiny_padding": (lambda: random_walk(20, 64, seed=5), 8),
    "ragged_blocks": (lambda: random_walk(300, 64, seed=7), 32),
}


def _flips_near_breakpoints(raw):
    """Symbols of both packages on their own z-norm: every flip must sit
    within 1e-5 of the breakpoint between the two symbols."""
    pj, sj, _ = jisax.summarize(jnp.asarray(raw))
    _, st, _ = tisax.summarize(torch.from_numpy(raw))
    sj, st = np.array(sj), st.numpy()
    flips = sj != st
    bp = jisax.breakpoints(256)[np.minimum(sj, st)[flips]]
    assert np.all(np.abs(np.array(pj)[flips] - bp) < 1e-5)
    return int(flips.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_matches_reference(case):
    make, cap = CASES[case]
    raw = make()
    assert _flips_near_breakpoints(raw) == 0
    ji = jcore.build(jnp.asarray(raw), capacity=cap)
    ti = tindex.build(raw, capacity=cap, device="cpu")
    assert (ti.n, ti.w, ti.card, ti.capacity, ti.n_real) == \
        (ji.n, ji.w, ji.card, ji.capacity, ji.n_real)
    for name in ("ids", "slo", "shi", "elo", "ehi"):
        got, want = getattr(ti, name).numpy(), np.array(getattr(ji, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    np.testing.assert_allclose(ti.raw.numpy(), np.array(ji.raw),
                               rtol=1e-6, atol=1e-6)
    # pad lanes carry RAW_PAD exactly
    pad = ti.ids.numpy() < 0
    assert np.all(ti.raw.numpy()[pad] == tindex.RAW_PAD)


def test_block_layout_and_envelopes():
    for n_series, cap in ((20, 8), (1024, 64), (5, 64)):
        assert tindex.block_layout(n_series, cap) == \
            jcore.index.block_layout(n_series, cap)
    # a real member in the top region keeps its +SENTINEL edge
    rng = np.random.default_rng(1)
    slo = rng.standard_normal((3, 4, 5)).astype(np.float32)
    shi = slo + 1
    shi[0, 0, 0] = jisax.SENTINEL
    ids = np.arange(15, dtype=np.int32).reshape(3, 5)
    ids[1, 3:] = -1
    ids[2, :] = -1
    et = tindex.block_envelopes(*(torch.from_numpy(a) for a in (slo, shi, ids)))
    ej = jcore.index.block_envelopes(*(jnp.asarray(a) for a in (slo, shi, ids)))
    for a, b in zip(et, ej):
        assert np.array_equal(a.numpy(), np.array(b))


def test_interop_round_trip_is_bit_identical():
    raw = random_walk(300, 64, seed=7)
    ji = jcore.build(jnp.asarray(raw), capacity=32)
    arrays = {name: np.array(getattr(ji, name)) for name in interop.ARRAYS}
    ti = interop.block_index_from_arrays(
        arrays, n=ji.n, w=ji.w, card=ji.card, capacity=ji.capacity,
        n_real=ji.n_real, device="cpu")
    back = interop.block_index_to_arrays(ti)
    for name in interop.ARRAYS:
        assert back[name].dtype == arrays[name].dtype
        assert np.array_equal(back[name], arrays[name]), name
    # the port's own index survives the trip too, and owns its memory
    own = tindex.build(raw, capacity=32, device="cpu")
    again = interop.block_index_from_arrays(
        interop.block_index_to_arrays(own), n=own.n, w=own.w, card=own.card,
        capacity=own.capacity, n_real=own.n_real, device="cpu")
    for name in interop.ARRAYS:
        assert torch.equal(getattr(again, name), getattr(own, name))
    arrays["raw"][0, 0, 0] += 1.0
    assert not np.array_equal(arrays["raw"], ti.raw.numpy())
