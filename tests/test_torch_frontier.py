"""repro_torch.core.frontier against repro.core.frontier.

Same candidates, handed over as numpy arrays.  Distances are inserted as
given, so every output must be exactly equal: the (dist, id) order, the
duplicate-id MIN rule, the (INF, -1) empty slots, and the threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.core import frontier as jf
from repro_torch.core import frontier as tf
from _torch_parity import one_intra_op_thread  # noqa: F401


def _pair(qn, k, seed):
    """A jax and a torch frontier holding the same random state."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 8, (qn, 2 * k)).astype(np.float32)
    ids = np.stack([rng.permutation(40)[:2 * k] for _ in range(qn)]
                   ).astype(np.int32)
    ids[:, -1] = -1
    return (jf.insert_batch(jf.init(qn, k), jnp.asarray(d), jnp.asarray(ids)),
            tf.insert_batch(tf.init(qn, k, torch.device("cpu")),
                            torch.from_numpy(d), torch.from_numpy(ids)))


def _equal(got, want):
    assert np.array_equal(got.dists.numpy(), np.array(want.dists))
    assert np.array_equal(got.ids.numpy(), np.array(want.ids))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_insert_batch_with_held_ids_takes_the_min(k):
    jfr, tfr = _pair(4, k, seed=k)
    _equal(tfr, jfr)
    rng = np.random.default_rng(100 + k)
    # re-offer the held ids at other distances, plus fresh ones
    held = np.array(jfr.ids)
    d = np.concatenate([np.array(jfr.dists) + rng.choice([-0.5, 0.5], held.shape),
                        rng.integers(0, 8, held.shape)], 1).astype(np.float32)
    ids = np.concatenate([held, held + 100], 1).astype(np.int32)
    ids[:, k:][held < 0] = -1
    _equal(tf.insert_batch(tfr, torch.from_numpy(d), torch.from_numpy(ids)),
           jf.insert_batch(jfr, jnp.asarray(d), jnp.asarray(ids)))


def test_insert_topk_merge_bound_and_result_dists():
    ja, ta = _pair(3, 5, seed=1)
    jb, tb = _pair(3, 5, seed=2)
    _equal(tf.merge(ta, tb), jf.merge(ja, jb))
    _equal(ta.insert_topk(tb.dists[:, :2], tb.ids[:, :2]),
           ja.insert_topk(jb.dists[:, :2], jb.ids[:, :2]))
    with pytest.raises(ValueError, match="pre-selected"):
        ta.insert_topk(torch.zeros((3, 6)), torch.zeros((3, 6), dtype=torch.int32))
    seed = np.array([1.0, 100.0, 2.5], np.float32)
    assert np.array_equal(tf.bound(ta, torch.from_numpy(seed)).numpy(),
                          np.array(jf.bound(ja, jnp.asarray(seed))))
    assert np.array_equal(tf.result_dists(ta).numpy(),
                          np.array(jf.result_dists(ja)))
    empty = tf.init(2, 4, torch.device("cpu"))
    assert torch.all(empty.ids == -1) and torch.all(empty.threshold() == tf.INF)


@pytest.mark.parametrize("seeded", [False, True])
def test_prepare_matches_reference(seeded):
    """Query prep with and without stage-A seeding from a block index."""
    import repro.core as jcore
    from _torch_parity import carry
    from repro_torch.data import random_walk
    raw = random_walk(300, 64, seed=3)
    qs = raw[:4] + 0.5
    ji = jcore.build(jnp.asarray(raw), capacity=32)
    kw = dict(index=ji) if seeded else dict(w=16)
    want = jf.prepare(jnp.asarray(qs), 5, **kw)
    kw = dict(index=carry(ji)) if seeded else dict(w=16)
    got = tf.prepare(torch.from_numpy(qs), 5, **kw)
    np.testing.assert_allclose(got.q.numpy(), np.array(want.q),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.q_paa.numpy(), np.array(want.q_paa),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(got.frontier.ids.numpy(),
                          np.array(want.frontier.ids))
    np.testing.assert_allclose(got.frontier.dists.numpy(),
                               np.array(want.frontier.dists),
                               rtol=1e-5, atol=1e-4)
    assert (got.block_lb is None) == (want.block_lb is None)
