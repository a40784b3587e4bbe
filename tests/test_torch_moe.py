"""The port's Mixture-of-Experts (``repro_torch.models.moe``) and the two
MoE architectures' ``smoke()`` models against repro's, on the CPU.

``capacity``, ``route``'s expert ids and ``_dispatch_indices`` (drops
included) are compared exactly; ``route``'s weights and aux terms within
1e-6 (fp32 softmax and means over a few hundred terms in another
order); ``moe_ffn_local`` within 1e-5 (expert matmuls and the combine's
adds in another order), its ``dropped_frac`` equal.  The expert-parallel
path runs on 4 gloo ranks (2 data x 2 expert groups) against
``moe_ffn_local`` of each data shard within 2e-3 with nothing dropped,
the bar of tests/test_distributed.py::test_moe_ep_equals_local.  The
whole models follow tests/_torch_lm.py's tolerances; serving is held to
the forward at capacity factor 16, where no assignment drops (capacity
is computed per call, so a forward over B·S tokens and a B-token decode
step drop differently at 1.25), as tests/test_models.py holds it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm as lm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b")
PROMPT, GEN = 32, 8


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ffn_params(rng, e, d=32, f=48):
    return {"router": _rand(rng, d, e, scale=0.3),
            "wg": _rand(rng, e, d, f, scale=d ** -0.5),
            "wu": _rand(rng, e, d, f, scale=d ** -0.5),
            "wd": _rand(rng, e, f, d, scale=f ** -0.5)}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.0, 1.25, 16.0])
def test_capacity_matches_reference(cf):
    for t in (1, 2, 7, 64, 100, 511, 4096, 8192):
        for e in (8, 32, 64):
            for k in (1, 2, 6, 8):
                assert moe.capacity(t, e, k, cf) == jmoe.capacity(t, e, k, cf)


@pytest.mark.parametrize("e,k", [(8, 2), (32, 8), (64, 6)])
def test_route_matches_reference(e, k):
    rng = np.random.default_rng(e + k)
    x, w_r = _rand(rng, 96, 32), _rand(rng, 32, e, scale=0.3)
    w, ids, aux = moe.route(torch.from_numpy(x), torch.from_numpy(w_r), k)
    jw, jids, jaux = jax.jit(lambda a, b: jmoe.route(a, b, k))(
        jnp.asarray(x), jnp.asarray(w_r))
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


def test_route_breaks_ties_by_the_lower_expert():
    """Equal probabilities go to the lower id, as jax.lax.top_k orders
    them."""
    x = np.ones((4, 8), np.float32)
    w_r = np.zeros((8, 6), np.float32)
    w_r[:, 4] = 1.0
    _, ids, _ = moe.route(torch.from_numpy(x), torch.from_numpy(w_r), 3)
    _, jids, _ = jax.jit(lambda a, b: jmoe.route(a, b, 3))(
        jnp.asarray(x), jnp.asarray(w_r))
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [4, 0, 1]


@pytest.mark.parametrize("cap", [8, 16, 24, 64])
def test_dispatch_indices_match_reference(cap):
    rng = np.random.default_rng(cap)
    ids = rng.integers(0, 8, (96, 2))
    ids[:20, 0] = 3                     # one crowded expert
    got = moe._dispatch_indices(torch.from_numpy(ids), 8, cap)
    want = jax.jit(lambda a: jmoe._dispatch_indices(a, 8, cap))(
        jnp.asarray(ids, jnp.int32))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dispatch_everything_kept_with_headroom():
    """The counterpart of tests/test_models.py's."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 8, (64, 2)))
    tok, slot, kept = moe._dispatch_indices(ids, 8, cap=64)
    assert bool(kept.all())
    assert len(torch.unique(slot)) == len(slot)          # kept slots unique


def test_capacity_drops_deterministic():
    """All tokens to expert 0 at capacity 8: the first 8 assignments are
    kept, the rest go to the drop slot."""
    tok, slot, kept = moe._dispatch_indices(
        torch.zeros((32, 1), dtype=torch.int64), 4, cap=8)
    assert int(kept.sum()) == 8
    assert torch.equal(tok[kept], torch.arange(8))
    assert bool((slot[~kept] == 4 * 8).all())


@pytest.mark.parametrize("cf", [0.5, 1.25, 16.0])
def test_moe_ffn_local_matches_reference(cf):
    rng = np.random.default_rng(7)
    p = _ffn_params(rng, 8)
    x = _rand(rng, 80, 32)
    y, aux = moe.moe_ffn_local(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        top_k=2, capacity_factor=cf, act=torch.nn.functional.silu)
    jy, jaux = jmoe.moe_ffn_local(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, top_k=2,
        capacity_factor=cf, act=jax.nn.silu)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert float(aux.dropped_frac) == float(jaux.dropped_frac)
    if cf == 0.5:
        assert float(aux.dropped_frac) > 0
    if cf == 16.0:
        assert float(aux.dropped_frac) == 0
    for got, want in zip(aux[:2], jaux[:2]):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_ffn_reshapes_and_param_specs():
    rng = np.random.default_rng(8)
    p = {k: torch.from_numpy(v) for k, v in _ffn_params(rng, 8).items()}
    x = torch.from_numpy(_rand(rng, 2, 40, 32))
    y, aux = moe.moe_ffn(x, p, top_k=2, capacity_factor=1.25,
                         act=torch.nn.functional.silu)
    y2, aux2 = moe.moe_ffn_local(x.reshape(80, 32), p, top_k=2,
                                 capacity_factor=1.25,
                                 act=torch.nn.functional.silu)
    assert torch.equal(y, y2.reshape(2, 40, 32))
    assert all(torch.equal(a, b) for a, b in zip(aux, aux2))

    class C:
        n_layers, d_model, d_ff, n_experts = 3, 32, 48, 8
    leaf = lambda s: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
    assert common.tree_map(leaf, moe.param_specs(C)) == \
        {k: leaf(v) for k, v in jmoe.param_specs(C).items()}


_EP_RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.models import moe
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4)
dp, mp = divmod(rank, 2)             # 2 data shards x 2 expert groups
model = [dist.new_group([2 * i, 2 * i + 1]) for i in range(2)]
data = [dist.new_group([j, j + 2]) for j in range(2)]
d = np.load(store + ".in.npz")
p = {k: torch.from_numpy(d[k]) for k in ("router", "wg", "wu", "wd")}
el = p["wg"].shape[0] // 2
local = {"router": p["router"],
         **{k: p[k][mp * el:(mp + 1) * el] for k in ("wg", "wu", "wd")}}
x = torch.from_numpy(d["x"][dp * 2:(dp + 1) * 2])
y, aux = moe.moe_ffn(x, local, top_k=2, capacity_factor=8.0,
                     act=torch.nn.functional.silu, group=model[dp],
                     data_group=data[mp])
np.savez(store + f".{rank}.npz", y=y.numpy(),
         aux=np.array([float(a) for a in aux]))
dist.destroy_process_group()
"""


def test_moe_ep_equals_local(tmp_path):
    """The counterpart of tests/test_distributed.py::test_moe_ep_equals_local:
    experts split over ranks, every rank holding its data shard's tokens,
    one all_reduce combine, against each shard's all-local layer."""
    rng = np.random.default_rng(0)
    p = _ffn_params(rng, 8, d=32, f=64)
    x = _rand(rng, 4, 16, 32)
    store = str(tmp_path / "store")
    np.savez(store + ".in.npz", x=x, **p)
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", _EP_RANK, str(r),
                               store], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [proc.communicate(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, lbs, zs = [], [], []
    for dp in range(2):
        y, aux = moe.moe_ffn_local(
            torch.from_numpy(x[dp * 2:(dp + 1) * 2].reshape(-1, 32)), tp,
            top_k=2, capacity_factor=8.0, act=torch.nn.functional.silu)
        want.append(y.numpy().reshape(2, 16, 32))
        lbs.append(float(aux.load_balance))
        zs.append(float(aux.router_z))
    for r in range(4):
        got = np.load(store + f".{r}.npz")
        np.testing.assert_allclose(got["y"], want[r // 2], rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(got["aux"][:2], [np.mean(lbs),
                                                    np.mean(zs)], rtol=1e-6)
        assert got["aux"][2] == 0.0                      # nothing dropped


# ---------------------------------------------------------------------------
# the two MoE architectures' smoke() models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return lm.reference_run(request.param, prompt=PROMPT, gen=GEN)


@pytest.fixture(scope="module")
def stepped(model):
    return lm.port_train_step(model)


def test_forward_matches_reference(model):
    lm.check_forward(model)


def test_prefill_matches_reference(model):
    lm.check_prefill(model)


def test_decode_matches_reference(model):
    lm.check_decode(model)


def test_train_step_metrics_match_reference(model, stepped):
    """Loss, ce, ``moe_lb`` and ``moe_drop`` included."""
    assert stepped["got"][2]["moe_lb"] > 0
    lm.check_train_metrics(model, stepped)


def test_train_step_gradients_and_parameters_match_reference(model,
                                                             stepped):
    lm.check_train_gradients(model, stepped)


def test_serving_is_consistent_with_forward(model):
    lm.check_serving_consistency(model, capacity_factor=16.0)
