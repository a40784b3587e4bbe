"""The port's RWKV6 (``repro_torch.models.rwkv``) and the ``rwkv6-7b``
``smoke()`` model against repro's, on the CPU.

The chunked closed form is held to the sequential oracle
``rwkv_naive_wkv`` at rtol / atol 1e-3 (the bar of
tests/test_models.py::test_rwkv_chunked_equals_naive), at chunks 16 to
128 and at a ragged length, where the port runs whole chunks and one
short last chunk and the reference one chunk of the whole sequence (a
(B, S, S, H, n) tensor, ROADMAP.md Queue 3): both are compared with the
oracle, the port's also with the reference's.  The pieces (token shift,
decays, group norm) and ``time_mix``, ``channel_mix`` and ``rwkv_layer``
with a carried state are held to the reference within 1e-5 at lengths
that are multiples of the chunk.  The whole model follows
tests/_torch_lm.py's tolerances.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

import jax.numpy as jnp  # noqa: E402

import _torch_lm as lm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, rwkv  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

ARCH = "rwkv6-7b"
PROMPT, GEN = 32, 8


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _wkv_inputs(seed, b=2, s=128, h=4, n=16):
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, b, s, h, n, scale=0.5) for _ in range(3))
    logw = -np.exp(_rand(rng, b, s, h, n, scale=0.5))
    return r, k, v, logw, _rand(rng, h, n, scale=0.1), \
        _rand(rng, b, h, n, n, scale=0.05)


def _chunked(args, chunk):
    """The port's chunk loop as ``time_mix`` runs it."""
    r, k, v, logw, u, st = (torch.from_numpy(a) for a in args)
    s, outs = r.shape[1], []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        o, st = rwkv._chunk_wkv(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                                logw[:, lo:hi], u, st)
        outs.append(o)
    return torch.cat(outs, dim=1).numpy(), st.numpy()


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_chunk_wkv_equals_naive(chunk):
    args = _wkv_inputs(chunk)
    got, s_got = _chunked(args, chunk)
    want, s_want = rwkv.rwkv_naive_wkv(*(torch.from_numpy(a) for a in args))
    jwant, js_want = jrwkv.rwkv_naive_wkv(*(jnp.asarray(a) for a in args))
    for g, w in ((got, want.numpy()), (s_got, s_want.numpy()),
                 (want.numpy(), np.asarray(jwant)),
                 (s_want.numpy(), np.asarray(js_want))):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_ragged_length_runs_short_last_chunk():
    """S = 100 at chunk 32: three chunks and one of 4 tokens against the
    oracle and against the reference's one chunk of 100."""
    args = _wkv_inputs(5, s=100)
    got, s_got = _chunked(args, 32)
    want, s_want = rwkv.rwkv_naive_wkv(*(torch.from_numpy(a) for a in args))
    jgot, js_got = jrwkv._chunk_wkv(*(jnp.asarray(a) for a in args))
    for g, w in ((got, want.numpy()), (s_got, s_want.numpy()),
                 (got, np.asarray(jgot)), (s_got, np.asarray(js_got))):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def _layer_params(seed, d=64, f=128, n=16):
    """One layer's parameters: the specs' normal draws, random gammas and
    bonus where the specs start at zero, mixes jittered about 0.5."""
    class C:
        n_layers, d_model, d_ff, rwkv_head_dim = 1, d, f, n
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in rwkv.param_specs(C).items():
        shape = spec.shape[1:]
        if spec.init == "value":
            a = np.full(shape, spec.value, np.float32)
            if name.startswith("mix"):
                a = a + _rand(rng, *shape, scale=0.1)
        elif spec.init == "zeros":
            a = _rand(rng, *shape, scale=0.2)
        else:
            a = _rand(rng, *shape, scale=spec.scale * shape[-2] ** -0.5)
        out[name] = a
    return out


def _state(seed, b=2, d=64, n=16):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, d // n, n, n, scale=0.1), _rand(rng, b, d),
            _rand(rng, b, d))


def test_pieces_match_reference():
    rng = np.random.default_rng(3)
    p = _layer_params(3)
    x, last = _rand(rng, 2, 12, 64), _rand(rng, 2, 64)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pairs = [
        (rwkv._token_shift(torch.from_numpy(x), torch.from_numpy(last)),
         jrwkv._token_shift(jnp.asarray(x), jnp.asarray(last))),
        (rwkv._decays(torch.from_numpy(x), tp),
         jrwkv._decays(jnp.asarray(x), jp)),
        (rwkv._group_norm(torch.from_numpy(x).reshape(2, 12, 4, 16),
                          tp["ln_x"], 16),
         jrwkv._group_norm(jnp.asarray(x).reshape(2, 12, 4, 16),
                           jp["ln_x"], 16)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    big = _rand(rng, 2, 4, 64, scale=30.0)       # the clip to [-12, 6]
    np.testing.assert_allclose(
        rwkv._decays(torch.from_numpy(big), tp).numpy(),
        np.asarray(jrwkv._decays(jnp.asarray(big), jp)), rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (32, 64), (1, 64)])
def test_layer_matches_reference(s, chunk, with_state):
    """``time_mix``, ``channel_mix`` and ``rwkv_layer`` (S = 1 is a decode
    step) from the zero state or a carried one."""
    rng = np.random.default_rng(s + chunk)
    p = _layer_params(s)
    x = _rand(rng, 2, s, 64)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    st = jst = None
    if with_state:
        arrays = _state(s + 1)
        st = rwkv.RwkvState(*(torch.from_numpy(a) for a in arrays))
        jst = jrwkv.RwkvState(*(jnp.asarray(a) for a in arrays))
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    got = rwkv.time_mix(tx, tp, head_dim=16, chunk=chunk, state=st)
    want = jrwkv.time_mix(jx, jp, head_dim=16, chunk=chunk, state=jst)
    got += rwkv.channel_mix(tx, tp, state=st)
    want += jrwkv.channel_mix(jx, jp, state=jst)
    y, new = rwkv.rwkv_layer(tx, tp, head_dim=16, chunk=chunk, state=st)
    jy, jnew = jrwkv.rwkv_layer(jx, jp, head_dim=16, chunk=chunk, state=jst)
    for g, w in zip(got + (y, *new), want + (jy, *jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_param_specs_match_reference():
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH,
                                                               smoke=smoke)
        leaf = lambda s: (tuple(s.shape), tuple(s.axes), s.init, s.scale,
                          s.value)
        assert common.tree_map(leaf, rwkv.param_specs(cfg)) == \
            {k: leaf(v) for k, v in jrwkv.param_specs(jcfg).items()}
        assert all(isinstance(v, jcommon.ParamSpec)
                   for v in jrwkv.param_specs(jcfg).values())


# ---------------------------------------------------------------------------
# rwkv6-7b smoke(): the whole model against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return lm.reference_run(ARCH, prompt=PROMPT, gen=GEN)


@pytest.fixture(scope="module")
def stepped(model):
    return lm.port_train_step(model)


def test_forward_matches_reference(model):
    lm.check_forward(model)


def test_prefill_matches_reference(model):
    """The RWKV states ``s`` (f32), ``x_tm`` and ``x_cm`` included."""
    lm.check_prefill(model)


def test_decode_matches_reference(model):
    lm.check_decode(model)


def test_train_step_metrics_match_reference(model, stepped):
    lm.check_train_metrics(model, stepped)


def test_train_step_gradients_and_parameters_match_reference(model,
                                                             stepped):
    lm.check_train_gradients(model, stepped)


def test_serving_is_consistent_with_forward(model):
    lm.check_serving_consistency(model)


def test_remat_changes_no_value(model):
    """Per-layer checkpointing of the RWKV stack recomputes the same
    values: the train step's metrics and parameters bitwise."""
    cfg = model["cfg"]
    outs = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        m = dict(model, cfg=c)
        outs.append(lm.port_train_step(m))
    assert outs[0]["got"][2] == outs[1]["got"][2]
    for path, a in outs[0]["got"][0].items():
        assert np.array_equal(a, outs[1]["got"][0][path]), path

