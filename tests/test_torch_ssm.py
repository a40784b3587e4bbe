"""The port's Mamba mixer and its scan against repro's, on the CPU.

The same numpy inputs and the same parameters (``repro``'s
``build_params``, carried across by ``interop.params_from_arrays``) go
through both packages.  Tolerances: the mixer's output and state rtol /
atol 1e-3, the bar of tests/test_kernels.py's mixer test (the reference
runs the recurrence as a chunked associative scan, the port as one
sequential scan, so the sums differ in order); the plain scan's last
state against the state of the reference's sequential oracle rtol / atol
1e-4, the bar of tests/test_kernels.py's scan test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro_torch import interop
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba

D_MODEL, D_INNER, N_STATE = 32, 48, 8


class _Cfg:
    n_layers = 1
    d_model = D_MODEL
    ssm_state = N_STATE
    ssm_conv = 4


@pytest.fixture(scope="module")
def params():
    pj = jax.tree.map(lambda a: a[0], jcommon.build_params(
        jmamba.param_specs(_Cfg, D_INNER), jax.random.PRNGKey(1)))
    # a non-trivial A = -exp(a_log) per channel and state element
    rng = np.random.default_rng(5)
    pj["a_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, (D_INNER, N_STATE))
                              .astype(np.float32))
    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    return pj, pt


def _state(seed, b=2):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, D_INNER, N_STATE)).astype(np.float32) * 0.3
    conv = rng.standard_normal((b, 3, D_INNER)).astype(np.float32) * 0.3
    return h, conv


def _x(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, D_MODEL)).astype(np.float32) * 0.5


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fn", ["mamba_mix", "mamba_naive"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 24])
def test_mixer_matches_reference(params, fn, with_state, s):
    pj, pt = params
    x = _x(s, s=s)
    st_j = st_t = None
    if with_state:
        h, conv = _state(s)
        st_j = jmamba.MambaState(h=jnp.asarray(h), conv=jnp.asarray(conv))
        st_t = mamba.MambaState(h=torch.from_numpy(h),
                                conv=torch.from_numpy(conv))
    want, wst = jmamba.mamba_naive(jnp.asarray(x), pj, d_inner=D_INNER,
                                   state=st_j)
    got, gst = getattr(mamba, fn)(torch.from_numpy(x), pt, d_inner=D_INNER,
                                  state=st_t)
    _close(got, want, 1e-3)
    _close(gst.h, wst.h, 1e-3)
    _close(gst.conv, wst.conv, 1e-6)


def test_mixer_matches_reference_chunked_scan(params):
    """Against the reference's chunked path too (chunk 8 over S = 24)."""
    pj, pt = params
    x = _x(7)
    want, wst = jmamba.mamba_mix(jnp.asarray(x), pj, d_inner=D_INNER, chunk=8)
    got, gst = mamba.mamba_mix(torch.from_numpy(x), pt, d_inner=D_INNER)
    _close(got, want, 1e-3)
    _close(gst.h, wst.h, 1e-3)


def test_split_run_equals_one_run(params):
    """Prefill then decode: the state carried from one call into the next
    gives the output of one call over the whole sequence."""
    _, pt = params
    x = torch.from_numpy(_x(9, s=20))
    whole, wst = mamba.mamba_mix(x, pt, d_inner=D_INNER)
    first, st = mamba.mamba_mix(x[:, :13], pt, d_inner=D_INNER)
    outs = [first]
    for t in range(13, 20):
        o, st = mamba.mamba_mix(x[:, t:t + 1], pt, d_inner=D_INNER, state=st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(st.h, wst.h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_scan_last_state_matches_naive_state(params, with_state):
    """ref.ssm_scan_ref's h_last is the state of the reference's
    sequential oracle, on the coefficients of one mixer input."""
    pj, pt = params
    x = _x(11)
    h0 = _state(11)[0] if with_state else None
    st_j = None
    if with_state:
        st_j = jmamba.MambaState(h=jnp.asarray(h0),
                                 conv=jnp.zeros((2, 3, D_INNER)))
    _, wst = jmamba.mamba_naive(jnp.asarray(x), pj, d_inner=D_INNER,
                                state=st_j)
    xz = np.array(jnp.einsum("bsd,de->bse", jnp.asarray(x), pj["w_in"]))
    xi = torch.from_numpy(xz[..., :D_INNER])
    xc = torch.nn.functional.silu(mamba._conv_causal(xi, pt["conv"]))
    dt, bt, ct, a = mamba._dt_bc(xc, pt)
    _, h_last = ref.ssm_scan_ref(xc, dt, bt, ct, a,
                                 None if h0 is None else torch.from_numpy(h0))
    _close(h_last, wst.h, 1e-4)


def test_ops_ssm_scan_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    mk = lambda *sh: torch.from_numpy(rng.standard_normal(sh)
                                      .astype(np.float32) * 0.5)
    xc, dt = mk(2, 9, 12), mk(2, 9, 12).abs()
    bm, cm, a, h0 = mk(2, 9, 4), mk(2, 9, 4), -mk(12, 4).abs(), mk(2, 12, 4)
    ops.reset_launch_counts()
    for got, want in zip(ops.ssm_scan(xc, dt, bm, cm, a, h0),
                         ref.ssm_scan_ref(xc, dt, bm, cm, a, h0)):
        assert torch.equal(got, want)
    assert ops.launch_counts()["ssm_scan"] == 0
