"""The backward of the port's selective scan, on the CPU: the plain
reverse scan ``ref.ssm_scan_bwd_ref``, ``ops.ssm_scan``'s autograd
``Function`` and the Mamba mixer's gradients against repro's.

Tolerances: ``ssm_scan_bwd_ref`` against ``torch.autograd.grad`` of
``ssm_scan_ref`` in float64, 1e-10 absolute (the same sums in another
order); ``torch.autograd.gradcheck`` at its float64 defaults; the
reverse scan in float32 against ``jax.vjp`` of repro's sequential oracle
1e-5 of each gradient's largest magnitude (float32 sums in another
order); the mixer's gradients against ``jax.grad`` of repro's
``mamba_mix`` 1e-3 of each gradient's largest magnitude, the bar of
tests/test_torch_ssm.py's mixer outputs (the reference runs a chunked
associative scan, the port a sequential one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro_torch import interop
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba
from _torch_parity import one_intra_op_thread  # noqa: F401

NAMES = ("dxc", "ddt", "dbm", "dcm", "da", "dh0")


def _inputs(b, s, d, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh) * 0.5
    arrays = dict(xc=mk(b, s, d), dt=np.abs(mk(b, s, d)) * 0.8,
                  bm=mk(b, s, n), cm=mk(b, s, n),
                  a=-np.abs(mk(d, n)) - 0.1, h0=mk(b, d, n),
                  dy=mk(b, s, d), dh_last=mk(b, d, n))
    return {k: torch.from_numpy(v.astype(dtype)) for k, v in arrays.items()}


def _autograd(t, with_h0, with_dh):
    """torch.autograd.grad of ssm_scan_ref's <y, dy> + <h_last, dh_last>."""
    live = [t[k].clone().requires_grad_(True)
            for k in ("xc", "dt", "bm", "cm", "a")]
    h0 = t["h0"].clone().requires_grad_(True) if with_h0 else None
    y, h_last = ref.ssm_scan_ref(*live, h0)
    loss = torch.sum(y * t["dy"])
    if with_dh:
        loss = loss + torch.sum(h_last * t["dh_last"])
    return torch.autograd.grad(loss, live + ([h0] if with_h0 else []))


@pytest.mark.parametrize("n", [1, 3, 8, 16])
@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_bwd_ref_matches_autograd_of_the_forward(n, with_h0, with_dh):
    """70 steps: two whole spans of 32 and a ragged one."""
    t = _inputs(2, 70, 5, n, seed=n)
    h0 = t["h0"] if with_h0 else None
    _, _, ckpt = ref.ssm_scan_with_checkpoints_ref(
        t["xc"], t["dt"], t["bm"], t["cm"], t["a"], h0)
    assert ckpt.shape == (2, 3, 5, n) and ckpt.dtype == torch.float64
    got = ref.ssm_scan_bwd_ref(t["xc"], t["dt"], t["bm"], t["cm"], t["a"],
                               ckpt, t["dy"],
                               t["dh_last"] if with_dh else None)
    want = _autograd(t, with_h0, with_dh)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10, msg=name)
    if not with_h0:                # dh0 is the gradient of a zero h0
        h0z = torch.zeros_like(t["h0"]).requires_grad_(True)
        y, h_last = ref.ssm_scan_ref(t["xc"], t["dt"], t["bm"], t["cm"],
                                     t["a"], h0z)
        loss = torch.sum(y * t["dy"])
        if with_dh:
            loss = loss + torch.sum(h_last * t["dh_last"])
        (want_dh0,) = torch.autograd.grad(loss, [h0z])
        torch.testing.assert_close(got[5], want_dh0, rtol=0, atol=1e-10)


def test_checkpoints_are_the_states_every_32_steps():
    t = _inputs(1, 65, 3, 4, seed=7)
    y, h_last, ckpt = ref.ssm_scan_with_checkpoints_ref(
        t["xc"], t["dt"], t["bm"], t["cm"], t["a"], t["h0"])
    assert torch.equal(ckpt[:, 0], t["h0"])
    for j, t0 in enumerate((32, 64), start=1):
        _, h = ref.ssm_scan_ref(t["xc"][:, :t0], t["dt"][:, :t0],
                                t["bm"][:, :t0], t["cm"][:, :t0], t["a"],
                                t["h0"])
        assert torch.equal(ckpt[:, j], h)
    y2, h2 = ref.ssm_scan_ref(t["xc"], t["dt"], t["bm"], t["cm"], t["a"],
                              t["h0"])
    assert torch.equal(y, y2) and torch.equal(h_last, h2)


@pytest.mark.parametrize("with_h0", [False, True])
def test_function_gradcheck(with_h0):
    """33 steps: a whole span of 32 and one more."""
    t = _inputs(1, 33, 2, 3, seed=11)
    args = [t[k].clone().requires_grad_(True)
            for k in ("xc", "dt", "bm", "cm", "a")]
    args.append(t["h0"].clone().requires_grad_(True) if with_h0 else None)
    assert torch.autograd.gradcheck(lambda *a: ops.ssm_scan(*a), args)


def test_function_under_autograd_and_without():
    """Under autograd ``ops.ssm_scan`` records the Function; without it
    (serving, decode) the call is the plain forward, with the same
    values; a y left out of the loss gets a zero gradient."""
    t = _inputs(2, 40, 4, 8, seed=3, dtype=np.float32)
    xc = t["xc"].clone().requires_grad_(True)
    args = (xc, t["dt"], t["bm"], t["cm"], t["a"], None)
    y, h_last = ops.ssm_scan(*args)
    assert type(y.grad_fn).__name__ == "_SSMScanBackward"
    with torch.no_grad():
        y0, h0 = ops.ssm_scan(*args)
    assert y0.grad_fn is None
    assert torch.equal(y.detach(), y0) and torch.equal(h_last.detach(), h0)
    (g,) = torch.autograd.grad(torch.sum(h_last * t["dh_last"]), [xc])
    _, _, ckpt = ref.ssm_scan_with_checkpoints_ref(*args)
    want = ref.ssm_scan_bwd_ref(*args[:5], ckpt, torch.zeros_like(xc),
                                t["dh_last"])[0]
    torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_bwd_ref_matches_reference_vjp(n):
    """float32, against jax.vjp of repro's sequential scan oracle (its
    h0 is zero, its A argument the negative A)."""
    t = _inputs(2, 50, 6, n, seed=20 + n, dtype=np.float32)
    ops_in = [t[k] for k in ("xc", "dt", "bm", "cm", "a")]
    _, vjp = jax.vjp(jref.ssm_scan_ref, *(jnp.asarray(v.numpy())
                                          for v in ops_in))
    want = vjp(jnp.asarray(t["dy"].numpy()))
    _, _, ckpt = ref.ssm_scan_with_checkpoints_ref(*ops_in)
    got = ref.ssm_scan_bwd_ref(*ops_in, ckpt, t["dy"])
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


class _Cfg:
    n_layers = 1
    d_model = 32
    ssm_state = 8
    ssm_conv = 4


def test_mamba_mix_gradients_match_reference():
    """The mixer's gradients (input, every parameter) through
    ``ops.ssm_scan``'s backward against jax.grad through repro's chunked
    scan, 40 steps (a span of 32 and a ragged one; the reference in one
    chunk)."""
    d_inner = 48
    pj = jax.tree.map(lambda a: a[0], jcommon.build_params(
        jmamba.param_specs(_Cfg, d_inner), jax.random.PRNGKey(2)))
    rng = np.random.default_rng(9)
    pj["a_log"] = jnp.asarray(rng.uniform(-1, 1, (d_inner, _Cfg.ssm_state))
                              .astype(np.float32))
    x = rng.standard_normal((2, 40, _Cfg.d_model)).astype(np.float32) * 0.5
    w = rng.standard_normal((2, 40, _Cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jmamba.mamba_mix(xx, p, d_inner=d_inner, chunk=40)
        return jnp.sum(out * w)
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj, jnp.asarray(x))

    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    live = {k: v.requires_grad_(True) for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = mamba.mamba_mix(xt, live, d_inner=d_inner)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                [xt] + [live[k] for k in sorted(live)])
    wants = [np.asarray(jg_x)] + [np.asarray(jg_p[k]) for k in sorted(live)]
    for name, g, want in zip(["x"] + sorted(live), grads, wants):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)
