"""The port's training stack against repro's, on the CPU: the learning
rate, the token stream, the optimizers, one train step of each
architecture the port trains, the checkpointer both ways, and int8
gradient compression over two gloo ranks.  The counterparts of the ten
tests of tests/test_train.py, run on the port alone, are in
tests/test_torch_trainer.py.

Tolerances: ``lr_schedule`` 1e-7 absolute (fp32 rounding of values up
to 1e-3); the token stream bitwise (the same numpy generator);
``opt_update`` 1e-6 (elementwise fp32, reductions of at most 64 terms
in another order); a train step's loss and metrics rtol 1e-5 (fp32
sums over (B, S, V) in another order), its gradients within 1e-4 of
each leaf's max |g| (read from AdamW's first moment, m = 0.1 g after one
step), and its stepped parameters atol 1e-6 where the reference's |g|
is 0 or above 1e-3 of its leaf's max: AdamW's first step is about
lr·sign(g), so a near-zero gradient may flip sign; the elements left out
are counted and bounded at 5% of the parameters.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as J  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import Checkpointer as JCheckpointer  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.step import lr_schedule as jlr_schedule  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.train import (Checkpointer, compression,  # noqa: E402
                               make_eval_step, make_train_step, opt_init)
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.step import lr_schedule  # noqa: E402

TRAINS = ("command-r-35b", "gemma3-27b", "h2o-danube-1.8b",
          "nemotron-4-340b", "pixtral-12b")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flat(tree) -> dict:
    return {p: _np(v) for p, v in common.leaves(tree)}


def _jflat(tree) -> dict:
    """A repro parameter tree as {path: array}, the port's paths."""
    return _flat(jax.tree.map(np.asarray, tree))


def _clone(tree):
    return common.tree_map(torch.clone, tree)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 100, 10_000),
                                                  (1e-3, 10, 100),
                                                  (1e-2, 1, 40)])
def test_lr_schedule_matches_reference(base_lr, warmup, total):
    steps = np.arange(0, total + 20, dtype=np.int32)
    got = lr_schedule(torch.from_numpy(steps), base_lr=base_lr,
                      warmup=warmup, total=total)
    want = jlr_schedule(jnp.asarray(steps), base_lr=base_lr, warmup=warmup,
                        total=total)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-7)


def test_token_stream_is_the_reference_bit_for_bit():
    for kw in (dict(batch=3, seq_len=17, vocab=512, seed=5),
               dict(batch=2, seq_len=64, vocab=32000, seed=0),
               dict(batch=2, seq_len=9, vocab=100, seed=1, structured=False)):
        got = tokens.synthetic_token_batches(**kw)
        want = jtokens.synthetic_token_batches(**kw)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    params = {"w": mk(8, 16), "stack": {"x": mk(3, 5, 7), "b": mk(16)}}
    grads = [{"w": mk(8, 16) * s, "stack": {"x": mk(3, 5, 7) * s,
                                            "b": mk(16) * s}}
             for s in (0.1, 3.0)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_update_matches_reference(kind):
    """Two updates from the initial state on the same gradients: the
    parameters and every state leaf within 1e-6."""
    params, grads = _opt_case(3)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_from_arrays(params, device="cpu")
    js, ts = jopt.opt_init(kind, jp), opt_init(kind, tp)
    for g in grads:
        jp, js = jopt.opt_update(kind, jax.tree.map(jnp.asarray, g), js, jp,
                                 lr=jnp.asarray(1e-2, jnp.float32))
        tp, ts = opt_lib.opt_update(
            kind, interop.params_from_arrays(g, device="cpu"), ts, tp,
            lr=torch.tensor(1e-2))
    for name, j, t in zip(ts._fields, js, ts):
        if name == "step":
            assert int(t) == int(j) == 2
            continue
        want, got = _jflat(j), _flat(t)
        assert want.keys() == got.keys()
        for path in want:
            assert got[path].shape == want[path].shape
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {path}")
    for path, w in _jflat(jp).items():
        np.testing.assert_allclose(_flat(tp)[path], w, rtol=1e-6, atol=1e-6)


def test_opt_update_in_place_equals_functional_and_skips():
    params, grads = _opt_case(4)
    for kind in ("adamw", "adafactor"):
        p0 = interop.params_from_arrays(params, device="cpu")
        g = interop.params_from_arrays(grads[1], device="cpu")
        s0 = opt_init(kind, p0)
        want_p, want_s = opt_lib.opt_update(kind, g, s0, p0, lr=0.01)
        p1, s1 = _clone(p0), opt_init(kind, p0)
        opt_lib.opt_update_(kind, g, s1, p1, lr=0.01,
                            ok=torch.tensor(True))
        for a, b in zip(common.leaves(p1), common.leaves(want_p)):
            assert torch.equal(a[1], b[1])
        assert int(s1.step) == int(want_s.step) == 1
        p2, s2 = _clone(p0), opt_init(kind, p0)
        opt_lib.opt_update_(kind, g, s2, p2, lr=0.01,
                            ok=torch.tensor(False))
        for a, b in zip(common.leaves(p2), common.leaves(p0)):
            assert torch.equal(a[1], b[1])
        assert int(s2.step) == 1


def _train_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=TRAINS)
def stepped(request):
    """One train step (lr 1e-2, no warmup) of an arch's smoke config in
    both packages from the same weights and batch."""
    arch = request.param
    jcfg, cfg = J.get_config(arch, smoke=True), get_config(arch, smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    batch = _train_batch(cfg)
    kw = dict(base_lr=1e-2, warmup=1, total_steps=40, microbatch=1)
    jstep = jax.jit(jmake_train_step(jcfg, **kw))
    jp, js, jm = jstep(pj, jopt.opt_init(jcfg.optimizer, pj),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    first = make_eval_step(cfg, device="cpu")(pt, batch)
    tp, ts, tm = make_train_step(cfg, device="cpu", **kw)(
        pt, opt_init(cfg.optimizer, pt), batch)
    return dict(cfg=cfg, want=(_jflat(jp), _jflat(js.m),
                               {k: float(v) for k, v in jm.items()}),
                got=(_flat(tp), _flat(ts.m),
                     {k: float(v) for k, v in tm.items()}),
                eval=first, step=int(ts.step))


def test_train_step_metrics_match_reference(stepped):
    want, got = stepped["want"][2], stepped["got"][2]
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    assert got["skipped"] == 0 and stepped["step"] == 1
    np.testing.assert_allclose(float(stepped["eval"]["loss"]), got["loss"],
                               rtol=1e-6)


def test_train_step_gradients_and_parameters_match_reference(stepped):
    (wp, wm, _), (gp, gm, _) = stepped["want"], stepped["got"]
    left_out = total = 0
    for path, m in wm.items():
        g_want, g_got = m / 0.1, gm[path] / 0.1
        top = np.abs(g_want).max()
        if top == 0:             # a leaf the config never reads
            assert np.abs(g_got).max() == 0, path
            np.testing.assert_array_equal(gp[path], wp[path])
            continue
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-4 * top,
                                   err_msg=str(path))
        # an exact zero (a row no token reads) steps alike in both
        keep = (np.abs(g_want) > 1e-3 * top) | (g_want == 0)
        np.testing.assert_allclose(gp[path][keep], wp[path][keep], rtol=0,
                                   atol=1e-6, err_msg=str(path))
        left_out += int((~keep).sum())
        total += keep.size
    assert left_out <= 0.05 * total, (left_out, total)


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint of parameters, AdamW state and a step counter written
    by either package restores in the other, leaf for leaf."""
    jcfg = J.get_config("gemma3-27b", smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(2))
    sj = jopt.opt_init("adamw", pj)
    sj = sj._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree.map(lambda a: a * 0.5, sj.m))
    jtree = {"params": pj, "opt": sj, "meta": {"step": 7}}
    JCheckpointer(str(tmp_path / "j"), async_writes=False).save(7, jtree)
    pt = interop.params_from_arrays(jax.tree.map(np.asarray, pj),
                                    device="cpu")
    ttree = {"params": pt, "opt": opt_init("adamw", pt), "meta": {"step": 0}}
    back = Checkpointer(str(tmp_path / "j")).restore(ttree)
    assert back["meta"]["step"] == 7 and int(back["opt"].step) == 7
    assert isinstance(back["opt"], opt_lib.AdamWState)
    for a, b in ((back["params"], pj), (back["opt"].m, sj.m)):
        fa, fb = _flat(a), _jflat(b)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)

    ttree["opt"] = back["opt"]
    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(3, {**ttree, "meta": {"step": 3}})
    ck.wait()
    tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        {"params": pj, "opt": sj})
    tmpl["meta"] = {"step": 0}
    jback = JCheckpointer(str(tmp_path / "t")).restore(tmpl)
    assert jback["meta"]["step"] == 3 and int(jback["opt"].step) == 7
    for a, b in ((jback["params"], pt), (jback["opt"].v, ttree["opt"].v)):
        fa, fb = _jflat(a), _flat(b)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)


_ALLREDUCE = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.train import compression
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
rng = np.random.default_rng(rank)
grads = {"w": torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}
err = compression.init_error_state(grads)
for _ in range(2):
    mean, err = compression.ddp_allreduce_int8(grads, err)
np.savez(store + f".{rank}.npz", w=mean["w"].numpy(), b=mean["b"].numpy(),
         ew=err["w"].numpy(), eb=err["b"].numpy())
dist.destroy_process_group()
"""


def _expected_allreduce(world):
    """The same two exchanges, rank by rank, on one process."""
    grads = []
    for r in range(world):
        rng = np.random.default_rng(r)
        grads.append({"w": torch.from_numpy(
            rng.standard_normal((6, 5)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))})
    errs = [compression.init_error_state(g) for g in grads]
    for _ in range(2):
        parts = [{k: compression.compress_with_feedback(g[k], e[k])
                  for k in g} for g, e in zip(grads, errs)]
        mean = {k: sum(compression.dequant8(p[k][0], p[k][1])
                       for p in parts) / world for k in grads[0]}
        errs = [{k: p[k][2] for k in p} for p in parts]
    return mean, errs


def test_int8_allreduce_on_two_gloo_ranks(tmp_path):
    store = str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", _ALLREDUCE, str(r),
                               store], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    mean, errs = _expected_allreduce(2)
    for r in range(2):
        got = np.load(store + f".{r}.npz")
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], mean[k].numpy(), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(got["e" + k], errs[r][k].numpy())
