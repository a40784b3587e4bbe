"""Mamba and RWKV over the model axis in training, on the CPU: 2 and 4
gloo ranks against one process on the whole leaves.

Mamba by channel (``mamba.mamba_mix(tp=)``): rank r holds its D/M
channels of ``conv``, ``w_dt``, ``dt_bias``, ``w_b``, ``w_c``,
``a_log``, ``d_skip``, its rows of ``w_out`` and its block of ``w_in``'s
fused x|z columns (at M = 4, Hymba ``smoke()``'s blocks lie two in the
x half and two in the z half).  ``B_t`` and ``C_t`` are all-reduced in
the forward and their gradients in the backward.  RWKV's time mix by
head (``rwkv.time_mix(tp=)``: ``w_r``/``w_k``/``w_v``/``w_g`` columns,
``w_o`` rows, ``bonus_u``) and its channel mix by ``ff``
(``rwkv.channel_mix(tp=)``: ``w_ck`` and ``w_cr`` columns, ``w_cv``
rows, a reduce-scatter to the rank's d/M columns and an all-gather of
the gated row); ``mix``, ``decay_base``, ``decay_a``, ``decay_b``,
``ln_x`` and ``mix_c`` are whole on every rank and enter through
``copy_to``.

The cases, each on 2 and 4 ranks, float64 leaves from seed 3: the
mixer (batch 2 and batch 1), the time and channel mix over 12 tokens in
chunks of 8 (a ragged last chunk), the same at batch 1, and with a
state (a prefill whose state and last tokens feed a one-token decode,
both in the loss).  Held: each rank's outputs, states, the gradients of
``x``, of its blocks and of every replicated leaf, within 1e-6 x the
largest magnitude of one process's same tensor.

Whole models, ``transformer.loss_fn(plan=)`` on float64 weights against
one process on the rows of the rank's data coordinate, the loss rtol
1e-6 and every leaf's gradient on every rank within 1e-6 x max(1, its
largest magnitude) of its block of one process's (an FSDP-cut leaf's
summed over the data rows).  The Mamba scan and RWKV's WKV run in
float32 whatever the weights' dtype, as one process's do, so a rank's
other summation order leaves float32's relative noise in a leaf of
large gradients (RWKV's ``bonus_u``: 2.4e-6 at |g| ~ 8) and its
absolute noise in one of small ones (Mamba's ``d_skip``: 2.6e-8 at
|g| ~ 2e-2).  The models: RWKV and
Hymba ``smoke()`` at 1x2 and 1x4, both with per-layer checkpointing
(``remat`` "full", the recompute running the collectives again) and
both FSDP-cut with Adafactor at 2x2, where the replicated leaves come
over the data axis before ``copy_to``.  Every plan gathers nothing over
"model" but Hymba's two gammas.

Against the reference: RWKV and Hymba ``smoke()`` at 1x2 on the
reference's own float32 weights, the loss against the reference's
``loss_fn`` (JAX on the CPU, kernels in ref mode) at rtol 1e-5 and a
Mamba or RWKV gradient within 1e-4 of its max |g|: the bars of
``tests/test_torch_rwkv.py`` and ``tests/test_torch_hymba_train.py``
(``tests/_torch_lm.py``).

The ranks start with ``python -c "import test_torch_recurrent_axis"``,
so the module's top level imports no JAX.
"""
import dataclasses
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import common, mamba, parallel, rwkv  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import make_train_step, opt_init  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

RANK_TIMEOUT = 240
REL = 1e-6                  # of a tensor's largest magnitude
TOL = 1e-6                  # a model's loss (rtol) and leaf gradients
JAX_LOSS_RTOL, JAX_GRAD_OF_MAX = 1e-5, 1e-4
WORLDS = (2, 4)
HYBRID, SSM = "hymba-1.5b", "rwkv6-7b"
SEQ, CHUNK = 12, 8          # one chunk of 8 and a ragged one of 4
# the functions: name -> (arch, batch, with a state)
FN = {"mamba": (HYBRID, 2, False), "mamba-b1": (HYBRID, 1, False),
      "rwkv": (SSM, 2, False), "rwkv-b1": (SSM, 1, False),
      "rwkv-state": (SSM, 2, True)}
MAMBA_LEAVES = tuple(parallel.MAMBA_LOCAL)
RWKV_LEAVES = tuple(parallel.RWKV_TIME_LOCAL) + rwkv.TIME_REPLICATED \
    + tuple(parallel.RWKV_CHANNEL_LOCAL) + ("mix_c",)
BATCH, MODEL_SEQ = 4, 28    # RWKV smoke's 16-token chunks: one ragged
LOSS_RUNS = [(SSM, (1, 2)), (SSM, (1, 4)), (HYBRID, (1, 2)),
             (HYBRID, (1, 4)), (SSM + "+remat", (1, 2)),
             (HYBRID + "+remat", (1, 4)), (SSM + "+fsdp", (2, 2)),
             (HYBRID + "+fsdp", (2, 2))]
REF_RUNS = [(SSM, "ref"), (HYBRID, "ref")]          # at 1x2
REF_GRADS = {SSM: ("layers", "w_cr"), HYBRID: ("layers", "mamba", "w_b")}
# a 2x2 RWKV train step (AdamW) against one process's over the whole
# batch in 2 microbatches
STEP_KW = dict(base_lr=1e-2, total_steps=2, warmup=1)


def _cfg(name: str, ref: bool = False):
    """A ``smoke()`` config; ``+remat`` with per-layer checkpointing,
    ``+fsdp`` the FSDP cut with Adafactor."""
    if ref:
        from repro.configs import get_config as get
    else:
        get = get_config
    base, *tags = name.split("+")
    cfg = get(base, smoke=True)
    if "remat" in tags:
        cfg = dataclasses.replace(cfg, remat="full")
    if "fsdp" in tags:
        cfg = dataclasses.replace(cfg, fsdp=True, optimizer="adafactor")
    return cfg


def _mesh(shape) -> MeshSpec:
    return MeshSpec(tuple(shape), ("data", "model"))


def _run_id(arch, shape) -> str:
    return f"{arch}-{shape[0]}x{shape[1]}"


def _near(got, want, what) -> None:
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()),
                               err_msg=what)


def _leaf_close(got, want, what) -> None:
    """A model's leaf (a gradient or a moment): within 1e-6 x max(1, its
    largest magnitude) of one process's."""
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


# ---------------------------------------------------------------------------
# The functions
# ---------------------------------------------------------------------------


def _prefix(name: str) -> tuple:
    return ("layers", "mamba") if FN[name][0] == HYBRID else ("layers",)


def _leaves(name: str) -> tuple:
    return MAMBA_LEAVES if FN[name][0] == HYBRID else RWKV_LEAVES


def _fn_inputs(name: str) -> dict:
    """Layer 0's leaves of the block (the config's init, float64, plus
    noise from seed 3, so no leaf sits at a constant), inputs and the
    weights of the outputs' sums."""
    arch, b, state = FN[name]
    cfg = get_config(arch, smoke=True)
    g = torch.Generator().manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    whole = dict(common.leaves(serve.build_params(cfg, 0, "cpu")))
    out = {}
    for k in _leaves(name):
        t = whole[_prefix(name) + (k,)][0].double()
        out[k] = (t + 0.1 * rnd(*t.shape)).numpy()
    d = cfg.d_model
    out.update(x=(rnd(b, SEQ, d)).numpy(), c=rnd(b, SEQ, d).numpy(),
               c2=rnd(b, SEQ, d).numpy())
    if state:
        out.update(x2=rnd(b, 1, d).numpy(), c3=rnd(b, 1, d).numpy(),
                   c4=rnd(b, 1, d).numpy())
    return out


def _spec(name: str, leaf: str, m: int) -> tuple:
    """The reference's spec of one layer's leaf (the stacked leaf's, its
    layer dim dropped) on a (1, m) mesh."""
    cfg = get_config(FN[name][0], smoke=True)
    return dict(common.leaves(S.param_pspecs(cfg, _mesh((1, m)))))[
        _prefix(name) + (leaf,)][1:]


def _block(name: str, leaf: str, a: np.ndarray, m: int, r: int):
    return common.shard(torch.from_numpy(a), _spec(name, leaf, m),
                        {"data": 0, "model": r}, {"data": 1, "model": m})


def _run_fn(name: str, d: dict, tp=None) -> dict:
    """The block on the leaves (``tp``: this rank's blocks of them), the
    outputs' weighted sums backward -> outputs, states, gradients."""
    arch, _, with_state = FN[name]
    cfg = get_config(arch, smoke=True)
    m, r = parallel.size(tp), parallel.rank(tp)
    p = {k: (_block(name, k, d[k], m, r) if tp is not None
             else torch.from_numpy(d[k])).clone().requires_grad_(True)
         for k in _leaves(name)}
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    t = lambda k: torch.from_numpy(d[k])
    out = {}
    if arch == HYBRID:
        y, st = mamba.mamba_mix(x, p, d_inner=cfg.q_dim, tp=tp)
        loss = (y * t("c")).sum()
        out.update(out=y, h=st.h, conv=st.conv)
    else:
        hd = cfg.rwkv_head_dim
        att, s_end, x_tm = rwkv.time_mix(x, p, head_dim=hd, chunk=CHUNK,
                                         tp=tp)
        ffn, x_cm = rwkv.channel_mix(x, p, tp=tp)
        loss = (att * t("c")).sum() + (ffn * t("c2")).sum()
        out.update(att=att, ffn=ffn, s=s_end, x_tm=x_tm, x_cm=x_cm)
        if with_state:
            st = rwkv.RwkvState(s=s_end, x_tm=x_tm, x_cm=x_cm)
            x2 = torch.from_numpy(d["x2"])
            att2, s2, _ = rwkv.time_mix(x2, p, head_dim=hd, chunk=CHUNK,
                                        state=st, tp=tp)
            ffn2, _ = rwkv.channel_mix(x2, p, state=st, tp=tp)
            loss = loss + (att2 * t("c3")).sum() + (ffn2 * t("c4")).sum()
            out.update(att2=att2, ffn2=ffn2, s2=s2)
    loss.backward()
    out = {k: v.detach().numpy() for k, v in out.items()}
    out["g_x"] = x.grad.numpy()
    out.update({f"g_{k}": v.grad.numpy() for k, v in p.items()})
    return out


# the outputs that hold the rank's channels (Mamba) or heads (RWKV):
# name -> the dim its rank's block lies along
RANK_BLOCKS = {"h": 1, "conv": 2, "s": 1, "s2": 1}


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _weights(arch: str, ref: bool) -> dict:
    """A model's weights: the reference's own (float32) for a reference
    run, else the port's from seed 0 in float64."""
    if ref:
        import jax
        from repro.models import common as jcommon
        from repro.models import transformer as JT
        from repro_torch import interop
        tree = jax.tree.map(np.asarray, jcommon.build_params(
            JT.param_specs(_cfg(arch, ref=True)), jax.random.PRNGKey(0)))
        params = interop.params_from_arrays(tree, device="cpu")
    else:
        params = common.tree_map(lambda t: t.double(),
                                 serve.build_params(_cfg(arch), 0, "cpu"))
    return {"/".join(p): t.numpy() for p, t in common.leaves(params)}


def _params(arch: str, w: dict, spec=None, coords=None, sizes=None):
    cfg = _cfg(arch)
    cut = (lambda p, t: t) if spec is None else (
        lambda p, t: common.shard(t, spec[p], coords, sizes))
    return common.with_leaves(T.param_specs(cfg), {
        p: cut(p, torch.from_numpy(w["/".join(p)]))
        for p, _ in common.leaves(T.param_specs(cfg))})


def _model_batch(arch: str, f64: bool = True) -> dict:
    batch = launch_train.make_batch_fn(_cfg(arch), BATCH, MODEL_SEQ, 5)(0)
    if f64:
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    return batch


def _rows(batch: dict, d: int, dd: int) -> dict:
    n = BATCH // dd
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _leaf_grads(cfg, params: dict, batch: dict, plan=None):
    """loss_fn(plan=) and the gradient of every leaf."""
    paths, leaves = zip(*common.leaves(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    tree = common.with_leaves(params, dict(zip(paths, live)))
    loss, _ = T.loss_fn(tree, batch, cfg, device="cpu", plan=plan)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {"/".join(p): g.numpy()
                                  for p, g in zip(paths, grads)}


# ---------------------------------------------------------------------------
# One rank (a subprocess): ``python -c`` imports this module and runs it
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    whole = dist.group.WORLD
    out = {}
    for name in FN:
        d = dict(np.load(f"{tmp}/fn_{name}.npz"))
        got = _run_fn(name, d, whole)
        out.update({f"fn/{name}/{k}": v for k, v in got.items()})
    grid = make_mesh((2, 2), ("data", "model"), "cpu") if world == 4 else None
    runs = [(a, s, False) for a, s in LOSS_RUNS]
    runs += [(a, (1, 2), True) for a, _ in REF_RUNS]
    for arch, shape, ref in runs:
        if math.prod(shape) != world:
            continue
        cfg, ms = _cfg(arch), _mesh(shape)
        at = dict(zip(ms.axis_names, divmod(rank, shape[1])))
        mesh_sizes = dict(zip(ms.axis_names, ms.shape))
        pspecs = S.param_pspecs(cfg, ms)
        model, data = ((whole, None) if shape[0] == 1 else
                       (grid.get_group("model"), grid.get_group("data")))
        plan = parallel.Plan(cfg, pspecs, model=model, data=data)
        tag = _run_id(arch, shape) + ("-ref" if ref else "")
        w = dict(np.load(f"{tmp}/w_{arch}{'-ref' if ref else ''}.npz"))
        params = _params(arch, w, dict(common.leaves(pspecs)), at,
                         mesh_sizes)
        b = _rows(_model_batch(arch, not ref), at["data"], shape[0])
        loss, grads = _leaf_grads(cfg, params, b, plan)
        out[f"{tag}/loss"] = np.asarray(loss)
        out.update({f"{tag}/g/{k}": g for k, g in grads.items()})
        out[f"{tag}/gathered"] = np.asarray(
            ["/".join(p) for p in plan.gathered()
             if "model" in plan.axes_of(p)] or [""])
    if world == 4:
        cfg, ms = _cfg(SSM), _mesh((2, 2))
        at = dict(zip(ms.axis_names, divmod(rank, 2)))
        pspecs = S.param_pspecs(cfg, ms)
        plan = parallel.Plan(cfg, pspecs, model=grid.get_group("model"),
                             data=grid.get_group("data"))
        params = _params(SSM, dict(np.load(f"{tmp}/w_{SSM}.npz")),
                         dict(common.leaves(pspecs)), at, {"data": 2,
                                                           "model": 2})
        step = make_train_step(cfg, microbatch=1, plan=plan, device="cpu",
                               **STEP_KW)
        _, opt, mets = step(params, opt_init(cfg.optimizer, params),
                            _rows(_model_batch(SSM), at["data"], 2))
        out.update({f"step/{k}": np.asarray(float(mets[k]))
                    for k in ("loss", "grad_norm")})
        for f in ("m", "v"):
            out.update({f"step/{f}/{'/'.join(p)}": t.numpy()
                        for p, t in common.leaves(getattr(opt, f))})
    np.savez(f"{tmp}/rank{world}.{rank}.npz", **out)
    dist.destroy_process_group()


def _env() -> dict:
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src"),
                                         here])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(world: int, tmp) -> list:
    code = ("import sys, test_torch_recurrent_axis as h; "
            "h._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                              str(tmp)], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"


def _reference(arch: str, w: dict) -> tuple:
    """The reference's loss and REF_GRADS' gradient of ``arch`` on its
    own weights: JAX on the CPU, its kernels in ref mode."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    jcfg = _cfg(arch, ref=True)
    pj = jax.tree.map(jnp.asarray, common.tree_map(
        lambda t: t.numpy(), _params(arch, w)))
    jb = {k: jnp.asarray(v) for k, v in _model_batch(arch, False).items()}
    with jops.kernel_mode("ref"):
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(pj)
    for k in REF_GRADS[arch]:
        g = g[k]
    return float(loss), np.array(g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks at once; meanwhile one process's runs and the
    reference's."""
    tmp = tmp_path_factory.mktemp("recurrent_axis")
    fn = {name: _fn_inputs(name) for name in FN}
    for name in FN:
        np.savez(tmp / f"fn_{name}.npz", **fn[name])
    weights = {a: _weights(a, False) for a, _ in LOSS_RUNS}
    weights.update({a + "-ref": _weights(a, True) for a, _ in REF_RUNS})
    for arch, w in weights.items():
        np.savez(tmp / f"w_{arch}.npz", **w)
    procs = {m: _start(m, tmp) for m in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        waits = [ex.submit(_wait, p) for p in procs.values()]
        one = {("fn", name): _run_fn(name, fn[name]) for name in FN}
        for arch, shape in LOSS_RUNS:
            one[arch, shape] = [
                _leaf_grads(_cfg(arch), _params(arch, weights[arch]),
                            _rows(_model_batch(arch), d, shape[0]))
                for d in range(shape[0])]
        ref = {a: _reference(a, weights[a + "-ref"]) for a, _ in REF_RUNS}
        cfg, params = _cfg(SSM), _params(SSM, weights[SSM])
        step = make_train_step(cfg, microbatch=2, device="cpu", **STEP_KW)
        one["step"] = step(params, opt_init(cfg.optimizer, params),
                           _model_batch(SSM))[1:]
        for f in waits:
            f.result()
    got = {m: [dict(np.load(tmp / f"rank{m}.{r}.npz")) for r in range(m)]
           for m in WORLDS}
    return {"one": one, "ref": ref, "got": got}


# ---------------------------------------------------------------------------
# The functions
# ---------------------------------------------------------------------------

FN_CASES = [(name, m) for name in FN for m in WORLDS]


@pytest.mark.parametrize("name,m", FN_CASES,
                         ids=[f"{n}-{m}" for n, m in FN_CASES])
def test_block_and_gradients_equal_one_process(ranks, name, m):
    want = ranks["one"]["fn", name]
    for r, got in enumerate(ranks["got"][m]):
        g = lambda k: got[f"fn/{name}/{k}"]
        for k, w in want.items():
            if k.startswith("g_") and k != "g_x":     # a leaf: its block
                w = _block(name, k[2:], w, m, r).numpy()
            elif k in RANK_BLOCKS:
                w = np.split(w, m, axis=RANK_BLOCKS[k])[r]
            assert g(k).shape == w.shape, (k, r)
            _near(g(k), w, f"rank {r} {k}")


def test_the_cases_make_the_cuts_they_name():
    """At M = 4 Hymba smoke()'s w_in blocks lie two in the x half and two
    in the z half; every RWKV smoke() case has a ragged last chunk; the
    replicated leaves are whole on every rank, the others cut."""
    cfg = get_config(HYBRID, smoke=True)
    cols = 2 * cfg.q_dim // 4
    assert [r * cols < cfg.q_dim for r in range(4)] == [True, True, False,
                                                        False]
    assert SEQ % CHUNK and FN["mamba-b1"][1] == FN["rwkv-b1"][1] == 1
    assert MODEL_SEQ % get_config(SSM, smoke=True).scan_chunk
    for m in WORLDS:
        for leaf in rwkv.TIME_REPLICATED + ("mix_c",):
            assert "model" not in _spec("rwkv", leaf, m), leaf
        for leaf in tuple(parallel.RWKV_TIME_LOCAL) + tuple(
                parallel.RWKV_CHANNEL_LOCAL):
            assert "model" in _spec("rwkv", leaf, m), leaf
        assert all("model" in _spec("mamba", k, m) for k in MAMBA_LEAVES)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _gathered(got: dict, tag: str) -> list:
    return [p for p in got[f"{tag}/gathered"].tolist() if p]


@pytest.mark.parametrize("arch,shape", LOSS_RUNS,
                         ids=[_run_id(a, s) for a, s in LOSS_RUNS])
def test_sharded_loss_and_gradients_equal_one_process(ranks, arch, shape):
    cfg, ms = _cfg(arch), _mesh(shape)
    sizes = dict(zip(ms.axis_names, ms.shape))
    sp = dict(common.leaves(S.param_pspecs(cfg, ms)))
    whole = ranks["one"][arch, shape]           # one (loss, grads) a row
    tag = _run_id(arch, shape)
    for r, got in enumerate(ranks["got"][ms.size]):
        over = _gathered(got, tag)
        assert over == (["layers/attn_gamma", "layers/mamba_gamma"]
                        if cfg.family == "hybrid" else []), (tag, over)
        coords = dict(zip(ms.axis_names, divmod(r, shape[1])))
        loss, grads = whole[coords["data"]]
        np.testing.assert_allclose(got[f"{tag}/loss"], loss, rtol=TOL,
                                   err_msg=f"rank {r}")
        for path, spec in sp.items():
            key = "/".join(path)
            if any(e is not None and e != "model" for e in spec):
                want = sum(g[key] for _, g in whole)    # FSDP: summed
            else:
                want = grads[key]
            want = common.shard(torch.from_numpy(want), spec, coords,
                                sizes).numpy()
            _leaf_close(got[f"{tag}/g/{key}"], want, f"rank {r} {key}")


@pytest.mark.parametrize("arch", [a for a, _ in REF_RUNS])
def test_sharded_loss_equals_the_reference(ranks, arch):
    loss, g = ranks["ref"][arch]
    ms = _mesh((1, 2))
    spec = dict(common.leaves(S.param_pspecs(_cfg(arch), ms)))[
        REF_GRADS[arch]]
    key = "/".join(REF_GRADS[arch])
    tag = _run_id(arch, (1, 2)) + "-ref"
    top = np.abs(g).max()
    assert "model" in spec
    for r, got in enumerate(ranks["got"][2]):
        np.testing.assert_allclose(got[f"{tag}/loss"], loss,
                                   rtol=JAX_LOSS_RTOL, err_msg=f"rank {r}")
        want = common.shard(torch.from_numpy(g), spec, {"data": 0,
                                                        "model": r},
                            {"data": 1, "model": 2}).numpy()
        np.testing.assert_allclose(got[f"{tag}/g/{key}"], want, rtol=0,
                                   atol=JAX_GRAD_OF_MAX * top,
                                   err_msg=f"rank {r}")


def test_a_2x2_rwkv_train_step_equals_one_process(ranks):
    """One AdamW step of RWKV ``smoke()`` on float64 weights at 2x2
    (``make_train_step(plan=)``, each data rank its 2 rows) against one
    process's step over the 4 rows in 2 microbatches: the loss and the
    gradient norm rtol 1e-6, each rank's blocks of both moments within
    1e-6 x max(1, the leaf's largest magnitude), the gradients' bar
    (``v`` of ``bonus_u``, ~2.6, moves by 1.9e-6 with its gradient's
    float32 noise).  ``tests/test_torch_model_axis.py`` runs RWKV through
    ``launch.train --mesh 2x2`` in float32 and holds its loss and
    gradient norm; its moments are held here, since in float32 the
    WKV's noise alone moves ``bonus_u``'s gradient (|g| ~ 30) by more
    than the absolute 1e-6 that file holds moments to: one process's own
    float32 gradient of it lies 1.1e-4 from its float64 one."""
    opt, mets = ranks["one"]["step"]
    ms = _mesh((2, 2))
    sizes = dict(zip(ms.axis_names, ms.shape))
    sp = dict(common.leaves(S.param_pspecs(_cfg(SSM), ms)))
    for r, got in enumerate(ranks["got"][4]):
        coords = dict(zip(ms.axis_names, divmod(r, 2)))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"step/{k}"], float(mets[k]),
                                       rtol=TOL, err_msg=f"rank {r} {k}")
        for f in ("m", "v"):
            for path, t in common.leaves(getattr(opt, f)):
                want = common.shard(t, sp[path], coords, sizes).numpy()
                _leaf_close(got[f"step/{f}/{'/'.join(path)}"], want,
                            f"rank {r} {f} {path}")
