"""Attention over the model axis whatever its head counts, and Mamba's
``w_in`` in serving, on the CPU: 2 and 4 gloo ranks against one process
on the whole leaves.

Rank r holds columns [r·q/M, (r+1)·q/M) of ``wq``, [r·kv/M, (r+1)·kv/M)
of ``wk`` / ``wv`` and the q rows of ``wo`` that the reference's specs
give it, wherever those cuts fall inside a head ("ragged",
``parallel.ragged``): it projects onto its blocks, gathers the
projections (``parallel.gather_acts``), attends the heads that overlap
its q columns (every head in decode) and multiplies its columns of the
output by its rows of ``wo``.  The cases:

  * q cut inside a head: 25 heads and 5 KV heads (Hymba's counts at a
    small head_dim) and 5 heads and 1 KV head, over 2 and 4;
  * KV cut inside a head, q by whole heads: 4 heads and 1 KV head (MQA)
    over 2 and 4, 4 and 2 over 4 (by whole heads over 2), 8 and 2 over
    4 (nemotron's shape at 16);
  * qk-norm with full and sliding-window attention (gemma3 ``smoke()``);
  * Whisper's non-causal encoder attention, 3 heads;
  * a batch of 1.

Held, with float64 weights (the attention's softmax carries float32
state, as one process's does): each rank's output and K/V, and the
gradients of x, of the q/k norms and of its four blocks, within 1e-6 x
the largest magnitude of one process's same tensor on the whole leaves;
``attn_decode`` with the full-attention positions over "model" at a
position off a rank's slice edge, and on a ring cache that wraps (out
and caches, 1e-6 x max |want|); ``loss_fn(plan=)`` of whole models (a
ragged dense variant at 1x2 and 1x4 and its FSDP-cut form at 2x2,
Whisper's encoder, decoder and cross-attention at 1x2 and 1x4, gemma3
at 1x4): the loss rtol 1e-6 and every leaf's gradient on every rank
within 1e-6 of its block of one process's; ``greedy_generate(plan=)``
of a ragged Hymba (Mamba by channel with its ``w_in`` block) at 2x2,
1x4 and 2x2 batch 1, and of the Whisper variant at 1x4: the tokens
equal and the logits within 1e-6 x max|logit| of one process's; and
the 5-head, 1-KV-head dense variant's loss at 1x2 against the
reference's ``loss_fn`` (JAX on the CPU, kernels in ref mode) on its
own float32 weights, at ``tests/test_torch_train.py``'s bars for the
dense family (loss rtol 1e-5, a gradient within 1e-4 of its max |g|).

Without ranks: the plans of the ten archs at 2x2, 1x4, 16x16 and
2x16x16 gather no attention leaf and no ``w_in``; the
variant's specs equal the reference's entry by entry.
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

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import common, parallel  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

RANK_TIMEOUT = 240
REL = 1e-6                  # of a tensor's largest magnitude
TOL = 1e-6                  # a model's loss (rtol) and leaf gradients (atol)
JAX_LOSS_RTOL, JAX_GRAD_OF_MAX = 1e-5, 1e-4
WORLDS = (2, 4)
SEQ = 12
# attention functions: name -> (config, batch)
FN = {"q25": ("hymba-1.5b+h25", 2), "q5kv1": ("h2o-danube-1.8b+h5", 2),
      "mqa": ("hymba-1.5b+mqa", 2), "kv2": ("h2o-danube-1.8b", 2),
      "q8kv2": ("h2o-danube-1.8b+h8", 2), "qknorm": ("gemma3-27b", 2),
      "enc": ("whisper-medium+h3", 2), "b1": ("hymba-1.5b+h5", 1)}
# one-token decode: name -> (config, kind, cache slots, position); the
# full-attention slots split over "model" (the position in rank 1's half
# at M = 2, rank 2's quarter at 4, off their edges), the ring whole
DECODE = {"full": ("hymba-1.5b+h25", "full", 40, 23),
          "ring": ("gemma3-27b", "swa", 32, 45)}
DENSE = "h2o-danube-1.8b+h5"          # 5 heads, 1 KV head (ragged q and KV)
WHISPER = "whisper-medium+h3"
HYBRID = "hymba-1.5b+h5"
LOSS_RUNS = [(a, (1, m)) for m in WORLDS for a in (DENSE, WHISPER)]
LOSS_RUNS += [("gemma3-27b", (1, 4)), (DENSE + "+fsdp", (2, 2))]
BATCH, MODEL_SEQ = 4, 32
SERVE_RUNS = [(HYBRID, (2, 2), 2), (HYBRID, (1, 4), 2), (HYBRID, (2, 2), 1),
              (WHISPER, (1, 4), 2)]
PROMPT, GEN, FRAMES = 36, 4, 8
REFERENCE = DENSE                     # held to the JAX reference at 1x2


def _cfg(name: str, ref: bool = False):
    """A ``smoke()`` config and its variants: ``+h25`` 25 heads and 5 KV
    heads of 8, ``+h5`` 5 heads and 1 KV head of 16, ``+h8`` 8 heads and
    2 KV heads of 16, ``+h3`` 3 heads and 3 KV heads of 16 (Hymba's
    d_model then its q_dim, as in its full config), ``+mqa`` one KV
    head, ``+fsdp`` the FSDP cut with Adafactor."""
    if ref:
        from repro.configs import get_config as get
    else:
        get = get_config
    base, *tags = name.split("+")
    cfg = get(base, smoke=True)
    heads = {"h25": (25, 5, 8), "h5": (5, 1, 16), "h8": (8, 2, 16),
             "h3": (3, 3, 16)}
    for tag in tags:
        if tag in heads:
            h, kv, hd = heads[tag]
            cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv,
                                      head_dim=hd)
            if cfg.family == "hybrid":      # its mix norms q_dim wide
                cfg = dataclasses.replace(cfg, d_model=h * hd)
        elif tag == "mqa":
            cfg = dataclasses.replace(cfg, n_kv_heads=1)
        elif tag == "fsdp":
            cfg = dataclasses.replace(cfg, fsdp=True, optimizer="adafactor")
    return cfg


def _mesh(shape) -> MeshSpec:
    return MeshSpec(tuple(shape), ("data", "model"))


def _run_id(arch, shape, batch=None) -> str:
    tag = f"{arch}-{shape[0]}x{shape[1]}"
    return tag if batch is None else f"{tag}-b{batch}"


def _near(got, want, what) -> None:
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------

ATTN = ("wq", "wk", "wv", "wo")


def _fn_inputs(name: str) -> dict:
    """One layer's attention leaves (float64, from seed 3; the norms not
    at zero), an input and a weight for the output's sum."""
    cfg, b = _cfg(FN[name][0]), FN[name][1]
    g = torch.Generator().manual_seed(3)
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    rnd = lambda *s: (torch.randn(s, generator=g, dtype=torch.float64)
                      * 0.2).numpy()
    out = {"wq": rnd(d, q), "wk": rnd(d, kv), "wv": rnd(d, kv),
           "wo": rnd(q, d), "x": rnd(b, SEQ, d) * 5, "c": rnd(b, SEQ, d)}
    if cfg.qk_norm:
        out.update(q_gamma=rnd(hd), k_gamma=rnd(hd))
    return out


def _kinds(name: str) -> list:
    """(kind, causal) of each call of a case."""
    if name == "enc":
        return [("full", False)]
    if name == "qknorm":
        return [("full", True), ("swa", True)]
    return [("full", True)]


def _block(a: np.ndarray, leaf: str, cfg, coords: dict, sizes: dict):
    """This rank's block of one layer's attention leaf, cut by the
    reference's spec of its stacked leaf at ``sizes``' mesh."""
    spec = dict(common.leaves(S.param_pspecs(cfg, _mesh(tuple(
        sizes.values())))))[("layers", "attn", leaf)][1:]
    return common.shard(torch.from_numpy(a), spec, coords, sizes)


def _attend(cfg, d: dict, kind: str, causal: bool, tp=None, coords=None,
            sizes=None) -> dict:
    """``attn_train`` on the leaves (``tp``: this rank's blocks of them),
    its output's weighted sum backward -> out, k, v and the gradients."""
    p = {}
    for k in (*ATTN, "q_gamma", "k_gamma"):
        if k not in d:
            continue
        t = (_block(d[k], k, cfg, coords, sizes) if tp is not None
             and k in ATTN else torch.from_numpy(d[k]))
        p[k] = t.clone().requires_grad_(True)
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    out, (k, v) = T.attn_train(x, p, cfg, kind, causal=causal, tp=tp)
    (out * torch.from_numpy(d["c"])).sum().backward()
    return {"out": out.detach().numpy(), "k": k.detach().numpy(),
            "v": v.detach().numpy(), "g_x": x.grad.numpy(),
            **{f"g_{n}": t.grad.numpy() for n, t in p.items()}}


def _decode_inputs(name: str) -> dict:
    cfg, _, slots, _ = DECODE[name]
    cfg = _cfg(cfg)
    g = torch.Generator().manual_seed(4)
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    rnd = lambda *s: (torch.randn(s, generator=g, dtype=torch.float64)
                      * 0.2).numpy()
    out = {"wq": rnd(d, q), "wk": rnd(d, kv), "wv": rnd(d, kv),
           "wo": rnd(q, d), "x": rnd(2, 1, d) * 5,
           "k": rnd(2, slots, cfg.n_kv_heads, hd).astype(np.float32),
           "v": rnd(2, slots, cfg.n_kv_heads, hd).astype(np.float32)}
    if cfg.qk_norm:
        out.update(q_gamma=rnd(hd), k_gamma=rnd(hd))
    return out


@torch.no_grad()
def _decode(name: str, d: dict, tp=None, coords=None, sizes=None) -> dict:
    """``attn_decode`` at the case's position: one process on the whole
    cache, or this rank's blocks: the full-attention slots split over
    ``tp``, a ring cache's KV heads where they divide it -> out and the
    cache after the write."""
    arch, kind, slots, pos = DECODE[name]
    cfg = _cfg(arch)
    p = {k: (_block(d[k], k, cfg, coords, sizes) if tp is not None
             and k in ATTN else torch.from_numpy(d[k]))
         for k in (*ATTN, "q_gamma", "k_gamma") if k in d}
    cache = {k: torch.from_numpy(d[k]).clone() for k in ("k", "v")}
    shard = tp is not None and kind == "full"
    m, r = parallel.size(tp), parallel.rank(tp)
    if shard:                       # the positions over "model"
        cache = {k: t.chunk(m, 1)[r].clone() for k, t in cache.items()}
    elif not parallel.ragged(cfg, m):   # whole heads: the rank's
        cache = {k: t.chunk(m, 2)[r].clone() for k, t in cache.items()}
    posv = torch.full((2,), pos, dtype=torch.int64)
    out, cache = T.attn_decode(torch.from_numpy(d["x"]), p, cfg, kind, cache,
                               posv, kv_shard=tp if shard else None, tp=tp)
    return {"out": out.numpy(), "k": cache["k"].numpy(),
            "v": cache["v"].numpy()}


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _weights(arch: str) -> dict:
    """A model's weights: the reference's own (float32) for REFERENCE's
    JAX run, else the port's from seed 0 in float64."""
    if arch == "ref":
        import jax
        from repro.models import common as jcommon
        from repro.models import transformer as JT
        from repro_torch import interop
        tree = jax.tree.map(np.asarray, jcommon.build_params(
            JT.param_specs(_cfg(REFERENCE, ref=True)),
            jax.random.PRNGKey(0)))
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


def _request(arch: str, batch: int) -> dict:
    cfg = _cfg(arch)
    rng = np.random.default_rng(2)
    req = {"prompt": rng.integers(0, cfg.vocab, (2, PROMPT))[:batch]}
    if cfg.enc_dec:
        req = {"prompt": req["prompt"][:, :6], "frames": (rng.standard_normal(
            (2, FRAMES, cfg.d_model)) * 0.1)[:batch]}
    return req


def _serve(arch: str, w: dict, batch: int, plan=None, spec=None,
           coords=None, sizes=None):
    req = _request(arch, batch)
    g = serve.greedy_generate(_params(arch, w, spec, coords, sizes),
                              _cfg(arch), req["prompt"], GEN,
                              frames=req.get("frames"), plan=plan,
                              device="cpu")
    return g.tokens.numpy(), g.logits.numpy()


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
    sizes = {"data": 1, "model": world}
    coords = {"data": 0, "model": rank}
    out = {}
    for name, (arch, _) in FN.items():
        d = dict(np.load(f"{tmp}/fn_{name}.npz"))
        for kind, causal in _kinds(name):
            got = _attend(_cfg(arch), d, kind, causal, whole, coords, sizes)
            out.update({f"fn/{name}/{kind}/{k}": v for k, v in got.items()})
    for name in DECODE:
        d = dict(np.load(f"{tmp}/dec_{name}.npz"))
        got = _decode(name, d, whole, coords, sizes)
        out.update({f"dec/{name}/{k}": v for k, v in got.items()})
    grid = make_mesh((2, 2), ("data", "model"), "cpu") if world == 4 else None
    groups = lambda shape: ((whole, None) if shape[0] == 1 else
                            (grid.get_group("model"), grid.get_group("data")))
    runs = [(a, s, None) for a, s in LOSS_RUNS] + [("ref", (1, 2), None)]
    runs += SERVE_RUNS
    for arch, shape, batch in runs:
        if math.prod(shape) != world:
            continue
        model_arch = REFERENCE if arch == "ref" else arch
        cfg, ms = _cfg(model_arch), _mesh(shape)
        at = dict(zip(ms.axis_names, divmod(rank, shape[1])))
        mesh_sizes = dict(zip(ms.axis_names, ms.shape))
        pspecs = S.param_pspecs(cfg, ms)
        spec = dict(common.leaves(pspecs))
        model, data = groups(shape)
        w = dict(np.load(f"{tmp}/w_{arch}.npz"))
        plan = parallel.Plan(cfg, pspecs, model=model, data=data, mesh=ms,
                             coords=at)
        tag = _run_id(arch, shape, batch)
        out[f"{tag}/gathered"] = np.asarray(
            ["/".join(p) for p in plan.gathered()] or [""])
        out[f"{tag}/ragged_attn"] = np.asarray(plan.counts()["ragged_attn"])
        if batch is None:
            params = _params(model_arch, w, spec, at, mesh_sizes)
            b = _rows(_model_batch(model_arch, arch != "ref"), at["data"],
                      shape[0])
            loss, grads = _leaf_grads(cfg, params, b, plan)
            out[f"{tag}/loss"] = np.asarray(loss)
            out.update({f"{tag}/g/{k}": g for k, g in grads.items()})
        else:
            toks, logits = _serve(arch, w, batch, plan, spec, at, mesh_sizes)
            out[f"{tag}/tokens"], out[f"{tag}/logits"] = toks, logits
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
    code = ("import sys, test_torch_head_axis as h; "
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


def _reference_loss(w: dict) -> tuple:
    """The reference's loss and ``wq`` gradient of REFERENCE on its own
    weights: JAX on the CPU, its kernels in ref mode."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import common as jcommon
    from repro.models import transformer as JT
    jcfg = _cfg(REFERENCE, ref=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(pj["layers"]["attn"]["wq"]),
                                  w["layers/attn/wq"])
    jb = {k: jnp.asarray(v) for k, v in _model_batch(REFERENCE, False).items()}
    with jops.kernel_mode("ref"):
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(pj)
    return float(loss), np.asarray(g["layers"]["attn"]["wq"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks at once; meanwhile one process's runs and the
    reference's."""
    tmp = tmp_path_factory.mktemp("head_axis")
    fn = {name: _fn_inputs(name) for name in FN}
    dec = {name: _decode_inputs(name) for name in DECODE}
    for name in FN:
        np.savez(tmp / f"fn_{name}.npz", **fn[name])
    for name in DECODE:
        np.savez(tmp / f"dec_{name}.npz", **dec[name])
    archs = {a for a, _ in LOSS_RUNS} | {a for a, _, _ in SERVE_RUNS}
    weights = {a: _weights(a) for a in archs | {"ref"}}
    for arch, w in weights.items():
        np.savez(tmp / f"w_{arch}.npz", **w)
    procs = {m: _start(m, tmp) for m in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        waits = [ex.submit(_wait, p) for p in procs.values()]
        one = {}
        for name, (arch, _) in FN.items():
            for kind, causal in _kinds(name):
                one["fn", name, kind] = _attend(_cfg(arch), fn[name], kind,
                                                causal)
        for name in DECODE:
            one["dec", name] = _decode(name, dec[name])
        for arch, shape in LOSS_RUNS:
            one[arch, shape] = [
                _leaf_grads(_cfg(arch), _params(arch, weights[arch]),
                            _rows(_model_batch(arch), d, shape[0]))
                for d in range(shape[0])]
        for arch, _, batch in SERVE_RUNS:
            one["serve", arch, batch] = _serve(arch, weights[arch], batch)
        ref = _reference_loss(weights["ref"])
        for f in waits:
            f.result()
    got = {m: [dict(np.load(tmp / f"rank{m}.{r}.npz")) for r in range(m)]
           for m in WORLDS}
    return {"one": one, "ref": ref, "got": got}


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------

FN_CASES = [(name, kind, m) for name in FN for kind, _ in _kinds(name)
            for m in WORLDS]


def _cut(a: np.ndarray, dim: int, m: int, r: int) -> np.ndarray:
    return np.split(a, m, axis=dim)[r]


@pytest.mark.parametrize("name,kind,m", FN_CASES,
                         ids=[f"{n}-{k}-{m}" for n, k, m in FN_CASES])
def test_attention_and_gradients_equal_one_process(ranks, name, kind, m):
    cfg = _cfg(FN[name][0])
    want = ranks["one"]["fn", name, kind]
    ragged = parallel.ragged(cfg, m)
    kvh = cfg.n_kv_heads
    for r, got in enumerate(ranks["got"][m]):
        g = lambda k: got[f"fn/{name}/{kind}/{k}"]
        _near(g("out"), want["out"], f"rank {r} out")
        _near(g("g_x"), want["g_x"], f"rank {r} g_x")
        for n, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)):
            _near(g(f"g_{n}"), _cut(want[f"g_{n}"], dim, m, r),
                  f"rank {r} g_{n}")
        for n in ("q_gamma", "k_gamma"):
            if cfg.qk_norm:
                _near(g(f"g_{n}"), want[f"g_{n}"], f"rank {r} g_{n}")
        for n in ("k", "v"):        # the heads the cache holds
            w = want[n] if ragged else _cut(want[n], 2, m, r)
            assert g(n).shape[2] == (kvh if ragged else kvh // m)
            _near(g(n), w, f"rank {r} {n}")


def test_the_cases_cut_where_the_issue_says():
    """Which cut each case makes: q or KV inside a head, at M = 2, 4."""
    inside = lambda n, m: n % m != 0
    for name, m, q_in, kv_in in (("q25", 2, True, True),
                                 ("q25", 4, True, True),
                                 ("q5kv1", 2, True, True),
                                 ("mqa", 2, False, True),
                                 ("kv2", 4, False, True),
                                 ("kv2", 2, False, False),
                                 ("q8kv2", 4, False, True),
                                 ("qknorm", 4, False, True),
                                 ("enc", 2, True, True)):
        cfg = _cfg(FN[name][0])
        assert (inside(cfg.n_heads, m), inside(cfg.n_kv_heads, m)) \
            == (q_in, kv_in), (name, m)
        assert parallel.ragged(cfg, m) == kv_in, (name, m)
    assert FN["b1"][1] == 1


DEC_CASES = [(name, m) for name in DECODE for m in WORLDS]


@pytest.mark.parametrize("name,m", DEC_CASES,
                         ids=[f"{n}-{m}" for n, m in DEC_CASES])
def test_decode_equals_one_process(ranks, name, m):
    arch, kind, slots, pos = DECODE[name]
    want = ranks["one"]["dec", name]
    if kind == "full":              # the write lands in one rank's slice
        assert pos % (slots // m) and pos // (slots // m) == m // 2
    else:                           # the ring wraps
        assert pos >= slots == _cfg(arch).window
    ragged = parallel.ragged(_cfg(arch), m)
    for r, got in enumerate(ranks["got"][m]):
        _near(got[f"dec/{name}/out"], want["out"], f"rank {r} out")
        for k in ("k", "v"):
            w = want[k]
            if kind == "full" or not ragged:
                w = _cut(w, 1 if kind == "full" else 2, m, r)
            _near(got[f"dec/{name}/{k}"], w, f"rank {r} {k}")


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _no_gathered_attention(got: dict, tag: str, serving: bool) -> None:
    gathered = [p for p in got[f"{tag}/gathered"].tolist() if p]
    bad = [p for p in gathered if "/attn/" in p or "/xattn/" in p
           or (serving and p.endswith("/w_in"))]
    assert not bad, (tag, bad)


@pytest.mark.parametrize("arch,shape", LOSS_RUNS,
                         ids=[_run_id(a, s) for a, s in LOSS_RUNS])
def test_sharded_loss_and_gradients_equal_one_process(ranks, arch, shape):
    cfg, ms = _cfg(arch), _mesh(shape)
    sizes = dict(zip(ms.axis_names, ms.shape))
    sp = dict(common.leaves(S.param_pspecs(cfg, ms)))
    whole = ranks["one"][arch, shape]           # one (loss, grads) a row
    tag = _run_id(arch, shape)
    for r, got in enumerate(ranks["got"][ms.size]):
        _no_gathered_attention(got, tag, False)
        assert int(got[f"{tag}/ragged_attn"]) == (
            3 if cfg.enc_dec else 1) * parallel.ragged(cfg, shape[1])
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
            np.testing.assert_allclose(got[f"{tag}/g/{key}"], want, rtol=0,
                                       atol=TOL, err_msg=f"rank {r} {key}")


def test_ragged_loss_equals_the_reference(ranks):
    loss, g_wq = ranks["ref"]
    tag = _run_id("ref", (1, 2))
    top = np.abs(g_wq).max()
    for r, got in enumerate(ranks["got"][2]):
        assert int(got[f"{tag}/ragged_attn"]) == 1
        np.testing.assert_allclose(got[f"{tag}/loss"], loss,
                                   rtol=JAX_LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(
            got[f"{tag}/g/layers/attn/wq"], _cut(g_wq, 2, 2, r), rtol=0,
            atol=JAX_GRAD_OF_MAX * top, err_msg=f"rank {r}")


@pytest.mark.parametrize("arch,shape,batch", SERVE_RUNS,
                         ids=[_run_id(*x) for x in SERVE_RUNS])
def test_ragged_serving_equals_one_process(ranks, arch, shape, batch):
    cfg, ms = _cfg(arch), _mesh(shape)
    toks, logits = ranks["one"]["serve", arch, batch]
    lay = S.serving_specs(cfg, ms, batch, PROMPT + GEN)
    tag = _run_id(arch, shape, batch)
    n = batch // shape[0] if lay["batch"] else batch
    for r, got in enumerate(ranks["got"][ms.size]):
        _no_gathered_attention(got, tag, True)
        d = r // shape[1] if lay["batch"] else 0
        rows = slice(d * n, (d + 1) * n)
        np.testing.assert_array_equal(got[f"{tag}/tokens"], toks[rows],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(
            got[f"{tag}/logits"], logits[rows], rtol=0,
            atol=REL * np.abs(logits).max(), err_msg=f"rank {r}")
    if cfg.family == "hybrid":      # positions over "model", then "data"
        assert lay["kv_shard"] == (("model",) if batch == 2 else ("data",))


# ---------------------------------------------------------------------------
# Plans and specs, without ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def no_fake_group_left():
    """The fake default group the tests below make, destroyed afterwards:
    the next test module in this process may start a real one."""
    yield
    OA.close_fake_groups()


def _plan(cfg, shape):
    ms = MeshSpec(shape, ("pod", "data", "model")[-len(shape):])
    m, nd = shape[-1], math.prod(shape[:-1])
    return parallel.Plan(cfg, S.param_pspecs(cfg, ms),
                         model=OA.fake_group(m, "model"),
                         data=OA.fake_group(nd, "data") if nd > 1 else None)


PLAN_MESHES = [(2, 2), (1, 4), (16, 16), (2, 16, 16)]


@pytest.mark.parametrize("shape", PLAN_MESHES,
                         ids=["x".join(map(str, s)) for s in PLAN_MESHES])
def test_plans_gather_no_attention_and_no_w_in(no_fake_group_left, shape):
    for arch in list_archs():
        cfg = get_config(arch, smoke=shape[-1] < 16)
        plan = _plan(cfg, shape)
        paths = ["/".join(p) for p in plan.gathered()]
        assert not [p for p in paths if "/attn/" in p or "/xattn/" in p
                    or p.endswith("/w_in")], (arch, paths)
        n = {"enc_dec": 3, "ssm": 0}.get(cfg.family, 1)
        assert plan.counts()["ragged_attn"] == n * parallel.ragged(
            cfg, shape[-1]), arch


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (16, 16), (2, 16, 16)],
                         ids=["2x2", "1x4", "16x16", "2x16x16"])
def test_hymba_and_rwkv_gather_over_model(no_fake_group_left, shape):
    """Over "model" a Hymba rank, training or serving, gathers its two
    gammas (a training rank gathered those and the 9 Mamba leaves
    before), and an RWKV rank nothing (``w_cr`` serving and its 9
    tensor-parallel leaves training before): one plan for both."""
    over = lambda plan: sorted("/".join(p) for p in plan.gathered()
                               if "model" in plan.axes_of(p))
    hymba = _plan(get_config("hymba-1.5b"), shape)
    assert over(hymba) == ["layers/attn_gamma", "layers/mamba_gamma"]
    assert hymba.counts()["mamba_leaves"] == 9
    rwkv = _plan(get_config("rwkv6-7b"), shape)
    assert over(rwkv) == [] and rwkv.counts()["rwkv_leaves"] == 9


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_variant_specs_equal_the_reference(shape):
    import jax
    from jax.sharding import PartitionSpec
    from repro.launch import specs as JS
    from _torch_parity import abstract_mesh
    ms = _mesh(shape)
    for arch in (DENSE, DENSE + "+fsdp", HYBRID, WHISPER):
        jcfg = _cfg(arch, ref=True)
        want = JS.param_pspecs(jcfg, abstract_mesh(ms.shape, ms.axis_names),
                               ("data",))
        flat = [tuple(p) for p in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, PartitionSpec))]
        got = dict(common.leaves(S.param_pspecs(_cfg(arch), ms)))
        assert [got[p] for p in sorted(got)] == flat, (arch, shape)
