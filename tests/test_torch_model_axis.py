"""The port's model axis, on the CPU: ``launch.train --mesh DxM`` with
M > 1 against the reference's specs and against one process.

(a) ``launch.specs.param_pspecs`` and ``opt_specs`` equal the
reference's ``param_pspecs`` and ``opt_state_specs`` entry by entry: the
ten archs at full width on (16, 16) and (2, 16, 16), the ``smoke()``
configs on (2, 2), (1, 4) and (4, 1), and a smoke config made
``fsdp=True, optimizer="adafactor"`` on (2, 2).  (b) ``shard_shapes``'
per-rank parameter and optimizer-state shapes equal what the
reference's specs cut (on an ``AbstractMesh``, no devices).  Exact: these
are specs and shapes.

(c) ``models.parallel``'s collectives on 2 gloo ranks: the gradients of
a column- then row-parallel block (``copy_to`` / ``reduce_from``), of a
leaf gathered over "model" and of one gathered over the data ranks
(FSDP) equal one process's autograd of the same function, 1e-6.

(d) ``launch.train --mesh 2x2 --device cpu`` as a user runs it (it
starts its own 4 gloo ranks), 2 steps of 4 x 32 tokens, a checkpoint
every step: h2o-danube-1.8b (tensor-parallel attention and FFN),
granite-moe-1b-a400m (tensor-parallel attention, experts through
``moe.moe_ffn_ep`` with a gradient), hymba-1.5b (tensor-parallel
attention and FFN, Mamba by channel, gathering only its two gammas over
"model"), whisper-medium (tensor-parallel
encoder, decoder and cross-attention) and rwkv6-7b (time mix by head,
channel mix by ``ff``, nothing gathered) ``smoke()``, and the FSDP +
Adafactor variant of h2o-danube's through the library's rank entry
(``launch.train.rank_main``).  Each rank's parameter and optimizer-state
shapes equal the reference's specs cut.  Each step (RWKV's loss and
gradient norm only, its moments in ``test_torch_recurrent_axis.py``)
equals one process's same step over the whole batch in 2 microbatches
(each data rank's rows: the same per-call token counts, so the same MoE
capacity) from the same state, the weights both build for step 0 and
the mesh's checkpoint of the step before for step 1: the checkpoint's
optimizer state atol 1e-6, the last step's loss and gradient norm
rtol 1e-6, the parameters atol 1e-6 (Adafactor's against one process's, AdamW's against AdamW applied
to the checkpoint's own moments).  AdamW's parameters are not held to
one process's directly, nor is step 1 held to one process's second
step: with eps 1e-8, an element whose gradient lies within a few eps of
0 moves its update by O(1) under the fp32 rounding that any other
summation order gives (one process's own steps in 1 and in 2
microbatches differ so), and the next step's gradients move with those
parameters.

(e) A 2x2 checkpoint resumes in one process (its next step equal to one
process's from that checkpoint, 1e-6), and one process's checkpoint
resumes at 2x2 (held as in (d)).

All runs start together from one module fixture.
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.configs as J  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.train import Checkpointer, make_train_step  # noqa: E402
from repro_torch.train import opt_init  # noqa: E402
from repro_torch.train.step import lr_schedule  # noqa: E402
from _torch_parity import abstract_mesh  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

RANK_TIMEOUT = 300
BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-2
MESH = (2, 2)
DENSE, MOE, HYBRID = "h2o-danube-1.8b", "granite-moe-1b-a400m", "hymba-1.5b"
ENC_DEC, SSM = "whisper-medium", "rwkv6-7b"
FSDP = DENSE + "+fsdp"
CLI_RUNS = (DENSE, MOE, HYBRID, ENC_DEC, SSM)
RUNS = CLI_RUNS + (FSDP,)
# the runs whose checkpoints are held here: RWKV's float32 WKV moves
# bonus_u's gradient (|g| ~ 30) beyond the moments' absolute TOL by its
# noise alone, so test_torch_recurrent_axis.py holds a 2x2 RWKV step's
# moments on float64 weights
CKPT_RUNS = tuple(r for r in RUNS if r != SSM)
# (tensor- or expert-parallel leaves, gathered leaves) at M = 2; the
# vocabulary's leaves (``embed``, ``lm_head`` unless tied) are neither
COUNTS = {DENSE: (7, 0), MOE: (7, 0), HYBRID: (16, 2), ENC_DEC: (18, 0),
          SSM: (9, 0), FSDP: (7, 3)}
TOL = 1e-6


def _cfg(name: str, ref: bool = False):
    get = J.get_config if ref else get_config
    cfg = get(name.removesuffix("+fsdp"), smoke=True)
    if name.endswith("+fsdp"):
        cfg = dataclasses.replace(cfg, fsdp=True, optimizer="adafactor")
    return cfg


def _flat(tree) -> list:
    """Spec or shape leaves in jax's flatten order: dicts by sorted key,
    NamedTuples by field; a tuple that is no NamedTuple is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for f in tree for x in _flat(f)]
    return [tree]


def _ref_flat(tree) -> list:
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _mesh(shape: tuple) -> M.MeshSpec:
    return M.MeshSpec(shape, ("pod", "data", "model")[-len(shape):])


def _ref_specs(jcfg, ms):
    am = abstract_mesh(ms.shape, ms.axis_names)
    data = M.data_axes_of(ms)
    return JS.param_pspecs(jcfg, am, data), \
        JS.opt_specs(jcfg, am, data)[1]


SPEC_CASES = [("full", (16, 16)), ("full", (2, 16, 16)), ("smoke", (2, 2)),
              ("smoke", (1, 4)), ("smoke", (4, 1)), ("fsdp", (2, 2))]


@pytest.mark.parametrize("kind,shape", SPEC_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for k, s in SPEC_CASES])
def test_param_and_opt_specs_equal_the_reference(kind, shape):
    ms = _mesh(shape)
    for arch in list_archs():
        if kind == "full":
            cfg, jcfg = get_config(arch), J.get_config(arch)
        elif kind == "smoke":
            cfg, jcfg = _cfg(arch), _cfg(arch, ref=True)
        else:
            cfg, jcfg = _cfg(arch + "+fsdp"), _cfg(arch + "+fsdp", True)
        jp, jo = _ref_specs(jcfg, ms)
        got_p = _flat(S.param_pspecs(cfg, ms))
        got_o = _flat(S.opt_specs(cfg, ms)[1])
        assert got_p == _ref_flat(jp), (arch, kind, shape)
        assert got_o == _ref_flat(jo), (arch, kind, shape)


def _cut(shape, spec, sizes) -> tuple:
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _ref_cut(jcfg, ms) -> tuple[list, list]:
    """The reference's per-rank parameter and optimizer-state shapes."""
    am = abstract_mesh(ms.shape, ms.axis_names)
    sizes, data = dict(zip(ms.axis_names, ms.shape)), M.data_axes_of(ms)
    p = [_cut(s.shape, sp, sizes) for s, sp in zip(
        jax.tree.leaves(JS.param_shapes(jcfg)),
        _ref_flat(JS.param_pspecs(jcfg, am, data)))]
    o_shapes, o_specs = JS.opt_specs(jcfg, am, data)
    o = [_cut(s.shape, sp, sizes) for s, sp in zip(
        jax.tree.leaves(o_shapes), _ref_flat(o_specs))]
    return p, o


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_shapes_of_params_and_opt_equal_the_reference(multi_pod):
    ms = M.production_mesh(multi_pod=multi_pod)
    for arch in list_archs():
        cfg = get_config(arch)
        st = S.state_shard_shapes(cfg, ms)
        p, o = _ref_cut(J.get_config(arch), ms)
        assert [tuple(s) for s in _flat(st["params"])] == p, arch
        assert [tuple(s) for s in _flat(st["opt"])] == o, arch
        train = S.shard_shapes(cfg, "train_4k", ms)
        assert train["params"] == st["params"] and train["opt"] == st["opt"]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 2, 2)])
def test_shard_blocks_rebuild_the_whole_tensor(shape):
    """``common.shard`` gives each rank of a mesh the block its spec cuts
    (the shape ``shard_shape`` says), and ``common.unshard`` of every
    rank's block gives the whole tensor back, for every leaf of the
    smoke configs and their FSDP variants."""
    ms = _mesh(shape)
    sizes = dict(zip(ms.axis_names, ms.shape))
    gen = torch.Generator().manual_seed(0)
    for arch in list_archs():
        for name in (arch, arch + "+fsdp"):
            cfg = _cfg(name)
            spec_of = dict(common.leaves(S.param_pspecs(cfg, ms)))
            for path, t in common.leaves(S.param_shapes(cfg)):
                whole = torch.randn(tuple(t.shape), generator=gen)
                sp = spec_of[path]
                blocks = []
                for r in range(ms.size):
                    coords = dict(zip(ms.axis_names,
                                      np.unravel_index(r, ms.shape)))
                    blocks.append(common.shard(whole, sp, coords, sizes))
                    assert tuple(blocks[-1].shape) == common.shard_shape(
                        tuple(t.shape), sp, sizes), (name, path)
                back = common.unshard(blocks, sp, ms.shape, ms.axis_names)
                assert torch.equal(back, whole), (name, path, sp)
    # a dim over several axes is cut with the first of them major, as a
    # NamedSharding places it: (pod 1, data 0) holds the third quarter
    x = torch.arange(8.0)
    got = common.shard(x, (("pod", "data"),), {"pod": 1, "data": 0},
                       {"pod": 2, "data": 2})
    assert torch.equal(got, x[4:6])


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs) -> list[str]:
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
        assert p.returncode == 0, f"process {r} failed:\n{log}"
    return logs


def _popen(argv: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _cli_argv(arch: str, ck, steps: int, mesh: str | None) -> list:
    return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
            str(BATCH), "--seq", str(SEQ), "--lr", str(LR), "--ckpt-dir",
            str(ck), "--ckpt-every", "1", "--log-every", "1", "--device",
            "cpu"] + (["--mesh", mesh] if mesh else [])


def _cli(arch: str, ck, steps: int = STEPS, mesh: str | None = "2x2"):
    """``launch.train`` as a user runs it; -> its output."""
    return _wait([_popen(["-m", "repro_torch.launch.train",
                          *_cli_argv(arch, ck, steps, mesh)])])[0]


RANK_ENTRY = r"""
import dataclasses, sys, torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch import train
cfg = dataclasses.replace(get_config({arch!r}, smoke=True), fsdp=True,
                          optimizer="adafactor")
args = train.parse_args({argv!r})
train.rank_main(int(sys.argv[1]), args, {shape!r}, "gloo", {init!r}, cfg=cfg)
"""


def _rank_entry(ck):
    """The FSDP + Adafactor variant: each rank through ``rank_main``."""
    code = RANK_ENTRY.format(
        arch=DENSE, argv=_cli_argv(DENSE, ck, STEPS, "2x2"), shape=MESH,
        init=f"file://{ck}.store")
    return "".join(_wait([_popen(["-c", code, str(r)]) for r in range(4)]))


COLLECTIVES = r"""
import sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.models import parallel as P
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, rank=rank,
                        world_size=2)
g = dist.group.WORLD
d = np.load({inp!r})
leaf = lambda a, dim: torch.from_numpy(d[a]).chunk(2, dim)[rank].clone(
    ).requires_grad_(True)
x = torch.from_numpy(d["x"]).requires_grad_(True)
xs = torch.from_numpy(d["xs"][rank]).requires_grad_(True)
w1, w2, wm, wd = leaf("w1", 1), leaf("w2", 0), leaf("wm", 0), leaf("wd", 1)
c = torch.from_numpy(d["c"])
y = P.reduce_from(torch.tanh(P.copy_to(x, g) @ w1) @ w2, g)
gm = torch.tanh(x @ P.gather_leaf(wm, 0, g, "model"))
fs = torch.tanh(xs @ P.gather_leaf(wd, 1, g, "data"))
((y * c).sum() + (gm * c).sum() + (fs * c).sum()).backward()
np.savez({out!r} + f"{{rank}}.npz", y=y.detach().numpy(),
         **{{k: t.grad.numpy() for k, t in dict(
             x=x, xs=xs, w1=w1, w2=w2, wm=wm, wd=wd).items()}})
dist.destroy_process_group()
"""


def _collectives(tmp):
    rng = np.random.default_rng(5)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = tmp / "coll_in.npz"
    np.savez(inp, x=mk(4, 8), xs=mk(2, 4, 8), w1=mk(8, 6), w2=mk(6, 8),
             wm=mk(8, 8), wd=mk(8, 8), c=mk(4, 8))
    code = COLLECTIVES.format(init=f"file://{tmp}/coll_store", inp=str(inp),
                              out=str(tmp / "coll"))
    _wait([_popen(["-c", code, str(r)]) for r in range(2)])
    return dict(np.load(inp)), [dict(np.load(tmp / f"coll{r}.npz"))
                                for r in range(2)]


def _reports(log: str) -> list[dict]:
    reps = [json.loads(line[len("[rank] "):]) for line in log.splitlines()
            if line.startswith("[rank] ")]
    return sorted(reps, key=lambda r: r["rank"])


def _one_process(name: str, steps=STEPS, microbatch=MESH[0], start=None,
                 skip: int = 0):
    """One process's steps over the whole batch: -> the params and
    optimizer state after each step, and each step's metrics.  ``start``
    (params, state, first step) resumes; the token stream starts at its
    first batch, as a resumed CLI run's does, or ``skip`` batches on."""
    cfg = _cfg(name)
    clone = lambda t: common.tree_map(torch.clone, t)
    if start is None:
        params = serve.build_params(cfg, 0, "cpu")
        opt, first = opt_init(cfg.optimizer, params), 0
    else:                           # the step updates in place: copies
        params, opt, first = start
        params, opt = clone(params), type(opt)(opt.step.clone(),
                                               *map(clone, opt[1:]))
    step = make_train_step(cfg, base_lr=LR, total_steps=steps,
                           warmup=min(100, steps // 10 + 1),
                           microbatch=microbatch, device="cpu")
    nb = launch_train.make_batch_fn(cfg, BATCH, SEQ, 0)
    for _ in range(skip):
        nb(0)
    out = []
    for i in range(first, steps):
        params, opt, m = step(params, opt, nb(i))
        out.append((clone(params), type(opt)(opt.step.clone(),
                                             *map(clone, opt[1:])),
                    {k: float(v) for k, v in m.items()}))
    return out


def _restore(ck, name: str, step: int):
    cfg = _cfg(name)
    params = serve.build_params(cfg, 0, "cpu")
    tree = Checkpointer(str(ck), async_writes=False).restore(
        {"params": params, "opt": opt_init(cfg.optimizer, params),
         "meta": {"step": 0}}, step=step)
    assert tree["meta"]["step"] == step
    return tree["params"], tree["opt"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank run at once; then one process resuming the 2x2
    checkpoint."""
    tmp = tmp_path_factory.mktemp("model_axis")
    # one process's checkpoint after its two steps, for the 2x2 resume
    to_mesh = tmp / "to_mesh"
    p1, o1, _ = _one_process(DENSE, microbatch=1)[-1]
    Checkpointer(str(to_mesh), async_writes=False).save(
        STEPS - 1, {"params": p1, "opt": o1, "meta": {"step": STEPS - 1}})
    with ThreadPoolExecutor(8) as ex:
        cli = {a: ex.submit(_cli, a, tmp / a) for a in CLI_RUNS}
        cli[FSDP] = ex.submit(_rank_entry, tmp / "fsdp")
        coll = ex.submit(_collectives, tmp)
        resumed_mesh = ex.submit(_cli, DENSE, to_mesh, STEPS + 1)
        logs = {a: f.result() for a, f in cli.items()}
        to_one = tmp / "to_one"
        shutil.copytree(tmp / DENSE, to_one)
        resumed_one = ex.submit(_cli, DENSE, to_one, STEPS + 1, None)
        out = dict(tmp=tmp, logs=logs, coll=coll.result(),
                   resumed_mesh=(to_mesh, resumed_mesh.result()),
                   resumed_one=(to_one, resumed_one.result()),
                   ck={a: tmp / a for a in CLI_RUNS})
    out["ck"][FSDP] = tmp / "fsdp"
    return out


# ---------------------------------------------------------------------------
# (c) the collectives
# ---------------------------------------------------------------------------


def _one_process_collectives(d: dict) -> dict:
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d.items()
         if k != "c"}
    c = torch.from_numpy(d["c"])
    y = torch.tanh(t["x"] @ t["w1"]) @ t["w2"]
    loss = (y * c).sum() + (torch.tanh(t["x"] @ t["wm"]) * c).sum() + sum(
        (torch.tanh(t["xs"][r] @ t["wd"]) * c).sum() for r in range(2))
    loss.backward()
    return {"y": y.detach().numpy(),
            **{k: v.grad.numpy() for k, v in t.items()}}


CUTS = {"w1": 1, "w2": 0, "wm": 0, "wd": 1}


@pytest.mark.parametrize("what", [("y", "x", "w1", "w2"), ("wm",),
                                  ("wd", "xs")],
                         ids=["copy_to-reduce_from", "gather_model",
                              "gather_data"])
def test_collectives_gradients_equal_one_process(runs, what):
    d, ranks = runs["coll"]
    want = _one_process_collectives(d)
    for r, got in enumerate(ranks):
        for k in what:
            w = want[k]
            if k in CUTS:
                w = np.split(w, 2, axis=CUTS[k])[r]
            elif k == "xs":
                w = w[r]
            np.testing.assert_allclose(got[k], w, rtol=0, atol=TOL,
                                       err_msg=f"rank {r} {k}")


# ---------------------------------------------------------------------------
# (d) the 2x2 runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RUNS)
def test_mesh_ranks_hold_the_reference_shards(runs, name):
    p, o = _ref_cut(_cfg(name, ref=True), _mesh(MESH))
    reps = _reports(runs["logs"][name])
    assert [r["rank"] for r in reps] == [0, 1, 2, 3]
    for r in reps:
        assert [tuple(s) for s in r["param_shapes"].values()] == p, name
        opt = [tuple(s) for f in r["opt_shapes"].values()
               for s in f.values()]
        assert opt == o[1:], name             # o[0] is the step counter
        assert r["params_held"] == sum(math.prod(s) for s in p)
        assert (r["tp_leaves"], r["gathered_leaves"]) == COUNTS[name]
        assert r["vocab_leaves"] > 0, name
        assert not {"embed", "lm_head"} & set(r["gathered"]), name
        assert not [p for p in r["gathered"]
                    if "/attn/" in p or "/xattn/" in p], name


def _step_from(name, ck, step: int):
    """One process's step ``step`` over the whole batch in 2
    microbatches, from the mesh's checkpoint of the step before (step 0:
    from the weights both build)."""
    if step == 0:
        start = None
    else:
        params, opt = _restore(ck, name, step - 1)
        start = (params, opt, step)
    return _one_process(name, step + 1, MESH[0], start, skip=step)[-1]


@pytest.mark.parametrize("name", RUNS)
def test_mesh_loss_and_grad_norm_equal_one_process(runs, name):
    want = _step_from(name, runs["ck"][name], STEPS - 1)[2]
    for r in _reports(runs["logs"][name]):
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=TOL)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=TOL)
    assert "done." in runs["logs"][name]


def _close(got, want, what):
    for (path, w), (_, g) in zip(common.leaves(want), common.leaves(got)):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL,
                                   msg=f"{what} {path}")


def _adamw_replay(prev: dict, opt, steps: int) -> dict:
    """AdamW's update of ``prev`` by the moments in ``opt`` (the state
    after the step), in ``optimizer._adamw_prep``'s arithmetic."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.01
    t = opt.step.to(torch.float32)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    lr = lr_schedule(opt.step - 1, base_lr=LR, warmup=min(100,
                                                          steps // 10 + 1),
                     total=steps)
    m, v = dict(common.leaves(opt.m)), dict(common.leaves(opt.v))
    out = {}
    for path, p in common.leaves(prev):
        u = (m[path] / bc1) / (torch.sqrt(v[path] / bc2) + eps)
        if p.ndim >= 2:
            u = u + wd * p.to(torch.float32)
        out[path] = (p.to(torch.float32) - lr * u).to(p.dtype)
    return common.with_leaves(prev, out)


def _check_checkpoint(ck, name, step, want_params, want_opt, prev,
                      steps=STEPS):
    """One checkpoint of a mesh run: the optimizer state against one
    process's; the parameters against one process's (Adafactor) or
    against AdamW applied to the checkpoint's moments from ``prev``."""
    params, opt = _restore(ck, name, step)
    assert int(opt.step) == step + 1
    for f in opt._fields[1:]:
        _close(getattr(opt, f), getattr(want_opt, f), f"step {step} {f}")
    if _cfg(name).optimizer == "adamw":
        _close(params, _adamw_replay(prev, opt, steps),
               f"step {step} params (AdamW from its moments)")
    else:
        _close(params, want_params, f"step {step} params")
    return params


@pytest.mark.parametrize("name", CKPT_RUNS)
def test_mesh_checkpoints_equal_one_process(runs, name):
    ck = runs["ck"][name]
    prev = serve.build_params(_cfg(name), 0, "cpu")
    for step in range(STEPS):
        p, o, _ = _step_from(name, ck, step)
        prev = _check_checkpoint(ck, name, step, p, o, prev)


# ---------------------------------------------------------------------------
# (e) checkpoints crossing
# ---------------------------------------------------------------------------


def test_a_2x2_checkpoint_resumes_in_one_process(runs):
    ck, log = runs["resumed_one"]
    assert f"[resume] from step {STEPS - 1}" in log and "done." in log
    params, opt = _restore(ck, DENSE, STEPS - 1)
    (p, o, _), = _one_process(DENSE, STEPS + 1, 1, (params, opt, STEPS))
    got_p, got_o = _restore(ck, DENSE, STEPS)
    _close(got_p, p, "params")
    for f in o._fields[1:]:
        _close(getattr(got_o, f), getattr(o, f), f)


def test_one_process_checkpoint_resumes_at_2x2(runs):
    ck, log = runs["resumed_mesh"]
    assert f"[resume] from step {STEPS - 1}" in log and "done." in log
    params, opt = _restore(ck, DENSE, STEPS - 1)
    (p, o, m), = _one_process(DENSE, STEPS + 1, MESH[0],
                              (params, opt, STEPS))
    _check_checkpoint(ck, DENSE, STEPS, p, o, params, steps=STEPS + 1)
    for r in _reports(log):
        np.testing.assert_allclose(r["loss"], m["loss"], rtol=TOL)
