"""The vocabulary over the model axis, on the CPU: the vocab-parallel
lookup, head, cross-entropy and greedy pick (``transformer.vocab_embed``,
``vocab_logits``, ``_ce_chunk_vocab``, ``launch.serve.greedy_pick``) on
2 and 4 gloo ranks against one process on the whole leaves.

Each rank holds its block of the vocabulary: rows [r·n, (r+1)·n) of
``embed``, the same columns of ``lm_head``.  The smoke vocabularies of
257 (hymba) and 259 (granite-moe, tied) are padded to 384, so at M = 4
rank 3's 96 columns (288–383) are all padding and rank 2 holds 65 (67)
real and 31 (29) padded ones.  Held:

  * the lookup bitwise (one rank adds a non-zero row an id);
  * lookup + cross-entropy (padded, tied, softcapped; the leaves at
    the config's init): the loss rtol 1e-6, the gradient of the input
    and of each rank's blocks within 1e-6 of one process's
    ``_ce_chunk`` and whole lookup;
  * the greedy pick: ties across ranks, within a rank and over a whole
    row go to the lowest global index, as ``torch.argmax`` picks over
    the whole row, and a padding-only rank never wins;
  * ``loss_fn(plan=)`` of whole ``smoke()`` models at 1x2 and 1x4 (the
    Whisper decoder, a vlm patch prefix, gemma3's tied and scaled
    embedding, Hymba's padded vocabulary behind its meta tokens): the
    loss rtol 1e-6 and every leaf's gradient on every rank within 1e-6
    of that leaf's block of one process's (float64 weights; the
    logits are float32, as the one-process path computes them); and
    the FSDP variant of h2o-danube at 2x2, whose ``embed`` is cut over
    both axes: each data rank's loss against one process's on its rows,
    a leaf cut over the data axes against its block of the two data
    rows' gradients summed (the FSDP reduce-scatter), every other leaf
    against its block of its own rows', and ``make_eval_step(plan=)``
    against one process's loss over the whole batch;
  * the sharded loss of granite-moe ``smoke()`` (padded, tied) at 1x2
    and 1x4 against the reference's ``loss_fn`` (JAX on the CPU, kernels
    in ref mode) on the same weights, at its family test's bars
    (``tests/_torch_lm.py``): the loss rtol 1e-5 and the embedding's
    gradient within 1e-4 of its max |g|.

Without ranks: ``Plan.counts()`` of the ten archs at 2x2, 1x4 and 16x16
reports the vocabulary's leaves and gathers neither; and the dry run's
count at 16x16 (hymba-1.5b decode_32k, nemotron-4-340b's FSDP
decode_32k) against the same count with those leaves gathered as before:
``gathered_leaves`` falls by the vocabulary's leaves and the all-gather
column by exactly their whole bytes (205,619,200 at Hymba).
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import common, parallel  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

RANK_TIMEOUT = 240
TOL = 1e-6
JAX_LOSS_RTOL, JAX_GRAD_OF_MAX = 1e-5, 1e-4
WORLDS = (2, 4)
# the function-level cases: (config, B, S, d of the inputs)
B, SEQ = 2, 24
CASES = {"padded": "hymba-1.5b", "tied": "granite-moe-1b-a400m",
         "softcap": "hymba-1.5b+softcap"}
# loss_fn(plan=) of whole smoke() models: (arch, mesh)
LOSS_RUNS = [(a, (1, m)) for m in WORLDS for a in
             ("whisper-medium", "pixtral-12b", "gemma3-27b", "hymba-1.5b")]
FSDP = "h2o-danube-1.8b+fsdp"
LOSS_RUNS.append((FSDP, (2, 2)))
REFERENCE = "granite-moe-1b-a400m"     # held to the JAX reference
BATCH, MODEL_SEQ = 4, 32


def _cfg(name: str):
    base = name.split("+")[0]
    cfg = get_config(base, smoke=True)
    if name.endswith("+softcap"):
        cfg = dataclasses.replace(cfg, logit_softcap=5.0)
    if name.endswith("+fsdp"):
        cfg = dataclasses.replace(cfg, fsdp=True, optimizer="adafactor")
    return cfg


def _mesh(shape) -> MeshSpec:
    return MeshSpec(tuple(shape), ("data", "model"))


def _run_id(arch, shape) -> str:
    return f"{arch}-{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# The inputs, and what one process computes on the whole leaves
# ---------------------------------------------------------------------------


def _case_inputs(name: str) -> dict:
    """Whole embedding and head (the config's init, from seed 7), an
    input, tokens and labels (some at the blocks' edges, the last real
    id, and masked), a weight for the lookup's term, and logits rows for
    the greedy pick."""
    cfg = _cfg(CASES[name])
    init = serve.build_params(cfg, 7, "cpu")
    vp, v, d = cfg.vocab_padded, cfg.vocab, cfg.d_model
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    tokens = rng.integers(0, v, (B, SEQ))
    edges = [0, vp // 4 - 1, vp // 4, vp // 2 - 1, vp // 2, v - 1]
    tokens[0, :len(edges)] = edges
    labels = rng.integers(0, v, (B, SEQ))
    labels[1, :len(edges)] = edges
    labels[:, -1] = -1
    labels[0, 3] = -1
    out = {"embed": init["embed"].numpy(),
           "lm_head": init.get("lm_head", torch.zeros(d, vp)).numpy(),
           "x": f32(B, SEQ, d), "tokens": tokens, "labels": labels,
           "c": f32(B, SEQ, d)}
    for m in WORLDS:
        out[f"pick{m}"] = _pick_rows(cfg, m, rng)
    return out


def _pick_rows(cfg, m: int, rng) -> np.ndarray:
    """Logits (5, Vp) for the greedy pick: random; a tie across two
    ranks' edge columns; a tie on three ranks' columns; the max on the
    last real column, next to the padding; every real column equal."""
    vp, v, n = cfg.vocab_padded, cfg.vocab, cfg.vocab_padded // m
    w = rng.standard_normal((5, vp)).astype(np.float32)
    w[1, [n - 1, n]] = 9.0
    w[2, [min(v - 1, (m - 1) * n + 1), n + 2, 5]] = 9.0
    w[3, v - 1] = 9.0
    w[4] = 0.25
    return w


def _case_loss(cfg, e, h, x, tokens, labels, c, group=None):
    """Lookup, then the cross-entropy of one chunk, plus a weighted sum
    of the looked-up rows: over the vocabulary's blocks on ``group``, or
    (None) by one process on the whole leaves."""
    if group is None:
        emb = e[tokens]
        head = e.T if cfg.tie_embeddings else h
        ce = T._ce_chunk(x + 0.5 * emb, labels, head,
                         T._pad_mask(cfg, 0, cfg.vocab_padded, x.device),
                         cfg.logit_softcap)
    else:
        emb = T.vocab_embed(e, tokens, group)
        head = e.T if cfg.tie_embeddings else h
        ce = T._ce_chunk_vocab(x + 0.5 * emb, labels, head, cfg, group)
    return ce + torch.sum(emb * c), emb


def _grad(t: torch.Tensor) -> np.ndarray:
    """``t``'s gradient (zeros where nothing read it: a tied model's
    ``lm_head``)."""
    return np.zeros(tuple(t.shape), np.float32) if t.grad is None \
        else t.grad.numpy()


def _one_process_case(name: str, d: dict) -> dict:
    cfg = _cfg(CASES[name])
    t = {k: torch.from_numpy(d[k]).requires_grad_(True)
         for k in ("embed", "lm_head", "x")}
    loss, emb = _case_loss(cfg, t["embed"], t["lm_head"], t["x"],
                           torch.from_numpy(d["tokens"]),
                           torch.from_numpy(d["labels"]),
                           torch.from_numpy(d["c"]))
    loss.backward()
    return {"loss": loss.detach().numpy(), "emb": emb.detach().numpy(),
            **{f"g_{k}": _grad(v) for k, v in t.items()}}


def _model_batch(arch: str) -> dict:
    """A batch of BATCH rows: frames and patches in the weights' dtype."""
    batch = launch_train.make_batch_fn(_cfg(arch), BATCH, MODEL_SEQ, 3)(0)
    if arch != REFERENCE:
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    return batch


def _leaf_grads(cfg, params: dict, batch: dict, plan=None):
    """loss_fn(plan=) and the gradient of every leaf."""
    paths, leaves = zip(*common.leaves(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    tree = common.with_leaves(params, dict(zip(paths, live)))
    loss, _ = T.loss_fn(tree, batch, cfg, device="cpu", plan=plan)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return float(loss), {"/".join(p): g.numpy() for p, g in zip(paths,
                                                                grads)}


def _weights(arch: str) -> dict:
    """The weights of a run: the reference's own for REFERENCE (carried
    by ``interop``), else the port's from seed 0 in float64."""
    cfg = _cfg(arch)
    if arch == REFERENCE:
        import jax
        from repro.configs import get_config as jget_config
        from repro.models import common as jcommon
        from repro.models import transformer as JT
        from repro_torch import interop
        tree = jax.tree.map(np.asarray, jcommon.build_params(
            JT.param_specs(jget_config(arch, smoke=True)),
            jax.random.PRNGKey(0)))
        params = interop.params_from_arrays(tree, device="cpu")
    else:
        params = common.tree_map(lambda t: t.double(),
                                 serve.build_params(cfg, 0, "cpu"))
    return {"/".join(p): t.numpy() for p, t in common.leaves(params)}


def _params(arch: str, w: dict) -> dict:
    return common.with_leaves(T.param_specs(_cfg(arch)), {
        p: torch.from_numpy(w["/".join(p)])
        for p, _ in common.leaves(T.param_specs(_cfg(arch)))})


def _rows(batch: dict, d: int, dd: int) -> dict:
    n = BATCH // dd
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# One rank (a subprocess): ``python -c`` imports this module and runs it
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str) -> None:
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import make_eval_step
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    whole = dist.group.WORLD
    out = {}
    for name in CASES:
        cfg = _cfg(CASES[name])
        d = np.load(f"{tmp}/{name}.npz")
        n = cfg.vocab_padded // world
        blk = lambda a, dim: torch.from_numpy(a).narrow(
            dim, rank * n, n).clone().requires_grad_(True)
        e, h = blk(d["embed"], 0), blk(d["lm_head"], 1)
        x = torch.from_numpy(d["x"]).requires_grad_(True)
        loss, emb = _case_loss(cfg, e, h, x, torch.from_numpy(d["tokens"]),
                               torch.from_numpy(d["labels"]),
                               torch.from_numpy(d["c"]), whole)
        loss.backward()
        pick = d[f"pick{world}"][:, rank * n:(rank + 1) * n]
        block = torch.from_numpy(pick) + T._pad_mask(cfg, rank * n, n, "cpu")
        out.update({f"{name}/loss": loss.detach().numpy(),
                    f"{name}/emb": emb.detach().numpy(),
                    f"{name}/g_embed": _grad(e),
                    f"{name}/g_lm_head": _grad(h),
                    f"{name}/g_x": _grad(x),
                    f"{name}/pick": serve.greedy_pick(block, whole).numpy()})
    grid = make_mesh((2, 2), ("data", "model"), "cpu") if world == 4 else None
    for arch, shape in LOSS_RUNS + [(REFERENCE, (1, world))]:
        if shape[0] * shape[1] != world:
            continue
        cfg = _cfg(arch)
        ms = _mesh(shape)
        coords = dict(zip(ms.axis_names, divmod(rank, shape[1])))
        sizes = dict(zip(ms.axis_names, ms.shape))
        if shape[0] == 1:
            model, data = whole, None
        else:
            model, data = grid.get_group("model"), grid.get_group("data")
        pspecs = S.param_pspecs(cfg, ms)
        sp = dict(common.leaves(pspecs))
        w = np.load(f"{tmp}/{arch}.npz")
        params = common.with_leaves(T.param_specs(cfg), {
            p: common.shard(torch.from_numpy(w["/".join(p)]), sp[p], coords,
                            sizes)
            for p, _ in common.leaves(T.param_specs(cfg))})
        plan = parallel.Plan(cfg, pspecs, model=model, data=data)
        batch = _rows(_model_batch(arch), coords["data"], shape[0])
        loss, grads = _leaf_grads(cfg, params, batch, plan)
        tag = _run_id(arch, shape)
        out[f"{tag}/loss"] = np.asarray(loss)
        out.update({f"{tag}/g/{k}": g for k, g in grads.items()})
        if shape[0] > 1:
            out[f"{tag}/eval"] = np.asarray(float(make_eval_step(
                cfg, plan=plan, device="cpu")(params, batch)["loss"]))
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
    code = ("import sys, test_torch_vocab_axis as v; "
            "v._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
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


def _reference_loss(w: dict, batch: dict) -> tuple:
    """The reference's loss and embedding gradient on REFERENCE's
    weights: JAX on the CPU, its kernels in ref mode."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.kernels import ops as jops
    from repro.models import common as jcommon
    from repro.models import transformer as JT
    jcfg = jget_config(REFERENCE, smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(pj["embed"]), w["embed"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jops.kernel_mode("ref"):
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(pj)
    return float(loss), np.asarray(g["embed"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' ranks at once; meanwhile one process's runs and the
    reference's."""
    tmp = tmp_path_factory.mktemp("vocab_axis")
    cases = {name: _case_inputs(name) for name in CASES}
    for name, d in cases.items():
        np.savez(tmp / f"{name}.npz", **d)
    weights = {a: _weights(a) for a in {a for a, _ in LOSS_RUNS}
               | {REFERENCE}}
    for arch, w in weights.items():
        np.savez(tmp / f"{arch}.npz", **w)
    procs = {m: _start(m, tmp) for m in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        waits = [ex.submit(_wait, p) for p in procs.values()]
        one = {name: _one_process_case(name, d) for name, d in cases.items()}
        whole = {}
        for arch, shape in LOSS_RUNS:
            cfg, batch = _cfg(arch), _model_batch(arch)
            whole[arch, shape] = [
                _leaf_grads(cfg, _params(arch, weights[arch]),
                            _rows(batch, d, shape[0]))
                for d in range(shape[0])]
        ref = _reference_loss(weights[REFERENCE], _model_batch(REFERENCE))
        for f in waits:
            f.result()
    got = {m: [dict(np.load(tmp / f"rank{m}.{r}.npz")) for r in range(m)]
           for m in WORLDS}
    return {"cases": cases, "one": one, "whole": whole, "ref": ref,
            "got": got, "weights": weights}


# ---------------------------------------------------------------------------
# The functions
# ---------------------------------------------------------------------------

FN_CASES = [(name, m) for name in CASES for m in WORLDS]
FN_IDS = [f"{name}-{m}" for name, m in FN_CASES]


@pytest.mark.parametrize("name,m", FN_CASES, ids=FN_IDS)
def test_lookup_is_bitwise_the_whole_lookup(ranks, name, m):
    want = ranks["one"][name]["emb"]
    d = ranks["cases"][name]
    np.testing.assert_array_equal(want, d["embed"][d["tokens"]])
    for r, got in enumerate(ranks["got"][m]):
        np.testing.assert_array_equal(got[f"{name}/emb"], want,
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("name,m", FN_CASES, ids=FN_IDS)
def test_cross_entropy_and_gradients_equal_one_process(ranks, name, m):
    cfg, one = _cfg(CASES[name]), ranks["one"][name]
    n = cfg.vocab_padded // m
    # a tied model's head is its embedding: lm_head gets no gradient
    assert cfg.tie_embeddings == (not one["g_lm_head"].any())
    cuts = {"x": (slice(None),), "embed": (slice(None),),
            "lm_head": (slice(None), slice(None))}
    for r, got in enumerate(ranks["got"][m]):
        np.testing.assert_allclose(got[f"{name}/loss"], one["loss"],
                                   rtol=TOL, err_msg=f"rank {r}")
        cuts["embed"] = (slice(r * n, (r + 1) * n),)
        cuts["lm_head"] = (slice(None), slice(r * n, (r + 1) * n))
        for k, cut in cuts.items():
            want = one[f"g_{k}"]
            np.testing.assert_allclose(
                got[f"{name}/g_{k}"], want[cut], rtol=0,
                atol=TOL, err_msg=f"rank {r} {k}")


def test_padding_only_rank_exists_at_four():
    """The case the tests must hold: at M = 4 the last rank's block of
    the padded smoke vocabularies is all padding."""
    for name in ("padded", "tied"):
        cfg = _cfg(CASES[name])
        n = cfg.vocab_padded // 4
        assert 3 * n >= cfg.vocab > 2 * n, name
        mask = T._pad_mask(cfg, 3 * n, n, "cpu")
        assert bool((mask == -1e30).all()), name


@pytest.mark.parametrize("m", WORLDS)
def test_greedy_pick_takes_the_lowest_index_of_the_max(ranks, m):
    for name in CASES:
        cfg = _cfg(CASES[name])
        w = ranks["cases"][name][f"pick{m}"]
        want = np.argmax(w[:, :cfg.vocab], axis=-1)   # numpy: first max
        assert want[1] == cfg.vocab_padded // m - 1 and want[4] == 0
        assert want[3] == cfg.vocab - 1
        for r, got in enumerate(ranks["got"][m]):
            np.testing.assert_array_equal(got[f"{name}/pick"], want,
                                          err_msg=f"{name} rank {r}")


def test_greedy_pick_without_a_group_is_argmax():
    w = torch.tensor([[0.0, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    assert serve.greedy_pick(w, None).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# loss_fn(plan=) of whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", LOSS_RUNS,
                         ids=[_run_id(a, s) for a, s in LOSS_RUNS])
def test_sharded_loss_and_gradients_equal_one_process(ranks, arch, shape):
    cfg, ms = _cfg(arch), _mesh(shape)
    sizes = dict(zip(ms.axis_names, ms.shape))
    sp = dict(common.leaves(S.param_pspecs(cfg, ms)))
    whole = ranks["whole"][arch, shape]           # one (loss, grads) a row
    tag = _run_id(arch, shape)
    for r, got in enumerate(ranks["got"][ms.size]):
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
        if shape[0] > 1:                # eval: the mean over the data rows
            params = _params(arch, ranks["weights"][arch])
            with torch.no_grad():
                want = float(T.loss_fn(params, _model_batch(arch), cfg,
                                       device="cpu")[0])
            np.testing.assert_allclose(got[f"{tag}/eval"], want, rtol=TOL)


@pytest.mark.parametrize("m", WORLDS)
def test_sharded_loss_equals_the_reference(ranks, m):
    cfg = _cfg(REFERENCE)
    loss, g_embed = ranks["ref"]
    n = cfg.vocab_padded // m
    tag = _run_id(REFERENCE, (1, m))
    top = np.abs(g_embed).max()
    for r, got in enumerate(ranks["got"][m]):
        np.testing.assert_allclose(got[f"{tag}/loss"], loss,
                                   rtol=JAX_LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(
            got[f"{tag}/g/embed"], g_embed[r * n:(r + 1) * n], rtol=0,
            atol=JAX_GRAD_OF_MAX * top, err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# The plan and the dry run, without ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def no_fake_group_left():
    """The fake default group the tests below make, destroyed afterwards:
    the next test module in this process may start a real one."""
    yield
    OA.close_fake_groups()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (16, 16)],
                         ids=["2x2", "1x4", "16x16"])
def test_plan_keeps_the_vocabulary_blocks(no_fake_group_left, shape):
    d, m = shape
    for arch in list_archs():
        cfg = get_config(arch, smoke=shape != (16, 16))
        plan = parallel.Plan(
            cfg, S.param_pspecs(cfg, _mesh(shape)),
            model=OA.fake_group(m, "model"),
            data=OA.fake_group(d, "data") if d > 1 else None)
        want = (("embed",),) if cfg.tie_embeddings \
            else (("embed",), ("lm_head",))
        assert plan.vocab_leaves == want, arch
        assert plan.vocab is plan.model, arch
        assert plan.counts()["vocab_leaves"] == len(want), arch
        assert not set(want) & set(plan.gathered()), arch


def _gathering_the_vocabulary(plan) -> None:
    """``plan`` as it was before the vocabulary ran over its blocks: its
    vocabulary leaves gathered whole over "model" where they are used."""
    plan.vocab_leaves, plan.vocab, plan.local = (), None, plan.keep


@pytest.mark.parametrize("arch", ["hymba-1.5b", "nemotron-4-340b"])
def test_dryrun_all_gather_drops_by_the_vocabulary(no_fake_group_left,
                                                   arch):
    new = dryrun.rank_cell(arch, "decode_32k", "16x16")
    old = dryrun.rank_cell(arch, "decode_32k", "16x16")
    before = old.plan.counts()
    _gathering_the_vocabulary(old.plan)
    got, was = OA.count(new.fn, *new.args), OA.count(old.fn, *old.args)
    cfg = get_config(arch)
    specs = dict(common.leaves(T.param_specs(cfg)))
    leaves = new.plan.vocab_leaves
    whole = sum(math.prod(specs[p].shape) for p in leaves) \
        * new.dtype.itemsize
    assert was.coll_by_op["all-gather"] - got.coll_by_op["all-gather"] \
        == whole
    assert old.plan.counts()["gathered_leaves"] \
        == before["gathered_leaves"] + before["vocab_leaves"] == \
        new.plan.counts()["gathered_leaves"] + len(leaves)
    if arch == "hymba-1.5b":
        assert whole == 205_619_200
    else:                       # FSDP: embed cut over both axes
        sp = dict(common.leaves(S.param_pspecs(cfg, _mesh((16, 16)))))
        assert sp[("embed",)] == ("model", "data")
