"""Serving over the model axis, on the CPU: prefill and greedy decode on
a (data, model) mesh of gloo ranks, each rank holding its shards of the
parameters by the reference's ``param_pspecs`` and its blocks of every
cache by the reference's ``cache_pspecs``.

The ranks start once a mesh, as 4 processes, and serve every arch's
``smoke()`` config in turn through ``launch.serve.greedy_generate(...,
plan=)`` (prefill on the prefill layout, the caches re-cut to the
decode layout, greedy decode), and through ``make_prefill_step(plan=)``
alone for the prefill caches:

  * 2x2, batch 2: tensor-parallel attention by head with head-cut
    caches (2 KV heads), expert-parallel MoE, Hymba's Mamba by channel,
    RWKV by head, Whisper's cross caches by head; and Hymba with one KV
    head, whose full-attention positions lie over "model" while its
    batch lies over "data" (the reference's ``b_axes`` layout);
  * 1x4, batch 2: 2 KV heads do not divide 4, so the attention runs
    ragged (each rank projects onto its column blocks, half a KV head,
    and gathers the projections) and the full-attention positions lie
    over "model";
  * 2x2, batch 1, hymba and gemma3: long_500k's layout, the
    full-attention positions over the data ranks.

The weights are float64 in the ranks and in one process (the caches
float32, as ``greedy_generate`` keeps them).  In float32 the noise of
the summation order alone is at the bar: one process serving a
one-row batch against a two-row one moves Hymba's logits by 8e-7 x
max|logit|, and a rank's row-parallel sums (a matmul over its half of
the inner dim, the all-reduce of Mamba's B_t / C_t) by as much again.
In float64 those orders differ by ~1e-16, so a real fault in the layout
shows far above them.  Held, for every arch of each mesh: the tokens
equal one process's; each rank's prefill and decode logits within
1e-6 x max|logit| of one process's; its cache blocks after the prefill
and after the last step bitwise the blocks of one process's caches cut
by ``cache_pspecs`` (the float32 roundings of float64 values that agree
to ~1e-16); its parameter elements and cache block shapes those the
reference's specs cut, its plan's Mamba and RWKV leaves, and its
vocabulary leaves, attention leaves, Mamba's ``w_in`` and RWKV's
``w_cr`` used by block, never gathered.

For hymba and h2o-danube, the mesh's logits against the reference's
one-device ``transformer.prefill`` / jitted ``decode_step`` on the same
weights (built by the reference, carried by ``interop``), teacher-forced
with the mesh's tokens, at ``tests/test_torch_models.py``'s bar, 2e-3.
The caches span fewer positions than the reference's 1,024-slot decode
chunk, so the reference reads them whole (ROADMAP Queue 3).
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import common, transformer as T  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

RANK_TIMEOUT = 240
PROMPT, GEN = 36, 4          # danube's and gemma3's 32-slot rings wrap
FRAMES, DEC_PROMPT = 8, 6    # Whisper: decoder_len 16
MOE_CF = 16.0                # no drops at any token count (chip_smoke's)
REL = 1e-6
REF_ATOL = 2e-3
HYBRID, DENSE, GEMMA = "hymba-1.5b", "h2o-danube-1.8b", "gemma3-27b"
# Hymba smoke() with one KV head: on 2x2 its full-attention positions lie
# over "model" and its batch over "data" (the reference's ``b_axes``)
MQA = HYBRID + "+mqa"
REFERENCE = (HYBRID, DENSE)
MESHES = {"2x2": ((2, 2), 2, tuple(list_archs()) + (MQA,)),
          "1x4": ((1, 4), 2, tuple(list_archs())),
          "2x2-b1": ((2, 2), 1, (HYBRID, GEMMA))}
CASES = [(m, a) for m, (_, _, archs) in MESHES.items() for a in archs]
IDS = [f"{m}-{a}" for m, a in CASES]


def _cfg(arch: str):
    cfg = get_config(arch.removesuffix("+mqa"), smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    if arch.endswith("+mqa"):
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    return cfg


def _mesh(shape) -> MeshSpec:
    return MeshSpec(tuple(shape), ("data", "model"))


def _request(cfg, batch: int) -> dict:
    """The whole request every rank is given: prompt tokens (and
    Whisper's frames), from one seed."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (2, PROMPT))[:batch]
    if not cfg.enc_dec:
        return {"prompt": prompt}
    frames = rng.standard_normal((2, FRAMES, cfg.d_model)).astype(
        np.float32)[:batch] * 0.1
    return {"prompt": prompt[:, :DEC_PROMPT], "frames": frames}


RANK = r"""
import dataclasses, datetime, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch import serve, specs as S
from repro_torch.launch.mesh import MeshSpec, make_mesh
from repro_torch.models import common, parallel, transformer as T
from repro_torch.train import make_prefill_step
rank, (d, m), batch, gen = int(sys.argv[1]), {shape!r}, {batch}, {gen}
dist.init_process_group("gloo", init_method={init!r}, world_size=d * m,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
dm = make_mesh((d, m), ("data", "model"), "cpu")
ms = MeshSpec((d, m), ("data", "model"))
coords = dict(zip(ms.axis_names, divmod(rank, m)))
sizes = dict(zip(ms.axis_names, ms.shape))
for arch in {archs!r}:
    cfg = get_config(arch.removesuffix("+mqa"), smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor={cf!r})
    if arch.endswith("+mqa"):
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    w = dict(np.load({tmp!r} + f"/{{arch}}.npz"))
    pspecs = S.param_pspecs(cfg, ms)
    sp = dict(common.leaves(pspecs))
    params = common.with_leaves(T.param_specs(cfg), {{
        p: common.shard(torch.from_numpy(w["/".join(p)]).double(), sp[p],
                        coords, sizes)
        for p, _ in common.leaves(T.param_specs(cfg))}})
    plan = parallel.Plan(cfg, pspecs, model=dm.get_group("model"),
                         data=dm.get_group("data"), mesh=ms, coords=coords)
    prompt, frames = w["req/prompt"], w.get("req/frames")
    if frames is not None:
        frames = frames.astype(np.float64)
    out = serve.greedy_generate(params, cfg, prompt, gen, frames=frames,
                                plan=plan, device="cpu")
    # the prefill step alone, for its caches
    max_len = frames.shape[1] if cfg.enc_dec else prompt.shape[1] + gen
    lay = S.serving_specs(cfg, ms, batch, max_len)
    cut = lambda a: common.shard(torch.as_tensor(a), (lay["batch"],), coords,
                                 sizes)
    b = ({{"frames": cut(frames), "dec_tokens": cut(prompt)}} if cfg.enc_dec
         else {{"tokens": cut(prompt)}})
    zeros = [{{k: torch.zeros(s) for k, s in seg.items()}} for seg in
             S.cut_cache_shapes(S.cache_shapes(cfg, batch, max_len,
                                               torch.float32),
                                lay["prefill"], sizes)]
    logits, pre = make_prefill_step(cfg, plan=plan, device="cpu")(
        params, b, zeros)
    # the rank's block of the vocabulary, whole, its padding dropped
    logits = parallel.all_gather(logits[:, -1], -1, plan.vocab)
    arrays = {{"logits": out.logits.numpy(), "tokens": out.tokens.numpy(),
               "prefill_logits": logits[:, :cfg.vocab].numpy()}}
    for tag, cache in (("prefill", pre), ("final", out.cache)):
        for i, seg in enumerate(cache):
            for k, t in seg.items():
                arrays[f"{{tag}}/{{i}}/{{k}}"] = t.numpy()
    np.savez({tmp!r} + f"/{{arch}}.{{rank}}.npz", **arrays)
    info = {{"counts": plan.counts(), "kv_shard": lay["kv_shard"],
             "gathered": ["/".join(p) for p in plan.gathered()],
             "batch_entry": lay["batch"],
             "params_held": sum(t.numel() for _, t in common.leaves(params))}}
    with open({tmp!r} + f"/{{arch}}.{{rank}}.json", "w") as f:
        json.dump(info, f)
dist.destroy_process_group()
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_mesh(name: str, tmp) -> None:
    shape, batch, archs = MESHES[name]
    d = tmp / name
    d.mkdir()
    for arch in archs:
        req = {f"req/{k}": v for k, v in
               _request(_cfg(arch), batch).items()}
        np.savez(d / f"{arch}.npz", **WEIGHTS[arch], **req)
    code = RANK.format(shape=shape, batch=batch, gen=GEN, cf=MOE_CF,
                       init=f"file://{d}/store", archs=archs, tmp=str(d))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(shape[0] * shape[1])]
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
        assert p.returncode == 0, f"{name} rank {r} failed:\n{log}"


# the weights every run serves, by arch: the reference's own for the two
# archs held to it, else the port's from seed 0
WEIGHTS: dict = {}


def _weights(arch: str) -> dict:
    if arch in REFERENCE:
        jcfg = jget_config(arch, smoke=True)
        tree = jax.tree.map(np.asarray, jcommon.build_params(
            JT.param_specs(jcfg), jax.random.PRNGKey(0)))
        params = interop.params_from_arrays(tree, device="cpu")
    else:
        params = serve.build_params(_cfg(arch), 0, "cpu")
    return {"/".join(p): t.numpy() for p, t in common.leaves(params)}


def _params(arch: str, dtype=torch.float32) -> dict:
    w = WEIGHTS[arch]
    return common.with_leaves(T.param_specs(_cfg(arch)), {
        p: torch.from_numpy(w["/".join(p)]).to(dtype)
        for p, _ in common.leaves(T.param_specs(_cfg(arch)))})


def _one_process(arch: str, batch: int) -> dict:
    """One process's greedy run on the float64 weights: its tokens, its
    logits at the prefill and every step, its caches (float32, as
    ``greedy_generate`` keeps them) after the prefill and after the last
    step."""
    cfg = _cfg(arch)
    req = _request(cfg, batch)
    params = _params(arch, torch.float64)
    frames = req.get("frames")
    if frames is not None:
        frames = torch.as_tensor(frames).double()
    g = serve.greedy_generate(params, cfg, req["prompt"], GEN,
                              frames=frames, device="cpu")
    prompt = torch.as_tensor(req["prompt"])
    if cfg.enc_dec:
        b, max_len = {"frames": frames, "dec_tokens": prompt}, FRAMES
    else:
        b, max_len = {"tokens": prompt}, prompt.shape[1] + GEN
    cache = T.init_cache(cfg, batch, max_len, torch.float32, device="cpu")
    _, pre = T.prefill(params, b, cache, cfg, device="cpu")
    return {"tokens": g.tokens.numpy(), "logits": g.logits.numpy(),
            "prefill": pre, "final": g.cache, "max_len": max_len}


def _reference(arch: str, tokens: np.ndarray) -> np.ndarray:
    """The reference's one-device prefill and jitted decode steps on the
    same weights, teacher-forced with ``tokens`` (B, GEN)."""
    jcfg = jget_config(arch, smoke=True)
    pj = jcommon.build_params(JT.param_specs(jcfg), jax.random.PRNGKey(0))
    prompt = _request(_cfg(arch), tokens.shape[0])["prompt"]
    b = prompt.shape[0]
    cache = JT.init_cache(jcfg, b, PROMPT + GEN, dtype=jnp.float32)
    pre, cache = JT.prefill(pj, {"tokens": jnp.asarray(prompt)}, cache, jcfg)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    out = [np.asarray(pre[:, -1])]
    for i in range(GEN - 1):
        lg, cache = step(pj, jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                         jnp.asarray(PROMPT + i), cache)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every mesh's ranks at once; meanwhile one process's runs and the
    reference's."""
    tmp = tmp_path_factory.mktemp("serve_axis")
    for arch in MESHES["2x2"][2]:
        WEIGHTS[arch] = _weights(arch)
    with ThreadPoolExecutor(len(MESHES)) as ex:
        runs = [ex.submit(_run_mesh, name, tmp) for name in MESHES]
        one = {(a, b): _one_process(a, b) for b in (2, 1)
               for a in MESHES["2x2" if b == 2 else "2x2-b1"][2]}
        ref = {a: _reference(a, one[a, 2]["tokens"]) for a in REFERENCE}
        for f in runs:
            f.result()
    return {"tmp": tmp, "one": one, "ref": ref}


def _rank(served, mesh: str, arch: str, r: int):
    d = served["tmp"] / mesh
    with open(d / f"{arch}.{r}.json") as f:
        info = json.load(f)
    return dict(np.load(d / f"{arch}.{r}.npz")), info


def _rows(info, mesh: str, r: int, batch: int) -> slice:
    """The batch rows the rank at ``r`` serves."""
    (dd, m), _, _ = MESHES[mesh]
    if info["batch_entry"] is None:
        return slice(0, batch)
    n = batch // dd
    return slice(r // m * n, (r // m + 1) * n)


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_rank_logits_and_tokens_equal_one_process(served, mesh, arch):
    shape, batch, _ = MESHES[mesh]
    one = served["one"][arch, batch]
    scale = np.abs(one["logits"]).max()
    for r in range(shape[0] * shape[1]):
        got, info = _rank(served, mesh, arch, r)
        rows = _rows(info, mesh, r, batch)
        np.testing.assert_array_equal(got["tokens"], one["tokens"][rows],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], one["logits"][rows],
                                   rtol=0, atol=REL * scale,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["prefill_logits"],
                                   one["logits"][rows, 0], rtol=0,
                                   atol=REL * scale, err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_rank_caches_are_the_cache_pspecs_blocks(served, mesh, arch):
    shape, batch, _ = MESHES[mesh]
    cfg, ms = _cfg(arch), _mesh(shape)
    one = served["one"][arch, batch]
    lay = S.serving_specs(cfg, ms, batch, one["max_len"])
    sizes = dict(zip(ms.axis_names, ms.shape))
    for tag, specs in (("prefill", lay["prefill"]),
                       ("final", lay["decode"])):
        for r in range(ms.size):
            got, _ = _rank(served, mesh, arch, r)
            coords = dict(zip(ms.axis_names, divmod(r, shape[1])))
            want = S.cache_blocks(one[tag], specs, coords, sizes)
            for i, seg in enumerate(want):
                for k, w in seg.items():
                    np.testing.assert_array_equal(
                        got[f"{tag}/{i}/{k}"], w.numpy(),
                        err_msg=f"{tag} rank {r} segment {i} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_hold_the_reference_shards(served, mesh):
    """Each rank's parameters and caches are the shapes the reference's
    specs cut; its plan runs Mamba by channel and RWKV by head; the
    decode's positions split where ``kv_shard_axes`` puts them."""
    shape, batch, archs = MESHES[mesh]
    ms = _mesh(shape)
    sizes = dict(zip(ms.axis_names, ms.shape))
    m = shape[1]
    for arch in archs:
        cfg = _cfg(arch)
        held = S.held_elements(S.state_shard_shapes(cfg, ms)["params"])
        one = served["one"][arch, batch]
        lay = S.serving_specs(cfg, ms, batch, one["max_len"])
        want = S.cut_cache_shapes(
            S.cache_shapes(cfg, batch, one["max_len"], torch.float32),
            lay["decode"], sizes)
        for r in range(ms.size):
            got, info = _rank(served, mesh, arch, r)
            assert info["params_held"] == held, (arch, r)
            assert [{k: tuple(got[f"final/{i}/{k}"].shape) for k in seg}
                    for i, seg in enumerate(want)] == want, (arch, r)
            c = info["counts"]
            assert c["vocab_leaves"] > 0, (arch, r)
            assert not {"embed", "lm_head"} & set(info["gathered"]), (arch, r)
            # attention runs on its column blocks, Mamba on its w_in block,
            # RWKV's channel mix on its w_cr block
            assert not [p for p in info["gathered"] if "/attn/" in p
                        or "/xattn/" in p or p.endswith("/w_in")
                        or p.endswith("/w_cr")], (arch, r, info["gathered"])
            assert c["mamba_leaves"] == (9 if cfg.family == "hybrid" else 0)
            assert c["rwkv_leaves"] == (9 if cfg.family == "ssm" else 0)
            kvs = info["kv_shard"]
            if mesh == "2x2-b1":
                assert kvs == ["data"], arch
            elif cfg.n_kv_heads % m and not (cfg.enc_dec
                                             or cfg.family == "ssm"):
                assert kvs == ["model"], arch
            else:
                assert kvs is None, arch
        if cfg.family == "hybrid":
            assert want[0]["m_h"][2] == cfg.q_dim // m
        if cfg.family == "ssm":
            assert want[0]["s"][2] == cfg.d_model // cfg.rwkv_head_dim // m


REF_CASES = [(m, a) for m, a in CASES if a in REFERENCE]


@pytest.mark.parametrize("mesh,arch", REF_CASES,
                         ids=[f"{m}-{a}" for m, a in REF_CASES])
def test_mesh_serving_equals_the_reference(served, mesh, arch):
    shape, batch, _ = MESHES[mesh]
    want = served["ref"][arch][:batch]
    for r in range(shape[0] * shape[1]):
        got, info = _rank(served, mesh, arch, r)
        rows = _rows(info, mesh, r, batch)
        np.testing.assert_allclose(got["logits"], want[rows], rtol=0,
                                   atol=REF_ATOL, err_msg=f"rank {r}")
