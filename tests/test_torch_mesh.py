"""The port's mesh pieces on gloo rank processes, on the CPU: the
sequence-sharded decode, a smoke model's decode with ``kv_shard``,
``launch.train --mesh 2x1`` and the 8 -> 4 elastic reshard of a sharded
index through ``train.Checkpointer``.

The port's ranks are processes on one gloo group (a ``file://`` store
under ``tmp_path``), started with ``subprocess``, one thread each, each
with a timeout, as tests/test_torch_distributed.py starts them; repro's
``decode_attend_seqsharded`` runs under ``shard_map`` in a subprocess
with 2 and 4 fake devices (``conftest.run_subprocess``).

Tolerances: the sharded decode against repro's at B=1, S=512, pos=300,
chunk 64 (every shard a whole number of chunks), rtol / atol 2e-4, the
bar of tests/test_distributed.py's test; the caches after the write
bitwise.  At a ragged shard (S=300 over 2 and 4 ranks, 150 and 75 slots
a shard at chunk 64) the port against a plain masked softmax over the
whole cache in float64, 1e-5; repro is not compared there: it drops a
shard's ragged tail (ROADMAP.md Queue 3).  Hymba ``smoke()``'s 8 decode
steps with ``kv_shard`` against one-rank ``decode_step`` from the same
prefill: logits and the gathered caches 1e-5 (the same softmax merged in
another order).  ``launch.train --mesh 2x1`` on granite-moe-1b-a400m
``smoke()``: the checkpointed parameters and optimizer state after two
steps against one process's steps over the whole batch in two
microbatches (the same per-call token counts, so the same MoE capacity),
1e-6; ``launch.train --mesh 2x1 --grad-compression int8``: its
checkpoint against the same two steps taken by ``make_train_step(group=,
compression="int8")`` on 2 gloo ranks, 1e-6; ``make_train_step(group=)`` on 2 and 4 ranks, the loss and
gradient norm against one process's in 2 and 4 microbatches, 1e-6 with
the plain all-reduce, and with the int8 all-gather the loss 1e-6 (it is
not compressed) and the gradient norm 1e-2.  The reshard: ids equal to
repro's ``ucr.search_scan`` and distances rtol / atol 1e-4, the bar of
tests/test_distributed.py.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

from repro.core import ucr as jucr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import random_walk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import Checkpointer, make_train_step  # noqa: E402
from repro_torch.train import opt_init  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

from conftest import run_subprocess  # noqa: E402

WORLDS = (2, 4)
B, S, H, KVH, HD, POS, CHUNK = 1, 512, 4, 2, 16, 300, 64
RAGGED_S, RAGGED_POS = 300, 217
HYMBA, PROMPT, GEN = "hymba-1.5b", 24, 8      # + 8 meta tokens: 40 slots
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = \
    "granite-moe-1b-a400m", 4, 32, 2
N_SERIES, LEN, CAP, Q = 2048, 128, 64, 4
RANK_TIMEOUT = 240

REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from repro.models import attention
d = np.load({inp!r})
mesh = jax.make_mesh(({world},), ("data",))
got, kc, vc = jax.jit(lambda q, kn, vn, k, v: attention.decode_attend_seqsharded(
    q, kn, vn, k, v, jnp.asarray({pos}), mesh=mesh, axes=("data",),
    chunk={chunk}))(*(jnp.asarray(d[n]) for n in ("q", "kn", "vn", "k", "v")))
np.savez({out!r}, out=np.asarray(got), k=np.asarray(kc), v=np.asarray(vc))
print("OK")
"""

# one rank of the decode checks: the sharded decode at whole-chunk and
# ragged shards, then Hymba smoke()'s decode with kv_shard
DECODE_RANK = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch import serve, specs as S
from repro_torch.models import attention, transformer as T
world, rank = {world}, int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
out = {{}}
for tag, inp, pos in (("whole", {inp!r}, {pos}), ("ragged", {rinp!r}, {rpos})):
    d = {{k: torch.from_numpy(v) for k, v in np.load(inp).items()}}
    sloc = d["k"].shape[1] // world
    mine = lambda t: t[:, rank * sloc:(rank + 1) * sloc].clone()
    got, kc, vc = attention.decode_attend_seqsharded(
        d["q"], d["kn"], d["vn"], mine(d["k"]), mine(d["v"]), pos,
        chunk={chunk})
    out[tag + "_out"], out[tag + "_k"], out[tag + "_v"] = (
        got.numpy(), kc.numpy(), vc.numpy())

cfg = get_config({arch!r}, smoke=True)
params = serve.build_params(cfg, 0, "cpu")
toks = np.load({tok!r})["tokens"]
cache = T.init_cache(cfg, toks.shape[0], {prompt} + {gen}, dtype=torch.float32,
                     device="cpu")
_, cache = T.prefill(params, {{"tokens": toks[:, :{prompt}]}}, cache, cfg,
                     device="cpu")
# this rank's slice of every full-attention segment's positions, the
# rest whole: long_500k's layout on a data axis of ``world`` ranks
cache = S.cache_blocks(cache, [
    {{k: (None, None, "data") if seg.kind == "full" and k in ("k", "v")
      else () for k in c}} for seg, c in zip(T.segments(cfg), cache)],
    {{"data": rank}}, {{"data": world}})
steps = []
for t in range({prompt}, {prompt} + {gen}):
    lg, cache = T.decode_step(params, toks[:, t:t + 1], t, cache, cfg,
                              kv_shard=dist.group.WORLD, device="cpu")
    steps.append(lg[:, 0].numpy())
out["steps"] = np.stack(steps, 1)
for i, seg in enumerate(cache):
    for name, t in seg.items():
        out[f"cache{{i}}_{{name}}"] = t.numpy()

# make_train_step on the group: this rank's rows of the batch, both wire
# formats (the same step a rank takes under launch.train --mesh)
from repro_torch.launch.train import make_batch_fn
from repro_torch.train import make_train_step, opt_init
tcfg = get_config({tarch!r}, smoke=True)
batch = make_batch_fn(tcfg, {tbatch}, {tseq}, 0)(0)
rows = {tbatch} // world
mine = {{k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}}
for comp in ("none", "int8"):
    p = serve.build_params(tcfg, 0, "cpu")
    _, st, m = make_train_step(tcfg, base_lr=1e-2, warmup=1, microbatch=1,
                               group=dist.group.WORLD, compression=comp,
                               device="cpu")(p, opt_init(tcfg.optimizer, p),
                                             mine)
    for k in ("loss", "grad_norm", "skipped"):
        out[f"train_{{comp}}_{{k}}"] = float(m[k])
if world == 2:   # the steps of launch.train --mesh 2x1 --grad-compression int8
    p = serve.build_params(tcfg, 0, "cpu")
    st = opt_init(tcfg.optimizer, p)
    step = make_train_step(tcfg, base_lr=1e-2, total_steps={tsteps},
                           warmup=min(100, {tsteps} // 10 + 1), microbatch=1,
                           group=dist.group.WORLD, compression="int8",
                           device="cpu")
    next_batch = make_batch_fn(tcfg, {tbatch}, {tseq}, 0)
    for i in range({tsteps}):
        p, st, _ = step(p, st, {{k: v[rank * rows:(rank + 1) * rows]
                               for k, v in next_batch(i).items()}})
    from repro_torch.models import common
    for tag, tree in (("p", p), ("m", st.m)):
        for i, (_, t) in enumerate(common.leaves(tree)):
            out[f"int8_{{tag}}{{i}}"] = t.numpy()
np.savez({outdir!r} + f"/rank{{rank}}.npz", **out)
dist.destroy_process_group()
"""

# the elastic reshard: 8 ranks build and save, 4 restore and search
RESHARD_RANK = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import distributed
from repro_torch.train import Checkpointer
world, rank, phase = {world}, int(sys.argv[1]), {phase!r}
dist.init_process_group("gloo", init_method={init!r}, world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
d = np.load({inp!r})
qs = torch.from_numpy(d["qs"])
if phase == "save":
    per = d["raw"].shape[0] // world
    shard = distributed.build_sharded(d["raw"][rank * per:(rank + 1) * per],
                                      rank * per, capacity={cap},
                                      device="cpu")
    res = distributed.search_sharded(shard, qs, k=1, device="cpu")
    arrays = distributed.gather_index(shard)
    if rank == 0:
        Checkpointer({ckpt!r}, async_writes=False).save(0, {{"idx": arrays}})
        np.savez({outdir!r} + "/saved.npz", dist=res.dist.numpy(),
                 idx=res.idx.numpy(), **arrays)
else:
    like = np.load({outdir!r} + "/saved.npz")
    tmpl = {{"idx": {{k: np.zeros_like(like[k]) for k in
                     ("raw", "slo", "shi", "elo", "ehi", "ids", "meta")}}}}
    back = Checkpointer({ckpt!r}, async_writes=False).restore(tmpl)["idx"]
    shard = distributed.index_shard(back, device="cpu")
    res = distributed.search_sharded(shard, qs, k=1, device="cpu")
    np.savez({outdir!r} + f"/rank{{rank}}.npz", dist=res.dist.numpy(),
             idx=res.idx.numpy(), blocks=shard.ids.shape[0],
             n_real=shard.n_real)
dist.barrier()
dist.destroy_process_group()
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _ranks(code: str, world: int, outdir) -> list[dict]:
    """``world`` rank processes of ``code`` (its rank is argv[1]); ->
    each rank's npz, where it wrote one."""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
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
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)
            if (outdir / f"rank{r}.npz").exists()]


def _decode_inputs(path, s, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    np.savez(path, q=mk(B, 1, H, HD), kn=mk(B, 1, KVH, HD),
             vn=mk(B, 1, KVH, HD), k=mk(B, s, KVH, HD), v=mk(B, s, KVH, HD))


def _decode_ranks(world, tmp):
    outdir = tmp / f"decode{world}"
    outdir.mkdir()
    code = DECODE_RANK.format(
        world=world, init=f"file://{outdir}/store", inp=str(tmp / "dec.npz"),
        pos=POS, rinp=str(tmp / "ragged.npz"), rpos=RAGGED_POS, chunk=CHUNK,
        arch=HYMBA, tok=str(tmp / "tokens.npz"), prompt=PROMPT, gen=GEN,
        tarch=TRAIN_ARCH, tbatch=TRAIN_BATCH, tseq=TRAIN_SEQ,
        tsteps=TRAIN_STEPS, outdir=str(outdir))
    return _ranks(code, world, outdir)


def _reshard(tmp):
    outdir = tmp / "reshard"
    outdir.mkdir()
    raw = random_walk(N_SERIES, LEN, seed=2)
    qs = random_walk(Q, LEN, seed=3)
    np.savez(tmp / "series.npz", raw=raw, qs=qs)
    runs = {}
    for world, phase in ((8, "save"), (4, "restore")):
        code = RESHARD_RANK.format(
            world=world, phase=phase, init=f"file://{outdir}/{phase}",
            inp=str(tmp / "series.npz"), cap=CAP, ckpt=str(tmp / "ckpt"),
            outdir=str(outdir))
        runs[phase] = _ranks(code, world, outdir)
    return raw, qs, dict(np.load(outdir / "saved.npz")), runs["restore"]


def _train_mesh(tmp, compression="none"):
    """``launch.train --mesh 2x1 --grad-compression <compression>`` as a
    user runs it (it starts its own ranks); -> the checkpoint it wrote
    after its last step, and its log."""
    ck = tmp / f"mesh_ckpt_{compression}"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--smoke", "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", "1e-2",
         "--ckpt-dir", str(ck), "--log-every", "1", "--device", "cpu",
         "--mesh", "2x1", "--grad-compression", compression], env=_env(),
        capture_output=True, text=True,
        timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return ck, r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything at once: repro's sharded decode at 2 and 4 devices, the
    port's decode ranks at 2 and 4, the reshard, the training CLI."""
    tmp = tmp_path_factory.mktemp("mesh")
    _decode_inputs(tmp / "dec.npz", S, 0)
    _decode_inputs(tmp / "ragged.npz", RAGGED_S, 1)
    cfg = get_config(HYMBA, smoke=True)
    np.savez(tmp / "tokens.npz", tokens=np.random.default_rng(4).integers(
        0, cfg.vocab, (2, PROMPT + GEN)))
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNEL_MODE", "ref")
    try:
        with ThreadPoolExecutor(8) as ex:
            refs = {w: ex.submit(run_subprocess, REFERENCE.format(
                inp=str(tmp / "dec.npz"), out=str(tmp / f"ref{w}.npz"),
                world=w, pos=POS, chunk=CHUNK), w) for w in WORLDS}
            ranks = {w: ex.submit(_decode_ranks, w, tmp) for w in WORLDS}
            reshard = ex.submit(_reshard, tmp)
            train = ex.submit(_train_mesh, tmp)
            train_int8 = ex.submit(_train_mesh, tmp, "int8")
            for f in refs.values():
                f.result()
            out = dict(
                tmp=tmp,
                ref={w: dict(np.load(tmp / f"ref{w}.npz")) for w in WORLDS},
                ranks={w: f.result() for w, f in ranks.items()},
                reshard=reshard.result(), train=train.result(),
                train_int8=train_int8.result())
    finally:
        mp.undo()
    return out


def _load(tmp, name):
    return {k: torch.from_numpy(v) for k, v in np.load(tmp / name).items()}


@pytest.mark.parametrize("world", WORLDS)
def test_seqsharded_decode_matches_reference(runs, world):
    ref, ranks = runs["ref"][world], runs["ranks"][world]
    for r in ranks:               # every rank holds the merged answer
        np.testing.assert_allclose(r["whole_out"], ref["out"], rtol=2e-4,
                                   atol=2e-4)
    for name in ("k", "v"):       # the owner's write landed, and only it
        got = np.concatenate([r["whole_" + name] for r in ranks], axis=1)
        np.testing.assert_array_equal(got, ref[name])
        d = np.load(runs["tmp"] / "dec.npz")
        want = d[name].copy()
        want[:, POS] = d[name + "n"][:, 0]
        np.testing.assert_array_equal(got, want)


def _plain_decode(d, pos):
    """Masked softmax over the whole written cache, float64."""
    k, v = d["k"].double().clone(), d["v"].double().clone()
    k[:, pos], v[:, pos] = d["kn"][:, 0].double(), d["vn"][:, 0].double()
    g = H // KVH
    q = d["q"].double().reshape(B, KVH, g, HD)
    s = torch.einsum("bkgh,bskh->bkgs", q, k) * HD ** -0.5
    s[..., pos + 1:] = -torch.inf
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v).reshape(B, 1, H, HD)


@pytest.mark.parametrize("world", WORLDS)
def test_seqsharded_decode_reads_a_ragged_shard(runs, world):
    """150 or 75 slots a shard at chunk 64: every slot up to pos is read
    (the reference reads 128 or 64 of them)."""
    want = _plain_decode(_load(runs["tmp"], "ragged.npz"), RAGGED_POS)
    for r in runs["ranks"][world]:
        np.testing.assert_allclose(r["ragged_out"], want.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def one_rank_decode(runs):
    """Hymba smoke()'s prefill and 8 decode steps on one process."""
    cfg = get_config(HYMBA, smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    toks = np.load(runs["tmp"] / "tokens.npz")["tokens"]
    cache = T.init_cache(cfg, toks.shape[0], PROMPT + GEN,
                         dtype=torch.float32, device="cpu")
    _, cache = T.prefill(params, {"tokens": toks[:, :PROMPT]}, cache, cfg,
                         device="cpu")
    steps = []
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], t, cache, cfg,
                                  device="cpu")
        steps.append(lg[:, 0].numpy())
    return cfg, np.stack(steps, 1), cache


@pytest.mark.parametrize("world", WORLDS)
def test_kv_shard_decode_matches_one_rank(runs, one_rank_decode, world):
    cfg, steps, cache = one_rank_decode
    ranks = runs["ranks"][world]
    for r in ranks:
        np.testing.assert_allclose(r["steps"], steps, rtol=0, atol=1e-5)
    for i, (seg, c) in enumerate(zip(T.segments(cfg), cache)):
        for name, t in c.items():
            parts = [r[f"cache{i}_{name}"] for r in ranks]
            if seg.kind == "full" and name in ("k", "v"):
                assert parts[0].shape[2] == t.shape[2] // world
                got = np.concatenate(parts, axis=2)
            else:
                got = parts[0]
            np.testing.assert_allclose(got, t.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{seg} {name}")


def test_train_mesh_2x1_matches_one_process(runs):
    ck, log = runs["train"]
    assert "step     1" in log and "done." in log
    cfg = get_config(TRAIN_ARCH, smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    opt = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, base_lr=1e-2, total_steps=TRAIN_STEPS,
                           warmup=min(100, TRAIN_STEPS // 10 + 1),
                           microbatch=2, device="cpu")
    next_batch = launch_train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    for i in range(TRAIN_STEPS):
        params, opt, m = step(params, opt, next_batch(i))
        assert int(m["skipped"]) == 0
    back = Checkpointer(str(ck), async_writes=False).restore(
        {"params": params, "opt": opt, "meta": {"step": 0}})
    assert back["meta"]["step"] == TRAIN_STEPS - 1
    for (path, want), (_, got) in zip(common.leaves(params),
                                      common.leaves(back["params"])):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6,
                                   msg=str(path))
    for (path, want), (_, got) in zip(common.leaves(opt.m),
                                      common.leaves(back["opt"].m)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6,
                                   msg=str(path))


def test_train_mesh_2x1_int8_matches_the_int8_step_on_2_ranks(runs):
    """``--grad-compression int8`` reaches the ranks' steps: the CLI's
    checkpoint is the parameters and first moments that two steps of
    ``make_train_step(group=, compression="int8")`` give on 2 ranks."""
    ck, log = runs["train_int8"]
    assert "step     1" in log and "done." in log
    ranks = runs["ranks"][2]
    cfg = get_config(TRAIN_ARCH, smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    opt = opt_init(cfg.optimizer, params)
    back = Checkpointer(str(ck), async_writes=False).restore(
        {"params": params, "opt": opt, "meta": {"step": 0}})
    assert back["meta"]["step"] == TRAIN_STEPS - 1
    for tag, tree in (("p", back["params"]), ("m", back["opt"].m)):
        for i, (path, got) in enumerate(common.leaves(tree)):
            for r in ranks:       # every rank holds the same state
                np.testing.assert_allclose(got.numpy(), r[f"int8_{tag}{i}"],
                                           rtol=0, atol=1e-6,
                                           err_msg=str(path))


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_on_a_group_matches_one_process(runs, world):
    """``make_train_step(group=)`` on every rank's share of the batch:
    the averaged loss and gradient norm one process's over the whole
    batch in ``world`` microbatches, 1e-6 relative with the plain
    all-reduce; with the int8 all-gather the loss the same (it is not
    compressed) and the gradient norm within 1e-2 (int8 rounding)."""
    cfg = get_config(TRAIN_ARCH, smoke=True)
    params = serve.build_params(cfg, 0, "cpu")
    batch = launch_train.make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(0)
    _, _, m = make_train_step(cfg, base_lr=1e-2, warmup=1, microbatch=world,
                              device="cpu")(
        params, opt_init(cfg.optimizer, params), batch)
    for r in runs["ranks"][world]:
        for comp, tol in (("none", 1e-6), ("int8", 1e-2)):
            assert r[f"train_{comp}_skipped"] == 0
            np.testing.assert_allclose(r[f"train_{comp}_loss"],
                                       float(m["loss"]), rtol=1e-6)
            np.testing.assert_allclose(r[f"train_{comp}_grad_norm"],
                                       float(m["grad_norm"]), rtol=tol)


def test_mesh_option_refuses_a_model_axis():
    """The model axis is taken now (tests/test_torch_model_axis.py runs
    it): ``--mesh`` refuses only a malformed mesh, and ``main`` a batch
    that does not split over the data ranks."""
    assert launch_train.parse_mesh("2x1") == (2, 1)
    assert launch_train.parse_mesh("2x2") == (2, 2)
    assert launch_train.parse_mesh("1X4") == (1, 4)
    for bad in ("2x0", "0x2", "ax2", "two", "2x2x2"):
        with pytest.raises(ValueError, match="DxM"):
            launch_train.parse_mesh(bad)
    with pytest.raises(ValueError, match="does not split over 2 data"):
        launch_train.main(["--arch", TRAIN_ARCH, "--smoke", "--batch", "3",
                           "--mesh", "2x2", "--device", "cpu"])


def test_index_checkpoint_elastic_reshard_8_to_4(runs):
    raw, qs, saved, ranks = runs["reshard"]
    want = jucr.search_scan(jnp.asarray(raw), jnp.asarray(qs))
    assert len(ranks) == 4
    for r in ranks:
        assert np.array_equal(r["idx"], np.asarray(want.idx))
        np.testing.assert_allclose(r["dist"], np.asarray(want.dist),
                                   rtol=1e-4, atol=1e-4)
    assert np.array_equal(saved["idx"], np.asarray(want.idx))
    # 8 shards of 4 blocks each, restored as 4 shards of 8
    assert saved["ids"].shape[0] == 32
    assert [int(r["blocks"]) for r in ranks] == [8] * 4
    assert sum(int(r["n_real"]) for r in ranks) == N_SERIES
    assert sorted(saved["ids"].ravel()) == list(range(N_SERIES))
