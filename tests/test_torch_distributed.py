"""The port's distributed protocol (``repro_torch.core.distributed``)
against repro's, on the CPU.

``repro`` runs its shard_map protocol in a subprocess with S fake devices
(``conftest.run_subprocess``, ``REPRO_KERNEL_MODE=ref``) and saves its
sharded indexes and answers.  The port runs the same protocol in S rank
processes on a gloo group (a ``file://`` store under ``tmp_path``, so
test workers never share a port), each rank on its shard of repro's
index carried across with ``interop.block_index_from_arrays``.  At world
sizes 2 and 4: ids equal, squared distances within rtol 1e-5 / atol 1e-4
(``tests/_torch_parity.py``'s bar: the expanded form's noise near a zero
distance) and every ``SearchStats`` counter (summed over shards) equal, for ED block-major at
k in {1, 5, 32}, query-major, a deadline, DTW(r=4), Cosine on a
``normalize=False`` index and the sharded scan; every rank holds the same
answer; the resumed round 2 is bitwise the re-prepared one; and the
port's own ``build_sharded`` equals repro's shards.

The out-of-core protocol runs both packages' ``search_sharded_ooc`` over
the same two repro-written ``.dsix`` shards: answers, stats and every
``IOStats`` field equal, with ``tests/test_protocol.py``'s invariants.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro import storage as jst
from repro.core import distributed as jdist
from repro_torch import storage as tst
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.data import random_walk
from _torch_parity import one_intra_op_thread  # noqa: F401

from conftest import run_subprocess

WORLDS = (2, 4)
N, LEN, CAP, Q = 2048, 128, 64, 5
VN, VDIM, VCAP = 1024, 64, 32
ARRAYS = ("raw", "slo", "shi", "elo", "ehi", "ids")
FIELDS = ("blocks_visited", "series_refined", "lb_series", "iters")
# case -> k; the rest of each side's call is in the scripts below
CASES = {"ed_k1": 1, "ed_k5": 5, "ed_k32": 32, "query_major": 5,
         "deadline": 5, "dtw": 5, "cosine": 5, "scan": 5}
GROUPS = (("ed_k1", "ed_k5", "ed_k32", "cosine"),
          ("query_major", "deadline", "dtw", "scan"))
RANK_TIMEOUT = 240          # seconds a rank may take, start to finish

# repro's side: build_sharded's per-shard body (``core.build`` with global
# ids) shard by shard, stacked as build_sharded stacks them (a build under
# shard_map compiles for over a minute here), then repro's own
# search_sharded / search_sharded_scan for the named cases
REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
import repro.core as core
from repro.core import distributed, engine
from repro.core.index import BlockIndex
d = np.load({inp!r})
world = {world}
mesh = jax.make_mesh((world,), ("data",))
raw, qs = jnp.asarray(d["raw"]), jnp.asarray(d["qs"])
vqs = jnp.asarray(d["vqs"])

def sharded(x, cap, normalize):
    per = x.shape[0] // world
    parts = [core.build(x[r * per:(r + 1) * per], capacity=cap,
                        normalize=normalize,
                        ids=jnp.arange(r * per, (r + 1) * per,
                                       dtype=jnp.int32))
             for r in range(world)]
    p0 = parts[0]
    return BlockIndex(**{{f: jnp.concatenate(
        [getattr(p, f) for p in parts], axis=1 if f in ("elo", "ehi") else 0)
        for f in {arrays!r}}}, n=p0.n, w=p0.w, card=p0.card,
        capacity=p0.capacity, n_real=p0.n_real)

out = {{}}
sidx = sharded(raw, {cap}, True)
vidx = sharded(engine.prep_vectors(jnp.asarray(d["embs"])), {vcap}, False)
for pre, ix in (("ed", sidx), ("vec", vidx)):
    for f in {arrays!r}:
        out[pre + "_" + f] = np.asarray(getattr(ix, f))
    out[pre + "_meta"] = np.array([ix.n, ix.w, ix.card, ix.capacity,
                                   ix.n_real])
runs = {{
    "ed_k1": lambda: distributed.search_sharded(sidx, qs, mesh, k=1),
    "ed_k5": lambda: distributed.search_sharded(sidx, qs, mesh, k=5),
    "ed_k32": lambda: distributed.search_sharded(sidx, qs, mesh, k=32),
    "query_major": lambda: distributed.search_sharded(
        sidx, qs, mesh, k=5, schedule="query_major"),
    "deadline": lambda: distributed.search_sharded(sidx, qs, mesh, k=5,
                                                   deadline_blocks=2),
    "dtw": lambda: distributed.search_sharded(sidx, qs, mesh, k=5,
                                              metric=engine.DTW(r=4)),
    "cosine": lambda: distributed.search_sharded(vidx, vqs, mesh, k=5,
                                                 metric=engine.Cosine()),
    "scan": lambda: distributed.search_sharded_scan(raw, qs, mesh, k=5),
}}
for name in {cases!r}:
    r = runs[name]()
    out[name + "_dist"] = np.asarray(r.dist)
    out[name + "_idx"] = np.asarray(r.idx)
    for f in {fields!r}:
        out[name + "_" + f] = np.asarray(getattr(r.stats, f))
np.savez({out!r}, **out)
print("OK")
"""

RANK = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import interop
from repro_torch.core import distributed, engine
from repro_torch.core import frontier as frontier_lib
from repro_torch.core.frontier import Frontier

world, rank = {world}, int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=120))
d, ref = np.load({inp!r}), np.load({ref!r})

def shard(pre):
    n, w, card, cap, n_real = (int(v) for v in ref[pre + "_meta"])
    arrays = {{f: np.split(ref[pre + "_" + f], world,
                          axis=1 if f in ("elo", "ehi") else 0)[rank]
              for f in {arrays!r}}}
    return interop.block_index_from_arrays(arrays, n=n, w=w, card=card,
                                           capacity=cap, n_real=n_real,
                                           device="cpu")

sidx, vidx = shard("ed"), shard("vec")
qs, vqs = torch.from_numpy(d["qs"]), torch.from_numpy(d["vqs"])
per = d["raw"].shape[0] // world
lo = rank * per
mine = d["raw"][lo:lo + per]
kw = dict(device="cpu")
runs = {{
    "ed_k1": lambda: distributed.search_sharded(sidx, qs, k=1, **kw),
    "ed_k5": lambda: distributed.search_sharded(sidx, qs, k=5, **kw),
    "ed_k32": lambda: distributed.search_sharded(sidx, qs, k=32, **kw),
    "query_major": lambda: distributed.search_sharded(
        sidx, qs, k=5, schedule="query_major", **kw),
    "deadline": lambda: distributed.search_sharded(sidx, qs, k=5,
                                                   deadline_blocks=2, **kw),
    "dtw": lambda: distributed.search_sharded(sidx, qs, k=5,
                                              metric=engine.DTW(r=4), **kw),
    "cosine": lambda: distributed.search_sharded(vidx, vqs, k=5,
                                                 metric=engine.Cosine(),
                                                 **kw),
    "scan": lambda: distributed.search_sharded_scan(mine, lo, qs, k=5, **kw),
}}
out = {{}}
for name, fn in runs.items():
    r = fn()
    out[name + "_dist"] = r.dist.numpy()
    out[name + "_idx"] = r.idx.numpy()
    for f in {fields!r}:
        out[name + "_" + f] = getattr(r.stats, f).numpy()

# round 2 re-prepared instead of resumed: the protocol before round-1 reuse
m, k = engine.ED(), 5
prep = engine.prepare(m, sidx, qs, k)
thr = prep.front.threshold().clone()
dist.all_reduce(thr, op=dist.ReduceOp.MIN)
res = engine.run(sidx, qs, engine.QueryPlan(metric=m, k=k),
                 initial_threshold=thr, device="cpu")
f = frontier_lib.all_gather_merge(Frontier(res.dist, res.idx))
out["noreuse_dist"], out["noreuse_idx"] = f.dists.numpy(), f.ids.numpy()
for name in {fields!r}:
    t = getattr(res.stats, name).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX if name == "iters"
                    else dist.ReduceOp.SUM)
    out["noreuse_" + name] = t.numpy()

# the port's own shards of the same rows
own = distributed.build_sharded(mine, lo, capacity={cap}, **kw)
vown = distributed.build_sharded(
    engine.prep_vectors(torch.from_numpy(d["embs"]))[
        rank * {vper}:(rank + 1) * {vper}], rank * {vper},
    capacity={vcap}, normalize=False, **kw)
for pre, ix in (("ed", own), ("vec", vown)):
    for name in {arrays!r}:
        out["build_" + pre + "_" + name] = getattr(ix, name).numpy()
np.savez({outdir!r} + f"/rank{{rank}}.npz", **out)
dist.destroy_process_group()
"""


def _data(path):
    raw = random_walk(N, LEN, seed=61)
    rng = np.random.default_rng(29)
    qs = raw[rng.choice(N, Q, replace=False)] \
        + 0.05 * rng.standard_normal((Q, LEN)).astype(np.float32)
    vrng = np.random.default_rng(23)
    embs = vrng.standard_normal((VN, VDIM)).astype(np.float32)
    vqs = vrng.standard_normal((Q, VDIM)).astype(np.float32)
    np.savez(path, raw=raw, qs=qs, embs=embs, vqs=vqs)


def _ranks(world: int, tmp, inp, ref) -> list[dict]:
    """The port's S rank processes on one gloo group -> each rank's npz."""
    outdir = tmp / f"ranks{world}"
    outdir.mkdir()
    code = RANK.format(world=world, init=f"file://{outdir}/gloo_init",
                       inp=str(inp), ref=str(ref), outdir=str(outdir),
                       arrays=ARRAYS, fields=FIELDS, cap=CAP, vcap=VCAP,
                       vper=VN // world)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE,
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
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{world: (repro's npz, the port's rank npzs)}.  Each JAX compile of a
    shard_map search takes seconds here, so the cases run split over
    several reference subprocesses at once (``GROUPS``)."""
    tmp = tmp_path_factory.mktemp("dist")
    inp = tmp / "data.npz"
    _data(inp)
    jobs = [(w, g) for w in WORLDS for g in range(len(GROUPS))]
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNEL_MODE", "ref")
    try:
        with ThreadPoolExecutor(len(jobs)) as ex:
            futs = [ex.submit(run_subprocess, REFERENCE.format(
                inp=str(inp), out=str(tmp / f"ref{w}_{g}.npz"), world=w,
                cap=CAP, vcap=VCAP, arrays=ARRAYS, fields=FIELDS,
                cases=GROUPS[g]), w) for w, g in jobs]
            for f in futs:
                f.result()
    finally:
        mp.undo()
    refs = {w: {} for w in WORLDS}
    for w, g in jobs:
        refs[w].update(np.load(tmp / f"ref{w}_{g}.npz"))
    for w in WORLDS:
        np.savez(tmp / f"ref{w}.npz", **refs[w])
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        ranks = dict(zip(WORLDS, ex.map(
            lambda w: _ranks(w, tmp, inp, tmp / f"ref{w}.npz"), WORLDS)))
    return {w: (refs[w], ranks[w]) for w in WORLDS}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda s: f"S{s}")
def runs(request, all_runs):
    """(world, repro's npz, the port's rank npzs) at one world size."""
    return (request.param, *all_runs[request.param])


def _same(got: dict, want: dict, pre: str, wpre: str = None) -> None:
    wpre = pre if wpre is None else wpre
    assert np.array_equal(got[pre + "_idx"], want[wpre + "_idx"])
    g = got[pre + "_dist"].astype(np.float64)
    w = want[wpre + "_dist"].astype(np.float64)
    np.testing.assert_allclose(g ** 2, w ** 2, rtol=1e-5, atol=1e-4)
    for f in FIELDS:
        assert np.array_equal(got[pre + "_" + f], want[wpre + "_" + f]), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_sharded_matches_reference(runs, case):
    _, ref, ranks = runs
    _same(ranks[0], ref, case)
    assert ranks[0][case + "_idx"].shape == (Q, CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_holds_the_same_answer(runs, case):
    _, _, ranks = runs
    for r in ranks[1:]:
        for key in [case + "_dist", case + "_idx"] + [case + "_" + f
                                                      for f in FIELDS]:
            assert np.array_equal(r[key], ranks[0][key]), key


def test_sharded_search_bit_identical_to_noreuse_protocol(runs):
    """Round 2 resumed from round 1 answers bit for bit — dist, idx and
    stats — what round 2 recomputing ``engine.prepare`` answers."""
    _, _, ranks = runs
    for r in ranks:
        for key in ["_dist", "_idx"] + ["_" + f for f in FIELDS]:
            assert np.array_equal(r["ed_k5" + key], r["noreuse" + key]), key


def test_deadline_answer_is_no_better_than_exact(runs):
    _, _, ranks = runs
    r = ranks[0]
    assert (r["deadline_dist"] >= r["ed_k5_dist"] - 1e-5).all()


def test_build_sharded_matches_reference_shards(runs):
    """Each rank's own ``build_sharded`` over its rows equals repro's
    shard: global ids, bounds and envelopes equal, z-normed raw within
    rtol / atol 1e-6 (``tests/test_torch_index.py``'s bar)."""
    world, ref, ranks = runs
    for pre in ("ed", "vec"):
        for f in ARRAYS:
            axis = 1 if f in ("elo", "ehi") else 0
            got = np.concatenate([r[f"build_{pre}_{f}"] for r in ranks],
                                 axis=axis)
            want = ref[f"{pre}_{f}"]
            if f == "raw":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                assert np.array_equal(got, want), (pre, f)


def test_build_sharded_rejects_uneven_ranges(tmp_path):
    """A world-size-1 group: the range check runs on one rank's sizes."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        raw = random_walk(64, 32, seed=3)
        with pytest.raises(ValueError, match="rank order"):
            tdist.build_sharded(raw, 8, capacity=16, device="cpu")
        idx = tdist.build_sharded(raw, 0, capacity=16, device="cpu")
        assert sorted(idx.ids.flatten().tolist()) == list(range(64))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the out-of-core protocol over repro-written shards
# ---------------------------------------------------------------------------

OOC_N = 2048


@pytest.fixture(scope="module")
def ooc(tmp_path_factory):
    """Two repro-written shard files, the data and the queries
    (``tests/test_protocol.py``'s)."""
    raw = random_walk(OOC_N, LEN, seed=31)
    rng = np.random.default_rng(7)
    qs = raw[rng.choice(OOC_N, 5, replace=False)] \
        + 0.05 * rng.standard_normal((5, LEN)).astype(np.float32)
    base = tmp_path_factory.mktemp("ooc_protocol")
    half = OOC_N // 2
    paths = []
    for s in range(2):
        ids = jnp.arange(s * half, (s + 1) * half, dtype=jnp.int32)
        sidx = jcore.build(jnp.asarray(raw[s * half:(s + 1) * half]),
                           capacity=CAP, ids=ids)
        paths.append(base / f"shard{s}.dsix")
        jst.save_index(sidx, paths[-1])
    return raw, qs, paths


def _tsessions(paths, cache_blocks=8):
    return [tst.SearchSession(tst.open_index(p, device="cpu"),
                              cache_blocks=cache_blocks, device="cpu")
            for p in paths]


def _jsessions(paths, cache_blocks=8):
    return [jst.SearchSession(jst.open_index(p), cache_blocks=cache_blocks)
            for p in paths]


@pytest.mark.parametrize("k", (1, 5, 32))
def test_ooc_protocol_matches_reference(ooc, k):
    _, qs, paths = ooc
    ts, js = _tsessions(paths), _jsessions(paths)
    try:
        got = tdist.search_sharded_ooc(ts, torch.from_numpy(qs), k=k)
        want = jdist.search_sharded_ooc(js, jnp.asarray(qs), k=k)
    finally:
        for s in ts + js:
            s.close()
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.dist.numpy().astype(np.float64) ** 2,
                               np.asarray(want.dist).astype(np.float64) ** 2,
                               rtol=1e-5, atol=1e-4)
    for f in FIELDS:
        assert np.array_equal(getattr(got.stats, f).numpy(),
                              np.asarray(getattr(want.stats, f))), f
    assert got.io == want.io


class _Spy:
    """Count per-session cache reads and host-level refine dispatches."""

    def __init__(self, monkeypatch, sessions):
        self.gets = {i: [] for i in range(len(sessions))}
        self.refines = 0
        for i, s in enumerate(sessions):
            orig = s.cache.get
            monkeypatch.setattr(
                s.cache, "get",
                lambda b, _o=orig, _log=self.gets[i]: (_log.append(int(b)),
                                                       _o(b))[1])
        orig_step = tengine._cached_refine_step

        def counting_step(*a, **kw):
            self.refines += 1
            return orig_step(*a, **kw)

        monkeypatch.setattr(tengine, "_cached_refine_step", counting_step)


def test_ooc_no_block_refined_twice_per_protocol_run(ooc, monkeypatch):
    _, qs, paths = ooc
    sessions = _tsessions(paths)
    spy = _Spy(monkeypatch, sessions)
    try:
        res = tdist.search_sharded_ooc(sessions, torch.from_numpy(qs), k=5)
    finally:
        for s in sessions:
            s.close()
    total = 0
    for i, gets in spy.gets.items():
        assert np.bincount(gets).max() <= 1, f"shard {i} fetched twice"
        total += len(gets)
    assert spy.refines == total
    assert res.io.blocks_fetched + res.io.cache_hits == total


def test_ooc_round2_never_rereads_stage_a_blocks(ooc, monkeypatch):
    _, qs, paths = ooc
    q = torch.from_numpy(qs)
    sessions = _tsessions(paths)
    try:
        preps = [s.approximate_threshold(q, k=5) for s in sessions]
        thr = torch.from_numpy(np.minimum.reduce([p.threshold
                                                  for p in preps]))
        spy = _Spy(monkeypatch, sessions)        # round 2 only
        for s, p in zip(sessions, preps):
            s.search(q, k=5, initial_threshold=thr, prepared=p)
        for i, p in enumerate(preps):
            stage_a = set(p.state.refined)
            assert stage_a
            assert not stage_a & set(spy.gets[i])
    finally:
        for s in sessions:
            s.close()


def test_ooc_abandoned_round1_does_not_pollute_next_batch(ooc):
    raw, qs, paths = ooc
    rng = np.random.default_rng(41)
    other = torch.from_numpy(
        raw[rng.choice(OOC_N, 4, replace=False)]
        + 0.05 * rng.standard_normal((4, LEN)).astype(np.float32))
    (sess,), (ref,) = _tsessions(paths[:1]), _tsessions(paths[:1])
    with sess, ref:
        abandoned = sess.approximate_threshold(torch.from_numpy(qs), k=5)
        assert abandoned.carry_blocks > 0
        res = sess.search(other, k=5)
        want = ref.search(other, k=5)
        assert torch.equal(res.idx, want.idx)
        assert res.io.blocks_fetched + res.io.cache_hits \
            <= want.io.blocks_fetched
        assert res.io.bytes_read <= want.io.bytes_read
        assert sess.cache.disk_blocks \
            == res.io.blocks_fetched + abandoned.carry_blocks


def test_ooc_prepared_round_misuse_is_loud(ooc):
    _, qs, paths = ooc
    q = torch.from_numpy(qs)
    sess, other = _tsessions(paths)
    with sess, other:
        prep = sess.approximate_threshold(q, k=5)
        with pytest.raises(ValueError, match="different SearchSession"):
            other.search(q, k=5, prepared=prep)
        with pytest.raises(ValueError, match="k/metric"):
            sess.search(q, k=3, prepared=prep)
        with pytest.raises(ValueError, match="different query batch"):
            sess.search(q + 1.0, k=5, prepared=prep)
        sess.search(q, k=5, prepared=prep)       # the one valid consume
        with pytest.raises(ValueError, match="already consumed"):
            sess.search(q, k=5, prepared=prep)
    with pytest.raises(ValueError, match="at least one session"):
        tdist.search_sharded_ooc([], q)
