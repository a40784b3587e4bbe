"""Dry run: count every (arch x shape) cell per rank of the port's own
layout, with its roofline on an H100; or measure one cell on the card.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles
each cell for a (16, 16) or (2, 16, 16) TPU mesh on 512 placeholder CPU
devices and reads the partitioned HLO.  Here a cell is counted as one
rank's step, on the meta device (no card, no memory), by
``launch.op_analysis``, its collectives on fake process groups of the
mesh's axes (``op_analysis.fake_group``).

``--mesh 16x16`` (the default) and ``2x16x16`` are the reference's
production meshes.  A train cell runs as ``launch.train --mesh DxM``
trains: the rank holds the shards of the parameters and the optimizer
state that the reference's specs give it (``specs.param_pspecs``),
runs its tensor- and expert-parallel blocks and its vocabulary blocks
over a fake model group of M and gathers its other sharded leaves over
the model and data groups (``models.parallel``).  A prefill or decode cell runs as
``launch.serve.greedy_generate(plan=)`` serves: the same shards of the
parameters, a serving plan (Mamba by channel, RWKV by head besides),
the rank's rows of the batch and its blocks of every cache by the
reference's ``cache_pspecs``, a decode cell's full-attention positions
over the fake model group or the fake data group where
``kv_shard_axes`` puts them.  ``--mesh Dx1`` (``16x1``, and
``32x1`` for the two-pod row) is the data-parallel layout: each rank
holds the whole model (an ``fsdp`` config's train cell its FSDP shards)
and its share of the batch and caches, and a decode batch that does not
split over the ranks (long_500k's one sequence) splits its
full-attention caches' positions over them (``decode_step(kv_shard=)``),
the gradient all-reduce and the sharded decode's two all-reduces on a
fake group of D ranks.  A decode cell is counted at its last position
(Whisper: its decoder's).  Every record carries ``params_per_rank``,
the parameter elements one rank holds.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
        --shape decode_32k [--mesh 16x16] [--out f.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
        --shape decode_32k --measure [--seed 0]     # on the card

``--measure`` runs the cell for real on the card (and raises without
one; it takes a ``Dx1`` mesh, one rank of which one card can run): one rank's step at its per-rank shapes, in the dtypes the count
assumed, random weights from ``--seed``; one warm-up step, then the
median of three timed by CUDA events (a warm-up of 30 s or more is the
measurement itself, once), the peak memory beside the
predicted one, ``ops.launch_counts()`` of one step beside the counted
kernel calls, and the roofline share, max(compute, memory) over the
measured seconds (one rank moves no collective).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs
from repro_torch.models import common, parallel
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

META = torch.device("meta")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MEASURE_STEPS = 3
# a first step this long is the measurement: Hymba's prefill_32k (~50 s),
# not a warm-up (a train_4k step's first: 8–14 s)
ONCE_S = 30.0
CARD = "cuda"                 # where --measure runs
FREE_SHARE = 0.8              # a measured cell's predicted peak, of free


def parse_mesh(text: str) -> mesh_lib.MeshSpec:
    """"DxM" -> a ("data", "model") mesh, "PxDxM" -> ("pod", "data",
    "model"); every size at least 1.  "Dx1" is the data axis alone."""
    try:
        sizes = tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {text!r}")
    if sizes[-1] == 1 and len(sizes) == 2:
        return mesh_lib.MeshSpec(sizes[:1], ("data",))
    return mesh_lib.MeshSpec(sizes, ("pod", "data", "model")[-len(sizes):])


def _model_size(spec: mesh_lib.MeshSpec) -> int:
    return mesh_lib.axis_sizes(spec).get("model", 1)


@dataclasses.dataclass
class RankCell:
    """One rank's step of a cell and its arguments."""
    cfg: object
    kind: str
    fn: object
    args: tuple
    ranks: int
    shards: dict
    dtype: torch.dtype
    params_per_rank: int
    plan: object = None


def rank_cell(arch: str, shape: str, mesh: str = "16x1", *,
              alone: bool = False) -> RankCell:
    """The meta-device step and arguments of one rank of ``shape`` on
    ``mesh``, its collectives on a fake group of the mesh's ranks; with
    ``alone``, the step one rank takes by itself (no gradient
    all-reduce), which a cell whose caches split over the ranks has
    not."""
    cfg = get_config(arch)
    spec = parse_mesh(mesh)
    d = spec.size
    act = DTYPES[cfg.param_dtype]
    cell = specs.build_cell(cfg, shape, spec, act_dtype=act)
    sh = cell.shards
    state = specs.state_shard_shapes(cfg, spec)
    held = specs.held_elements(state["params"])
    m = _model_size(spec)
    nd = d // m
    # an ssm or enc_dec model has no full-attention cache to split: a
    # batch that does not split over the ranks runs whole on each
    kv_split = bool(cell.kv_shard_axes) and not (cfg.enc_dec
                                                 or cfg.family == "ssm")
    if alone and kv_split:
        raise ValueError(f"{arch} {shape}: its caches split their positions "
                         "over the ranks; one rank cannot step alone")
    group = op_analysis.fake_group(d) if d > 1 and not alone else None
    meta = lambda shp, like: torch.empty(shp, dtype=like.dtype, device=META)
    params = cell.args[0]
    p_specs = specs.param_pspecs(cfg, spec)
    plan = None
    # a train cell holds its shards on any mesh (FSDP's over the data
    # axes too), a serving cell on a mesh with a model axis
    if not alone and (m > 1 or cell.kind == "train") and any(
            e is not None for _, sp in common.leaves(p_specs) for e in sp):
        # this rank's shards, on fake groups of the model axis and of the
        # data axes together
        plan = parallel.Plan(
            cfg, p_specs,
            model=op_analysis.fake_group(m, "model") if m > 1 else None,
            data=op_analysis.fake_group(nd, "data") if nd > 1 else None,
            mesh=spec,
            coords=dict.fromkeys(spec.axis_names, 0))
        whole = dict(common.leaves(params))
        params = common.with_leaves(params, {
            p: meta(s, whole[p]) for p, s in common.leaves(state["params"])})
    if cell.kind == "train":
        _, opt, batch = cell.args
        if plan is not None:
            opt = opt_lib.opt_init(cfg.optimizer, params)
        fn = step_lib.make_train_step(cfg, group=group, plan=plan,
                                      device=META)
        args = (params, opt, {k: meta(sh["batch"][k], v)
                              for k, v in batch.items()})
    else:
        caches = [{k: meta(s_c[k], v) for k, v in seg.items()}
                  for seg, s_c in zip(specs.cache_shapes(
                      cfg, 1, SHAPES[shape].seq_len, act), sh["cache"])]
        if cell.kind == "prefill":
            batch = cell.args[1]
            fn = step_lib.make_prefill_step(cfg, plan=plan, device=META)
            args = (params, {k: meta(sh["batch"][k], v)
                             for k, v in batch.items()}, caches)
        else:
            tokens = cell.args[1]
            kv = None
            if kv_split and m == 1:
                kv = group
            elif kv_split:         # positions over "model" or the data axes
                kv = plan.model if "model" in cell.kv_shard_axes \
                    else plan.data
            fn = step_lib.make_serve_step(cfg, kv_shard=kv, plan=plan,
                                          device=META)
            last = (cfg.decoder_len if cfg.enc_dec
                    else SHAPES[shape].seq_len) - 1
            args = (params, meta(sh["tokens"], tokens), last, caches)
    return RankCell(cfg, cell.kind, fn, args, d, sh, act, held, plan)


def run_cell(arch: str, shape: str, mesh: str = "16x1", *,
             alone: bool = False, verbose: bool = True) -> dict:
    """Count one rank's step of a cell (``alone``: as it steps by
    itself); return its dry-run record."""
    t0 = time.perf_counter()
    rc = rank_cell(arch, shape, mesh, alone=alone)
    totals = op_analysis.count(rc.fn, *rc.args)
    count_s = time.perf_counter() - t0
    roof = rl.analyze(totals, n_ranks=rc.ranks,
                      model_flops=rl.model_flops_for(rc.cfg, shape))
    rec = {
        "arch": arch, "shape": shape, "kind": rc.kind, "mesh": mesh,
        "chips": rc.ranks, "status": "ok",
        "params_per_rank": rc.params_per_rank,
        **(rc.plan.counts() if rc.plan is not None else {}),
        "dtype": str(rc.dtype).removeprefix("torch."),
        "count_s": count_s, "shards": rc.shards,
        "bytes_per_device": {"argument": totals.arg_bytes,
                             "peak": totals.peak_bytes},
        "dot_flops_by_dtype": totals.dot_by_dtype,
        "kernel_calls": totals.kernel_calls,
        "kernels": totals.kernels, "ops": totals.n_ops,
        **roof.table_row(),
    }
    if verbose:
        print(f"[ok] {arch:22s} {shape:12s} mesh={mesh:5s} "
              f"peak={totals.peak_bytes / 2**30:.2f}GiB "
              f"flops/dev={roof.flops:.3e} "
              f"compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms "
              f"coll={roof.collective_s * 1e3:.2f}ms "
              f"-> {roof.bottleneck} useful={roof.useful_ratio:.2f} "
              f"kernels={totals.kernel_calls} ({count_s:.1f}s)", flush=True)
    return rec


# ---------------------------------------------------------------------------
# Measuring a cell on the card
# ---------------------------------------------------------------------------


def _real(t: torch.Tensor, gen: torch.Generator, vocab: int) -> torch.Tensor:
    """A tensor on the card like the meta ``t``: tokens drawn below
    ``vocab``, activations normal, caches zero."""
    dev = gen.device
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, vocab, tuple(t.shape), generator=gen,
                             device=dev, dtype=t.dtype)
    return torch.randn(tuple(t.shape), generator=gen, device=dev
                       ).to(t.dtype)


def _real_args(rc: RankCell, seed: int):
    """The step's arguments on the card: the parameters from ``seed``
    (``launch.serve.build_params``, its normal leaves cast as
    ``specs.param_shapes`` casts them), the optimizer's state, random
    tokens and activations, zero caches."""
    from repro_torch.launch.serve import build_params
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt_lib
    dev = torch.device(CARD)
    params = build_params(rc.cfg, seed, dev)
    shapes = dict(common.leaves(rc.args[0]))
    params = common.with_leaves(params, {
        p: t.to(shapes[p].dtype) for p, t in common.leaves(params)})
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    vocab = rc.cfg.vocab
    real = lambda tree: {k: _real(v, gen, vocab) for k, v in tree.items()}
    zeros = lambda caches: [{k: torch.zeros(tuple(v.shape), dtype=v.dtype,
                                            device=dev)
                             for k, v in seg.items()} for seg in caches]
    if rc.kind == "train":
        return (params, opt_lib.opt_init(rc.cfg.optimizer, params),
                real(rc.args[2]))
    if rc.kind == "prefill":
        return params, real(rc.args[1]), zeros(rc.args[2])
    return (params, _real(rc.args[1], gen, vocab), rc.args[2],
            zeros(rc.args[3]))


def measure_cell(arch: str, shape: str, mesh: str = "16x1", *,
                 seed: int = 0) -> dict:
    """Run one rank's step of a cell on the card against the count of
    the same step (``run_cell(..., alone=True)``): median seconds of
    MEASURE_STEPS after a warm-up (or the warm-up alone, if it takes
    ONCE_S or more), peak memory, launches, the roofline
    share.  A cell whose predicted peak exceeds FREE_SHARE of the card's
    free memory is returned as skipped, with that figure."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    if _model_size(parse_mesh(mesh)) > 1:
        raise ValueError(f"--measure runs one rank of a Dx1 mesh, got "
                         f"{mesh}: a rank of a mesh with a model axis needs "
                         "its M - 1 partners")
    dev = resolve_device(CARD)                   # raises without a card
    rec = run_cell(arch, shape, mesh, alone=True, verbose=False)
    rc = rank_cell(arch, shape, mesh, alone=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    predicted = rec["bytes_per_device"]["peak"]
    out = {"arch": arch, "shape": shape, "mesh": mesh, "dtype": rec["dtype"],
           "predicted_peak_bytes": predicted, "free_bytes": free,
           "device": torch.cuda.get_device_name(0)}
    if predicted > FREE_SHARE * free:
        return {**out, "status": f"skipped: predicted peak {predicted} B > "
                                 f"{FREE_SHARE} x {free} B free"}
    if rc.kind == "train":
        fn = step_lib.make_train_step(rc.cfg, device=dev)
    elif rc.kind == "prefill":
        fn = step_lib.make_prefill_step(rc.cfg, device=dev)
    else:
        fn = step_lib.make_serve_step(rc.cfg, device=dev)
    args = _real_args(rc, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def timed() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    first_s = timed()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    # a step of ONCE_S or more (Hymba's prefill_32k: 2.76M launches) is
    # timed once: what a warm-up pays once is lost in it
    times = [first_s] if first_s >= ONCE_S else \
        [timed() for _ in range(MEASURE_STEPS)]
    seconds = statistics.median(times)
    least = max(rec["compute_s"], rec["memory_s"])
    counted = rec["kernel_calls"]
    del args
    torch.cuda.empty_cache()
    return {**out, "status": "ok", "count_s": rec["count_s"],
            "seconds": seconds, "steps_s": times,
            "first_step_s": first_s, "measured_peak_bytes": peak,
            "launches": launches, "counted_calls": counted,
            "launches_match": launches == counted,
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "roofline_s": least, "bottleneck": rec["bottleneck"],
            "roofline_share": least / seconds}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cell_record(cell: tuple, measure: bool, seed: int) -> dict:
    """One cell's record (``measure``: with its run on the card), or its
    failure."""
    arch, shape, mesh = cell
    try:
        rec = run_cell(arch, shape, mesh)
        if measure:
            rec["measured"] = measure_cell(arch, shape, mesh, seed=seed)
            print(json.dumps({"measured": rec["measured"]}), flush=True)
        return rec
    except Exception as e:                       # noqa: BLE001
        print(f"[FAIL] {arch} {shape} mesh={mesh}: {e}\n"
              f"{traceback.format_exc()}", flush=True)
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": f"FAIL: {type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="16x16",
                    help="DxM or PxDxM (default 16x16, the reference's "
                         "production mesh); Dx1: D data-parallel ranks")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--measure", action="store_true",
                    help="also run each cell on the card (one rank's step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=None,
                    help="arch:shape:DxM,... in place of --arch, --shape "
                         "and --mesh")
    args = ap.parse_args(argv)

    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(arch, shape, args.mesh)
                 for arch in ([args.arch] if args.arch else list_archs())
                 for shape in ([args.shape] if args.shape else
                               specs.runnable_shapes(get_config(arch)))]
    records, failures = [], []
    t0 = time.perf_counter()
    for cell in cells:
        rec = _cell_record(cell, args.measure, args.seed)
        if rec["status"].startswith("FAIL"):
            failures.append(rec)
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    counted = sum(r["status"] == "ok" for r in records)
    print(f"\n{counted}/{len(records)} cells counted, "
          f"{len(failures)} failed in {time.perf_counter() - t0:.1f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
