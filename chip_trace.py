#!/usr/bin/env python3
"""Where the time goes on the card: one profiled search batch, or one
profiled Hymba prefill and a few decode steps.

    python3 chip_trace.py [--seed 0] [--n-series 10000000] [--queries 100] [--k 10]
    python3 chip_trace.py --path flat [--seed 0] [--queries 100] [--k 10]
    python3 chip_trace.py --path dtw [--seed 0] [--dtw-queries 10] [--k 10]
    python3 chip_trace.py --path lm [--seed 0]
    python3 chip_trace.py --path ssm_bwd [--seed 0]
    python3 chip_trace.py --path mesh_decode [--seed 0]
    python3 chip_trace.py --path mesh_train [--arch hymba-1.5b]

``--path block_major`` (the default) builds the same index as
``chip_smoke.py`` (random-walk series generated on the card from
``--seed``, capacity 1024), runs one warm-up search and one timed search,
then traces one ``search_block_major`` with ``torch.profiler``.
``--path flat`` traces one ``search_paris`` batch (``lb_scan`` over the
block envelopes and then over every series, chunks of 4,096 through
``batch_l2`` and ``block_topk``) on that index.
``--path dtw`` does the same for ``chip_smoke.py``'s DTW batch: the
first ``--dtw-queries`` queries through ``dtw.search_dtw`` with its band
r.  ``--path lm`` builds ``hymba-1.5b`` ``full()`` and the prompts from
``--seed`` as ``chip_smoke.py`` does (4 of 2,048 tokens), serves one
warm-up batch, then traces the prefill and, separately, 8 greedy decode
steps.  Each trace prints one JSON line: the
wall time (host clock, synchronized) without and with the profiler, the
device's busy time (the sum of the device events' times in the trace)
and its share of the profiled wall time, the device events a step, and
the kernels that took the most device time, and each port kernel's
launches and summed device time (``port_kernels``).  ``--path ssm_bwd``
times ``ssm_scan_bwd`` alone on random operands from ``--seed`` at
Hymba's training shape (2, 1,152, 1,600, 16), train_4k's per-rank
shape (1, 4,224, 1,600, 16) and a 2x2 mesh training rank's (1, 1,152,
800, 16) (``chip_smoke.py``'s ``mesh`` phase: the rank's 800 channels),
and at the last also ``ssm_scan``'s training launch (the state kept
every 32 steps): CUDA events over 20 back-to-back calls, the profiler's
device time by each kernel a call launches and the least time
(``launch.roofline``'s bound), one JSON line a kernel and shape.
Copied beside another tree's ``src/`` (a parent unpacked by ``git
archive``, with this tree's ``chip_smoke.py``), it times that tree's
kernel in the same call.  ``--path mesh_decode`` serves
``chip_smoke.py``'s mesh run of hymba-1.5b (full width, MESH_SERVE_LAYERS
layers, 4 gloo ranks sharing the card at 2x2, ``greedy_generate(plan=)``)
with a host timer around every collective (``models.parallel``'s
``all_reduce`` / ``all_gather`` and ``torch.distributed``'s, which the
sharded decode calls directly): one JSON line with each rank's decode
ms a token, its collectives a decode step by kind, their count and
their host ms (each one's device-to-host copy, message and copy back).
``--path mesh_train`` runs ``chip_smoke.py``'s ``launch.train --mesh
2x2`` run of ``--arch`` (its MODEL_AXIS_RUNS entry: Hymba at full width
and 4 layers by default) under that script's checks, alone: one JSON
line with each rank's step seconds, peak memory, launches and gathered
leaves, each step's distance from one process's and the failed checks.
Copied beside a parent's tree, it runs that tree's ``chip_smoke.py``.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import (BWD_TRAIN_4K, CAPACITY, DTW_R,  # noqa: E402
                        FLAT_CHUNK, LENGTH, LM_BATCH, LM_PROMPT, SYMBOL,
                        device_ms_by_kernel, lm_setup, random_walk_cuda,
                        time_cuda)
from repro_torch import core  # noqa: E402
from repro_torch.core import dtw  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan_with_checkpoints)
from repro_torch.kernels.ssm_scan_bwd import ssm_scan_bwd  # noqa: E402
from repro_torch.launch import roofline, serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

LM_STEPS = 8          # decode steps traced
BWD_TRAIN = (2, 1152, 1600, 16)   # Hymba's training shape (hybrid_train)
BWD_MESH_RANK = (1, 1152, 800, 16)  # a 2x2 mesh training rank's (mesh)


def _device_events(prof):
    """Kernel and memcpy events of a trace, by name; their summed time."""
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    return events, busy_us, [{"name": e.key[:80], "count": e.count,
                              "device_ms": e.self_device_time_total / 1e3}
                             for e in top[:12]]


def _port_kernels(events) -> dict:
    """Each port kernel's launches and summed device time in a trace."""
    out = {}
    for name, symbol in SYMBOL.items():
        hits = [e for e in events if symbol in e.key]
        if hits:
            out[name] = {"launches": sum(e.count for e in hits),
                         "device_ms": sum(e.self_device_time_total
                                          for e in hits) / 1e3}
    return out


def trace_lm(args) -> int:
    """Profile one prefill and LM_STEPS decode steps of Hymba."""
    b, s_p, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    cfg, params, prompt = lm_setup(args.seed, b, s_p)
    serve.greedy_generate(params, cfg, prompt, 2)                # warm-up

    def fresh_cache():
        return transformer.init_cache(cfg, b, s_p + steps, dtype=torch.float32)

    def prefill_stage():
        cache = fresh_cache()
        return lambda: transformer.prefill(params, {"tokens": prompt}, cache,
                                           cfg)

    def decode_stage():
        logits, cache = transformer.prefill(params, {"tokens": prompt},
                                            fresh_cache(), cfg)
        tok0 = torch.argmax(logits[:, -1], dim=-1)[:, None]

        def run():
            tok = tok0
            for i in range(steps):
                out, _ = transformer.decode_step(params, tok, s_p + i, cache,
                                                 cfg)
                tok = torch.argmax(out[:, -1], dim=-1)[:, None]
        return run

    ok = True
    for stage, setup, n_steps in (("prefill", prefill_stage, 1),
                                  ("decode", decode_stage, steps)):
        run = setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        run = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events, busy_us, top = _device_events(prof)
        print(json.dumps({
            "phase": "trace", "path": "lm", "stage": stage,
            "device": torch.cuda.get_device_name(0), "arch": cfg.name,
            "batch": b, "prompt": s_p, "steps": n_steps,
            "wall_seconds_unprofiled": plain_wall, "wall_seconds": wall,
            "ms_per_step_unprofiled": plain_wall * 1e3 / n_steps,
            "device_busy_seconds": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_events_per_step": sum(e.count for e in events) / n_steps,
            "kernels": top, "port_kernels": _port_kernels(events)}),
            flush=True)
        ok &= busy_us > 0
    return 0 if ok else 1


def trace_search(args) -> int:
    """Profile one search batch of ``args.path`` on chip_smoke's index."""
    raw = random_walk_cuda(args.n_series, LENGTH, args.seed)
    queries = random_walk_cuda(args.queries, LENGTH, args.seed + 1)
    index = core.build(raw, capacity=CAPACITY)
    del raw
    if args.path == "dtw":
        queries = queries[:args.dtw_queries].contiguous()
        run = lambda: dtw.search_dtw(index, queries, r=DTW_R, k=args.k)
    elif args.path == "flat":
        run = lambda: core.search_paris(index, queries, k=args.k,
                                        chunk=FLAT_CHUNK)
    else:
        run = lambda: core.search_block_major(index, queries, k=args.k)
    run()                                                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    # device activity only: CPU-op events would multiply the trace's
    # post-processing time (minutes at ~10k walk trips)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events, busy_us, top = _device_events(prof)
    print(json.dumps({
        "phase": "trace", "path": args.path,
        "device": torch.cuda.get_device_name(0),
        "n_series": args.n_series, "queries": queries.shape[0], "k": args.k,
        **({"r": DTW_R} if args.path == "dtw" else {}),
        "iters": int(res.stats.iters), "wall_seconds_unprofiled": plain_wall,
        "wall_seconds": wall,
        "device_busy_seconds": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "port_kernels": _port_kernels(events),
        "kernels": top}), flush=True)
    return 0 if busy_us > 0 else 1


def time_ssm_bwd(args) -> int:
    """``ssm_scan_bwd`` alone at BWD_TRAIN, BWD_TRAIN_4K and
    BWD_MESH_RANK, and ``ssm_scan``'s training launch at the last."""
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device="cuda")
    for b, s, d, n in (BWD_TRAIN, BWD_TRAIN_4K, BWD_MESH_RANK):
        ops = (rnd(b, s, d) * 0.5, rnd(b, s, d).abs() * 0.1,
               rnd(b, s, n) * 0.5, rnd(b, s, n) * 0.5, -rnd(d, n).abs() - 0.1)
        _, _, ckpt = ssm_scan_with_checkpoints(*ops)
        dy = rnd(b, s, d) * 0.1
        calls = [("ssm_scan_bwd", lambda: ssm_scan_bwd(*ops, ckpt, dy),
                  roofline.ssm_bwd_bound(b, s, d, n, False))]
        if (b, s, d, n) == BWD_MESH_RANK:
            calls.append(("ssm_scan_with_checkpoints",
                          lambda: ssm_scan_with_checkpoints(*ops),
                          roofline.ssm_scan_work(b, s, d, n, False,
                                                 True).bound()))
        for name, call, bound in calls:
            by_kernel = device_ms_by_kernel(call)
            print(json.dumps({
                "phase": "time", "path": "ssm_bwd", "kernel": name,
                "tree": str(ROOT), "device": torch.cuda.get_device_name(0),
                "shape": [b, s, d, n], "ms": time_cuda(call),
                "device_ms": sum(by_kernel.values()),
                "device_ms_by_kernel": by_kernel, "bound_ms": bound[0],
                "bound_by": bound[1]}), flush=True)
    return 0


def _traced_serve_rank(rank: int, cfg_d: dict) -> None:
    """``chip_smoke._serve_rank`` on its first run (Hymba) with a host
    timer around every collective, split at the first decode step; the
    timings to ``cfg_d["out"]``."""
    import collections

    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.models import parallel
    st = {"phase": "prefill", "ms": collections.defaultdict(float),
          "n": collections.defaultdict(int), "steps": 0}

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                key = f"{st['phase']}/{name}"
                st["ms"][key] += (time.perf_counter() - t0) * 1e3
                st["n"][key] += 1
        return wrap

    for mod, name in ((parallel, "all_reduce"), (parallel, "all_gather"),
                      (dist, "all_reduce"), (dist, "all_gather")):
        setattr(mod, name, timed(f"{mod.__name__.split('.')[-1]}."
                                 f"{name}", getattr(mod, name)))
    step = transformer.decode_step

    def decode_step(*a, **k):
        st["phase"] = "decode"
        st["steps"] += 1
        return step(*a, **k)

    transformer.decode_step = decode_step
    runs = cs._serve_runs
    cs._serve_runs = lambda seed: runs(seed)[:1]
    cs._serve_rank(rank, cfg_d)
    (Path(cfg_d["out"]) / f"trace_r{rank}.json").write_text(json.dumps(st))


def trace_mesh_decode(args) -> int:
    """Host time in the collectives of a 2x2 serving rank's decode."""
    import shutil

    import chip_smoke as cs
    d, m = cs.MODEL_AXIS_MESH
    out = cs.MESH_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    try:
        cfg_d = {"seed": args.seed, "out": str(out),
                 "init": cs._group_init("trace_mesh"),
                 "device": str(cs._card())}
        if not cs._spawn_ranks(_traced_serve_rank, d * m, cfg_d,
                               cs.MESH_SERVE_TIMEOUT_S):
            return 1
        ranks = []
        for r in range(d * m):
            rep = json.loads((out / f"serve_r{r}.json").read_text())[0]
            st = json.loads((out / f"trace_r{r}.json").read_text())
            steps = st["steps"]
            dec = {k.split("/", 1)[1]: {"per_step": st["n"][k] / steps,
                                        "ms_per_step": v / steps}
                   for k, v in st["ms"].items() if k.startswith("decode/")}
            ranks.append({"rank": r, "ms_per_token": rep["ms_per_token"],
                          "prefill_s": rep["prefill_s"],
                          "decode_steps": steps, "decode": dec,
                          "prefill_ms": {k.split("/", 1)[1]: v for k, v
                                         in st["ms"].items()
                                         if k.startswith("prefill/")}})
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"phase": "trace", "path": "mesh_decode",
                      "device": torch.cuda.get_device_name(0),
                      "arch": cs.MESH_SERVE_ARCH,
                      "layers": cs.MESH_SERVE_LAYERS, "mesh": [d, m],
                      "ranks": ranks}), flush=True)
    return 0


def run_mesh_train(args) -> int:
    """chip_smoke's 2x2 training run of ``args.arch``, its checks kept."""
    import chip_smoke as cs
    run = [r for r in cs.MODEL_AXIS_RUNS if r[0] == args.arch]
    if not run:
        print(f"chip_trace: no 2x2 run of {args.arch}", file=sys.stderr)
        return 2
    cs.MESH_DIR.mkdir(parents=True, exist_ok=True)
    line, _ = cs._model_axis_finish(cs._model_axis_start(*run[0]))
    print(json.dumps({"phase": "time", "path": "mesh_train", "tree":
                      str(ROOT), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), **line,
                      "failures": cs.FAILURES}), flush=True)
    return 1 if cs.FAILURES else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--dtw-queries", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--path", choices=("block_major", "flat", "dtw", "lm",
                                       "ssm_bwd", "mesh_decode",
                                       "mesh_train"),
                    default="block_major")
    ap.add_argument("--arch", default="hymba-1.5b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_trace: no CUDA card available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.path == "lm":
        return trace_lm(args)
    if args.path == "ssm_bwd":
        return time_ssm_bwd(args)
    if args.path == "mesh_decode":
        return trace_mesh_decode(args)
    if args.path == "mesh_train":
        return run_mesh_train(args)
    return trace_search(args)


if __name__ == "__main__":
    sys.exit(main())
