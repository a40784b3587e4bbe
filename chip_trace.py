#!/usr/bin/env python3
"""Where a query batch's time goes on the card: one profiled search.

    python3 chip_trace.py [--seed 0] [--n-series 10000000] [--queries 100] [--k 10]

Builds the same index as ``chip_smoke.py`` (random-walk series generated
on the card from ``--seed``, capacity 1024), runs one warm-up search and
one timed search, then traces one ``search_block_major`` with
``torch.profiler`` and prints one JSON line: the batch's wall time (host
clock, synchronized) without and with the profiler, the device's busy
time (the sum of the device events' times in the trace) and its share of
the profiled wall time, and the kernels that took the most device time.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import CAPACITY, LENGTH, random_walk_cuda  # noqa: E402
from repro_torch import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_trace: no CUDA card available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    raw = random_walk_cuda(args.n_series, LENGTH, args.seed)
    queries = random_walk_cuda(args.queries, LENGTH, args.seed + 1)
    index = core.build(raw, capacity=CAPACITY)
    del raw
    core.search_block_major(index, queries, k=args.k)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.search_block_major(index, queries, k=args.k)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    # device activity only: CPU-op events would multiply the trace's
    # post-processing time (minutes at ~10k walk trips)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = core.search_block_major(index, queries, k=args.k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]          # kernels, memcpys
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({
        "phase": "trace", "device": torch.cuda.get_device_name(0),
        "n_series": args.n_series, "queries": args.queries, "k": args.k,
        "iters": int(res.stats.iters), "wall_seconds_unprofiled": plain_wall,
        "wall_seconds": wall,
        "device_busy_seconds": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernels": [{"name": e.key[:80], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top[:12]]}), flush=True)
    return 0 if busy_us > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
