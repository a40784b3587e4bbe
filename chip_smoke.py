#!/usr/bin/env python3
"""Drive and check the port's search paths, its distributed protocol,
search serving, LM serving (Hymba and the dense family) and dense
training on one card.

    python3 chip_smoke.py [--seed 0] [--n-series 10000000] [--queries 100]
                          [--dtw-queries 10] [--lm-batch 4]
                          [--lm-prompt 2048] [--lm-gen 32] [--lm-smoke]
                          [--ooc-series N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each printing one JSON line:

  1. device    — the card's name and count, and nvidia-smi's name and
                 power limit; fails without a card;
  2. build     — builds the seven CUDA kernels from
                 ``src/repro_torch/kernels/csrc`` (build seconds, ptxas
                 registers / shared memory / spills);
  3. main      — the main path through the user's entry points:
                 ``core.build`` over random-walk series generated on the
                 card from ``--seed`` (the paper's Synthetic recipe), then
                 ``core.search_block_major`` for k=1 and k=10 on
                 ``--queries`` random-walk queries from ``--seed + 1``;
  4. schedules — the same index and queries through ``core.search``
                 (query-major) and ``core.search_paris`` (the flat ParIS
                 scan, chunk 4096), k=1 and k=10;
  5. ucr       — ``core.search_scan`` (the brute-force UCR scan) over the
                 raw array, k=10;
  6. dtw       — ``dtw.search_dtw`` (r=12, about 5% of the length) on the
                 first ``--dtw-queries`` queries, k=1 and k=10, checked
                 against a banded-DTW scan of every series (the
                 ``dtw_band_panel`` kernel on shared chunks, merged with
                 the plain ``topk_by_dist_id``);
  7. lm        — Hymba serving (``hymba-1.5b``, full width and depth,
                 fp32 weights from ``--seed``): ``--lm-batch`` requests of
                 ``--lm-prompt`` random tokens (from ``--seed + 2``) through
                 ``launch.serve.greedy_generate`` (prefill, then greedy
                 decode to ``--lm-gen`` tokens), checked against the
                 teacher-forced ``forward`` over prompt and generated
                 tokens, and layer 0's Mamba mixer (the ``ssm_scan``
                 kernel) against the plain ``mamba_naive`` on its real
                 input;
  8. dense     — dense serving at full width through the same entry points,
                 fp32 weights from ``--seed``: ``h2o-danube-1.8b`` (24
                 layers, SWA 4,096), 4 requests x 4,608 tokens (the
                 prefill rolls the ring, decode wraps it) + 32 greedy;
                 then ``gemma3-27b``'s widths cut to 6 layers (one 5:1
                 local:global period: qk-norm, sqrt(d) embedding scale,
                 tied embeddings, a global layer's full cache beside SWA
                 rings), 2 x 1,536 + 16; each checked against the
                 teacher-forced ``forward`` under ``lm``'s rule; no
                 custom kernel is on this path (0 launches, checked);
  9. train     — the serving weights freed, ``h2o-danube-1.8b`` ``full()``
                 trained with fp32 AdamW (``train.make_train_step``), 4
                 steps of B = 2 x S = 1,024 on one batch of
                 ``data.tokens`` from ``--seed``: every loss and gradient
                 norm finite, no step skipped, the last loss below the
                 first, step 1's loss ``make_eval_step``'s at the initial
                 parameters within 1e-5 relative; the step's median
                 seconds over steps 2-4, tokens/s, 6·N·tokens beside the
                 fp32 peak; one ``smoke()`` step on the card against the
                 CPU from the same parameters and batch (loss and gradient
                 norm within 1e-4 relative); and ``python -m
                 repro_torch.examples.train_lm --steps 40`` as a
                 subprocess (exit 0, a ``[resume]`` line, the resumed
                 run's last loss below the first run's first);
 10. kernels   — each kernel against its plain PyTorch version on the
                 card, at its paths' shapes and on their data, with the
                 stated tolerance, and timed beside its plain version, a
                 library call where one exists, and its bound (the larger
                 of bytes at the memory rate and operations at the rate of
                 the unit that does them, named in ``bound_unit``: fp32,
                 fp64, TF32 tensor cores, or the exps' special-function
                 units at an assumed 1.98 GHz): ``ms`` is
                 CUDA events around back-to-back calls (the wrapper's host
                 time included where it is the longer), ``device_ms`` the
                 kernel's own device time from the profiler over the same
                 calls; ``fused_panel_topk`` is timed at the walk's first
                 block and at a late block with few live lanes;
                 ``block_topk`` bitwise and timed on the panels the walks
                 hand it (stage A (100, 1024), the first flat chunk and
                 query-major trip (100, 4096), the first DTW trip
                 (10, 2048)) at k = 1 and 10, and bitwise on +-0 ties and
                 all-pad rows; ``batch_l2`` at the first flat chunk,
                 Q = 1 and 13; both beside their library call's own
                 device time (``library_device_ms``); ``isax_summarize``
                 bitwise in both normalize modes on 1M series;
                 ``lb_scan`` at every shape the paths give it (``cases``:
                 the flat scan over every series, the block envelopes,
                 DTW's two passes against +-SENTINEL planes), each checked
                 over every column (the plain version in column chunks),
                 and untimed at the serving walks' envelope shapes
                 (``envelope_slices``: Q = 1, 4, 16, 25 over the 10M
                 index's blocks, Q = 4, 16 over the sanitize index's,
                 Q = 100 over a dist4 shard's);
                 ``fused_panel_topk`` also checked, untimed, at those
                 batch sizes (first and late block, k = 1 and 10);
                 its phase line gives each case an issue floor
                 (``issue_floor_ms``, worked out, not measured) beside its
                 byte bound;
                 ``ssm_scan`` at layer 0's prefill, one decode step from
                 its state, and a state size that is no power of two
                 (N = 12 over 512 steps);
 11. exact     — every Euclidean path's answers (block-major, query-major,
                 flat, UCR) against a brute-force scan of every series with
                 the plain ``batch_l2_ref`` + ``topk_by_dist_id``;
 12. ooc       — the on-disk index over the same series (``--ooc-series``,
                 all by default, cut in whole millions until the files fit
                 in half the free disk, under the git-ignored
                 ``build/ooc/``, removed at the end): the series written as
                 a headerless f32 ``storage.SeriesStore``; the staged build
                 (``storage.run_pipeline``, capacity 1024, 4 shards, 2
                 workers: seconds and units by stage, file bytes, digest
                 seconds); the file's ids/slo/shi/elo/ehi and raw bitwise
                 equal to ``core.build``'s index; ``storage.ooc_search``
                 with k=1 and 10 from the disk (the index file's page
                 cache dropped before each batch) at (pipeline_depth,
                 group_blocks) = (1, 1) and (4, 8): ids against
                 block-major's and UCR's under ``exact``'s rule, squared
                 distances within 1e-5 of block-major's, the two settings
                 bitwise equal, with ``IOStats`` and the walk's telemetry;
                 a warm repeat through a ``storage.SearchSession`` holding
                 every block (bitwise equal, 0 bytes read); DTW (r=12,
                 k=10) on the ``--dtw-queries`` through that session, ids
                 against ``dtw``'s;
 13. dist1     — ``distributed.search_sharded`` (k=10) over the main index
                 on a world-size-1 NCCL group: bitwise ``main``'s
                 block-major answer and counters;
 14. serve     — on the ooc phase's index file: 4 tenant threads x 25
                 queries (members of one random block plus 0.05 noise,
                 from ``--seed``), k=10, through one coalesced
                 ``SearchSession`` drain, each tenant bitwise its isolated
                 ``search``, the drain's disk blocks beside the isolated
                 runs'; ``search(deadline_blocks=8)``, its certificate
                 bracketing the exact k-th distance, ``refine_to_exact``
                 bitwise the exact answer; and ``python -m
                 repro_torch.launch.serve --search-index`` once, as a
                 subprocess (4 queries a tenant, k=1);
 15. analysis  — the port's static checkers (``repro_torch.analysis``:
                 lock discipline, host syncs, kernel/oracle contracts) over
                 ``src/repro_torch``, in process: any finding fails; the
                 annotated ``# sync`` sites of ``core/engine.py`` grouped by
                 the frequency their comments state;
 16. sanitize  — the first 1M series of the ooc phase's file built here by
                 ``storage.run_pipeline``; then a subprocess with
                 ``REPRO_SANITIZE=1``: the session's and cache's locks
                 instrumented, an off-lock write to a guarded field raising
                 ``SanitizeError``, the same build bitwise the unsanitized
                 file, 4 tenants x 4 near-data queries at k=10 on the
                 phase's 1M-series index isolated and through one drain
                 from 4 threads (bitwise, no ``SanitizeError``); the
                 drained ids against the brute-force scan of those
                 series.  The script refuses to run at all
                 with ``REPRO_SANITIZE`` set in its own environment: its
                 timed phases would measure the instrumented locks;
 17. dist4     — the main process frees its tensors, then 4 ranks spawned
                 on the card over gloo (a ``file://`` store under
                 ``build/``): each reads its quarter of the series file,
                 ``distributed.build_sharded`` with global ids,
                 ``search_sharded`` block-major k=1 and 10, query-major
                 k=10, ``search_sharded_scan`` k=10 (each between
                 barriers), saves its shard; ids against the brute-force
                 scan, every rank the same answer, per-rank build seconds
                 and peak device memory, launches summed over ranks; a
                 rank that fails or a collective past its timeout fails
                 the run;
 18. dist_ooc  — ``distributed.search_sharded_ooc`` over 4 sessions on
                 dist4's shard files from a cold disk, k=10: ids against
                 the brute-force scan, the summed ``IOStats``.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after, and fails if a kernel of that path was not
launched.  Then the run's seconds, nvidia-smi's line, the
``{"kernels": [...]}`` line and, if every check passed,
``{"ok": true, "device": {...}}`` as the last line.  Any failed check
exits non-zero.  TF32 is off for every fp32 product.
"""
from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import core, storage  # noqa: E402
from repro_torch.core import (distributed, dtw, engine, frontier,  # noqa: E402
                              isax)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.batch_l2 import batch_l2  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402
from repro_torch.kernels.dtw_band import dtw_band_panel  # noqa: E402
from repro_torch.kernels.fused_refine import fused_panel_topk  # noqa: E402
from repro_torch.kernels.isax_summarize import isax_summarize  # noqa: E402
from repro_torch.kernels.lb_scan import lb_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.configs import count_params, get_config  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batches  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common, mamba, transformer  # noqa: E402
from repro_torch.train import (make_eval_step, make_train_step,  # noqa: E402
                               opt_init)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# (operations a second, the unit a bound names) of the H100 SXM's units
FP32 = (67e12, "fp32 operations at 67 TFLOP/s")   # outside the tensor cores
TF32 = (495e12, "dense TF32 tensor-core operations at 495 TFLOP/s")
FP64 = (34e12, "fp64 operations at 34 TFLOP/s")   # outside the tensor cores
SM_CLOCK_HZ = 1.98e9           # assumed for the SFU rate: the maximum SM clock
SFU = (16 * 132 * SM_CLOCK_HZ,  # 16 exps a clock on each of 132 SMs
       "exps on the special-function units, 16 a clock an SM at 1.98 GHz")
LB_RTOL = 1e-5                 # 16 non-negative terms summed in another order
LB_PLAIN_CHUNK = 131_072       # columns of a chunk of the plain lb_scan
# lb_scan's issue floor: the fp32 arithmetic a (q, j, s) term of the
# kernel (two FMNMX, one FADD, one FFMA; loads and the loop not counted),
# at one warp instruction a clock on each of the 528 schedulers (132 SMs x
# 4) at the assumed clock
LB_INSTR_PER_TERM = 4
INSTR_RATE = 132 * 4 * 32 * SM_CLOCK_HZ   # thread instructions a second
DIST_REL = 1e-5                # squared-L2 tolerance: DIST_REL * (||q||^2 + ||x||^2)
LENGTH = 256                   # points per series (the paper's Synthetic)
CAPACITY = 1024                # series per block
SUMMARIZE_SLICE = 1_000_000    # series the summarize kernel is checked on
FLAT_CHUNK = 4096              # the flat scan's refinement chunk
DTW_R = 12                     # Sakoe-Chiba band, ~5% of the length
QUERY_MAJOR_BLOCKS = 4         # blocks a query a query-major trip (core.search)
DTW_BLOCKS = 2                 # blocks a query a DTW trip (dtw.search_dtw)
SCAN_CHUNK = 1 << 20           # series per step of the brute-force scans
LM_ARCH = "hymba-1.5b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32   # requests, tokens each, generated
LOGIT_REL = 1e-3               # serving vs forward: |dlogit| <= LOGIT_REL * max |logit|
MIX_TOL = 1e-3                 # mixer vs mamba_naive, rtol and atol
SSM_REL = 1e-4                 # ssm_scan vs ssm_scan_ref: SSM_REL * (|ref| + max |ref|)
SSM_ODD_N, SSM_ODD_STEPS = 12, 512   # the scan's case at a state size no power of two
# dense serving: (arch, layers or None for all, requests, prompt, generated)
DENSE_RUNS = (("h2o-danube-1.8b", None, 4, 4608, 32),
              ("gemma3-27b", 6, 2, 1536, 16))   # depth cut: one 5:1 period
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 4
# the rate from step 1 on (no warmup): AdamW's first steps move every
# weight by about lr, and at 1e-4 the loss of this one batch rose again
# at step 3
TRAIN_LR, TRAIN_WARMUP = 1e-5, 1
EVAL_REL = 1e-5                # step 1's loss vs make_eval_step's, relative
CARD_CPU_REL = 1e-4            # a smoke() step, card vs CPU: loss, grad norm
EXAMPLE_TIMEOUT_S = 600        # the train_lm example's subprocess

OOC_DIR = ROOT / "build" / "ooc"   # git-ignored; removed at the phase's end
# bytes on disk a series of 256 points: the series file (1,024), the index
# file (1,024 raw + 128 bounds + 4 id), the runs (56), the merge (40) and
# dist4's shard files (1,156, as the index file)
OOC_BYTES_PER_SERIES = 1024 + 1156 + 56 + 40 + 1156
OOC_SHARDS, OOC_WORKERS = 4, 2     # the build's pass-1 shards, its threads
OOC_CACHE_BLOCKS = 64              # the one-shot walk's block cache
OOC_SETTINGS = ((1, 1), (4, 8))    # (pipeline_depth, group_blocks)
OOC_COMPARE_BLOCKS = 256           # blocks a step of the raw comparison
DIST_WORLD = 4                     # dist4's ranks, all on the one card
DIST1_BACKEND = "nccl"             # dist1's world-size-1 group
DIST_TIMEOUT_S = 300               # a collective's (or a tenant's) limit
DIST_RANKS_TIMEOUT_S = 600         # dist4's ranks, spawn to exit
SERVE_TENANTS, SERVE_BATCH, SERVE_K = 4, 25, 10   # launch.serve's traffic
SANITIZE_ROWS = 1_000_000          # the sanitize phase's build and walks
SANITIZE_TENANTS, SANITIZE_BATCH = 4, 4
SERVE_DEADLINE = 8                 # the anytime answer's refine budget
SERVE_CLI_K = 1                    # the CLI's k: its near-data queries prune
WALK_PIPELINE = OOC_SETTINGS[1]    # serve's and dist_ooc's (depth, group)

# the kernels each search path must launch (the build's isax_summarize
# is checked on its own)
PATH_KERNELS = {
    "block_major": ("lb_scan", "block_topk", "fused_panel_topk"),
    "query_major": ("lb_scan", "block_topk"),
    "flat": ("lb_scan", "block_topk", "batch_l2"),
    "ucr": ("batch_l2",),
    "dtw": ("lb_scan", "block_topk", "dtw_band_panel"),
    "lm": ("ssm_scan",),
}

# the substring of each kernel's symbol the profiler's device events carry
SYMBOL = {"isax_summarize": "isax_summarize", "lb_scan": "lb_scan",
          "block_topk": "block_topk", "fused_panel_topk": "fused_panel_topk",
          "batch_l2": "batch_l2", "dtw_band_panel": "dtw_band",
          "ssm_scan": "ssm_scan"}

FAILURES: list[str] = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return ok


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(fn, reps: int, warmup: int) -> list:
    """The device events of ``reps`` back-to-back calls of ``fn`` under
    ``torch.profiler`` (CUDA activity only).  The profiler now and then
    records no device event at all in a window; such a window is taken
    again, up to three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


def device_ms(fn, symbol: str, reps: int = 20, warmup: int = 3) -> float:
    """The kernel's own device milliseconds per launch: ``torch.profiler``
    over the same back-to-back calls ``time_cuda`` runs, summed over the
    device events whose name holds ``symbol``, over their count.  Host time
    between launches is not in it."""
    hits = [e for e in _profiled(fn, reps, warmup) if symbol in e.key]
    count = sum(e.count for e in hits)
    # the profiler may drop a launch at the start of its window: the mean
    # is over the launches it saw
    if not check(0 < count <= reps, f"profiler saw {count} launches of "
                                    f"{symbol} in {reps} calls"):
        return float("nan")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def device_ms_all(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``, summed over every device
    event it launches (a library call may launch several kernels), over
    the same back-to-back calls."""
    total = sum(e.self_device_time_total
                for e in _profiled(fn, reps, warmup))
    check(total > 0, "the profiler saw device time of a library call")
    return total / reps / 1e3


def bound(nbytes: float, ops: float, rate: tuple = FP32, *more
          ) -> tuple[float, str, str]:
    """The least time for the work: ``nbytes`` at the memory rate against
    ``ops`` at ``rate`` (fp32 outside the tensor cores by default) and any
    further (ops, rate) pairs, each on its own unit.  -> (ms, "bytes" or
    "operations", the unit that bounds it)."""
    best = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes", "bytes at 3.35 TB/s")
    for n_ops, (per_s, unit) in ((ops, rate), *more):
        t = n_ops / per_s * 1e3
        if t > best[0]:
            best = (t, "operations", unit)
    return best


def random_walk_cuda(n_series: int, length: int, seed: int,
                     chunk: int = 1 << 20) -> torch.Tensor:
    """The paper's Synthetic generator on the card: cumsum of N(0,1) steps."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = torch.empty((n_series, length), dtype=torch.float32, device="cuda")
    for i in range(0, n_series, chunk):
        j = min(i + chunk, n_series)
        steps = torch.randn((j - i, length), generator=g, device="cuda")
        torch.cumsum(steps, dim=1, out=out[i:j])
    return out


def stats_line(res, secs: float) -> dict:
    st = res.stats
    return {"query_seconds": secs,
            "blocks_visited_mean": st.blocks_visited.float().mean().item(),
            "blocks_visited_max": int(st.blocks_visited.max()),
            "series_refined_mean": st.series_refined.float().mean().item(),
            "lb_series_mean": st.lb_series.float().mean().item(),
            "iters": int(st.iters)}


def run_path(name: str, fn, ks=(1, 10)) -> tuple[dict, dict, dict]:
    """Run one search path for each k with the launch counts set to 0
    just before and read just after.  -> ({k: (result, seconds)},
    {k: stats line}, launches)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = {}
    for k in ks:
        t0 = time.perf_counter()
        res = fn(k)
        torch.cuda.synchronize()
        results[k] = (res, time.perf_counter() - t0)
    launches = ops.launch_counts()
    lines = {}
    for k, (res, secs) in results.items():
        lines[f"k{k}"] = stats_line(res, secs)
        check(bool(torch.isfinite(res.dist).all())
              and tuple(res.idx.shape) == (res.dist.shape[0], k)
              and bool((res.idx >= 0).all()),
              f"{name} k={k}: finite distances of shape (Q, k) with real ids")
    for kernel in PATH_KERNELS[name]:
        check(launches[kernel] > 0, f"kernel {kernel} launched on the "
                                    f"{name} path")
    return results, lines, launches


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = nvidia_smi_line()
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    kern = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kern.build_seconds, "library": str(kern.path),
          "ptxas": {stem: _build.ptxas_summary(log)
                    for stem, log in sorted(kern.ptxas_log.items())}})


def phase_main(args, raw: torch.Tensor, queries: torch.Tensor):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    index = core.build(raw, capacity=CAPACITY)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    results, lines, launches = run_path(
        "block_major", lambda k: core.search_block_major(index, queries, k=k))
    launches["isax_summarize"] = build_launches["isax_summarize"]
    check(launches["isax_summarize"] > 0,
          "kernel isax_summarize launched on the block_major path")

    resident = sum(t.numel() * t.element_size() for t in
                   (index.raw, index.slo, index.shi, index.elo, index.ehi,
                    index.ids))
    emit({"phase": "main", "n_series": args.n_series, "length": LENGTH,
          "capacity": CAPACITY, "n_blocks": index.n_blocks,
          "queries": args.queries, "build_seconds": build_s,
          "index_bytes": resident,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, **lines})
    return index, results, launches


def phase_schedules(index, queries) -> tuple[dict, dict]:
    """Query-major and flat ED on the main path's index and queries."""
    torch.cuda.reset_peak_memory_stats()
    out, launches = {}, {}
    paths = {"query_major": lambda k: core.search(index, queries, k=k),
             "flat": lambda k: core.search_paris(index, queries, k=k,
                                                 chunk=FLAT_CHUNK)}
    line = {"phase": "schedules", "queries": queries.shape[0],
            "flat_chunk": FLAT_CHUNK}
    for name, fn in paths.items():
        out[name], lines, launches[name] = run_path(name, fn)
        line[name] = {"launches": launches[name], **lines}
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(line)
    return out, launches


def phase_ucr(raw, queries) -> tuple[dict, dict]:
    results, lines, launches = run_path(
        "ucr", lambda k: core.search_scan(raw, queries, k=k), ks=(10,))
    emit({"phase": "ucr", "queries": queries.shape[0],
          "chunk": 4096, "launches": launches, **lines})
    return results, launches


def _dtw_scan(raw, q, kmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW of the z-normed queries against every series: the
    kernel on shared chunks of z-normed series, merged with the plain
    (dist, id)-lex top-k."""
    qn = q.shape[0]
    best_d = torch.full((qn, kmax), ref.INF, device=q.device)
    best_i = torch.full((qn, kmax), -1, dtype=torch.int32, device=q.device)
    for i in range(0, raw.shape[0], SCAN_CHUNK):
        j = min(i + SCAN_CHUNK, raw.shape[0])
        d = dtw_band_panel(q, isax.znorm(raw[i:j]), r=DTW_R)
        ids = torch.arange(i, j, dtype=torch.int32,
                           device=q.device).expand(qn, -1)
        cd, ci = ref.topk_by_dist_id(d, ids, kmax)
        best_d, best_i = ref.topk_by_dist_id(torch.cat([best_d, cd], 1),
                                             torch.cat([best_i, ci], 1), kmax)
    return best_d, best_i


def phase_dtw(index, raw, queries, n_main: int) -> tuple[dict, dict]:
    """search_dtw on the same index, checked against a full DTW scan."""
    results, lines, launches = run_path(
        "dtw", lambda k: dtw.search_dtw(index, queries, r=DTW_R, k=k))
    q = isax.znorm(queries)
    t0 = time.perf_counter()
    want_d, want_i = _dtw_scan(raw, q, max(results))
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    line = {"phase": "dtw", "r": DTW_R, "queries": q.shape[0],
            "cut": f"queries cut from {n_main} to {q.shape[0]} for the "
                   "time limit",
            "launches": launches, "scan_seconds": scan_s,
            "tolerance": f"squared DTW within {DIST_REL} relative; ids "
                         "equal but at near ties", **lines}
    for k, (res, _) in results.items():
        got_i = res.idx
        got_d = res.dist.double() ** 2
        wd = want_d[:, :k].double()
        tol = DIST_REL * wd + 1e-6
        dist_ok = bool(((got_d - wd).abs() <= tol).all())
        diff = got_i != want_i[:, :k]
        ties_ok = True
        if bool(diff.any()):
            # the plain banded DTW of every id the walk returned
            x = isax.znorm(raw[got_i.long().flatten()]).reshape(
                got_i.shape + (raw.shape[1],))
            dk = ref.dtw_band_panel_ref(q, x, r=DTW_R).double()
            ties_ok = bool(((dk - wd).abs() <= tol)[diff].all())
        line[f"k{k}"]["ids_equal"] = int((~diff).sum())
        line[f"k{k}"]["near_ties"] = int(diff.sum())
        check(dist_ok and ties_ok, f"dtw k={k}: search_dtw equals the full "
                                   "DTW scan (ids, but near ties)")
    emit(line)
    return results, launches


def lm_setup(seed: int, batch: int, prompt_len: int, smoke: bool = False):
    """Hymba's config, its parameters on the card from ``seed``, and
    ``batch`` prompts of ``prompt_len`` random tokens from ``seed + 2``."""
    cfg = get_config(LM_ARCH, smoke=smoke)
    params = serve.build_params(cfg, seed)
    dev = params["embed"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=dev)
    return cfg, params, prompt


def serving_consistency(label: str, out, full, s_p: int, gen: int, b: int,
                        vocab: int) -> dict:
    """Served logits (prefill, then each decode step) against the
    teacher-forced forward ``full`` over prompt and generated tokens:
    within LOGIT_REL of the logits' scale, and every greedy token with a
    top-2 gap above that tolerance the forward's argmax."""
    want = full[:, s_p - 1:s_p + gen - 1]
    scale = float(want.abs().max())
    tol = LOGIT_REL * scale
    err = float((out.logits - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    greedy = torch.argmax(want, dim=-1)
    tok_ok = torch.equal(out.tokens[clear], greedy[clear])
    check(err <= tol, f"{label}: serving logits within {LOGIT_REL} x "
                      f"max|logit| ({tol:.3g}) of the forward's, got "
                      f"{err:.3g}")
    check(tok_ok, f"{label}: every greedy token with a top-2 gap above the "
                  "tolerance is the forward's argmax")
    finite = bool(torch.isfinite(out.logits).all()) and bool(
        torch.isfinite(full).all())
    check(finite, f"{label}: every logit finite")
    check(tuple(out.tokens.shape) == (b, gen)
          and tuple(out.logits.shape) == (b, gen, vocab),
          f"{label}: tokens (B, gen) and logits (B, gen, V)")
    return {"max_abs_err": err, "logit_scale": scale, "tolerance": tol,
            "clear_tokens": int(clear.sum()),
            "tokens_equal": int((out.tokens == greedy).sum()),
            "compared_positions": [s_p - 1, s_p + gen - 2]}


def phase_lm(args) -> tuple[dict, dict]:
    """Hymba serving through the user's entry points, its consistency with
    the teacher-forced forward, and layer 0's mixer against its oracle.
    -> (launches, layer 0's scan inputs for the kernels phase)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b, s_p, gen = args.lm_batch, args.lm_prompt, args.lm_gen
    cfg, params, prompt = lm_setup(args.seed, b, s_p, args.lm_smoke)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tensors = [t for _, t in common.leaves(params)]
    n_params = sum(t.numel() for t in tensors)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = serve.greedy_generate(params, cfg, prompt, gen)
    launches = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    mixer_calls = cfg.n_layers * gen        # one per layer: the prefill, then
    check(launches["ssm_scan"] == mixer_calls,   # each of the gen-1 steps
          f"lm: ssm_scan launched {launches['ssm_scan']} times, once per "
          f"mamba_mix call ({mixer_calls})")

    # 1. serving against the teacher-forced forward over the same tokens
    t0 = time.perf_counter()
    seq = torch.cat([prompt, out.tokens], dim=1)
    full = transformer.forward(params, {"tokens": seq}, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    consistency = serving_consistency("lm", out, full, s_p, gen, b,
                                      cfg.vocab)

    # 2. layer 0's mixer on its real input: kernel against the plain oracle
    p0 = transformer._layer(params["layers"], 0)
    x = transformer.embed_inputs(params, prompt, cfg)
    h = common.rmsnorm(x, p0["ln1"])
    with torch.no_grad():
        got, gst = mamba.mamba_mix(h, p0["mamba"], d_inner=cfg.q_dim)
        t0 = time.perf_counter()
        ref_out, rst = mamba.mamba_naive(h, p0["mamba"], d_inner=cfg.q_dim)
        torch.cuda.synchronize()
        naive_s = time.perf_counter() - t0
        xc, _, _ = mamba._mixer_in(h, p0["mamba"], cfg.q_dim, None)
        dt, bt, ct, a_mat = mamba._dt_bc(xc, p0["mamba"])
    mix_err = max(float((got - ref_out).abs().max()),
                  float((gst.h - rst.h).abs().max()))
    mix_ok = (torch.allclose(got, ref_out, rtol=MIX_TOL, atol=MIX_TOL)
              and torch.allclose(gst.h, rst.h, rtol=MIX_TOL, atol=MIX_TOL))
    check(mix_ok, f"lm: layer 0 mamba_mix (ssm_scan kernel) within "
                  f"{MIX_TOL} of mamba_naive")
    n_dec = max(gen - 1, 1)
    emit({"phase": "lm", "arch": cfg.name, "smoke_config": args.lm_smoke,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": n_params, "count_params": count_params(cfg),
          "param_bytes": sum(t.numel() * t.element_size() for t in tensors),
          "param_build_seconds": build_s, "batch": b, "prompt": s_p,
          "gen": gen, "positions_with_meta": cfg.meta_tokens + s_p + gen,
          "prefill_seconds": out.prefill_s,
          "decode_ms_per_token": out.decode_s * 1e3 / n_dec,
          "launches": launches, "ssm_scan_per_call": cfg.n_layers,
          "max_memory_allocated_serving": serve_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "forward_seconds": forward_s,
          "consistency": consistency,
          "mixer_vs_naive": {"max_abs_err": mix_err, "match": mix_ok,
                             "naive_seconds": naive_s,
                             "tolerance": f"rtol and atol {MIX_TOL}"},
          "sample_tokens": out.tokens[0, :16].tolist()})
    scan_in = {"xc": xc.contiguous(), "dt": dt.contiguous(),
               "bm": bt.contiguous(), "cm": ct.contiguous(),
               "a": a_mat.contiguous(), "h_last": gst.h}
    return launches, scan_in


def _serve_dense(cfg, seed: int, b: int, s_p: int, gen: int) -> dict:
    """One dense model served through ``greedy_generate`` from fp32
    weights built from ``seed`` (prompts from ``seed + 2``), checked
    against the teacher-forced forward.  -> its phase entry."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.build_params(cfg, seed)
    dev = params["embed"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab, (b, s_p), generator=g, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tensors = [t for _, t in common.leaves(params)]

    ops.reset_launch_counts()
    out = serve.greedy_generate(params, cfg, prompt, gen)
    launches = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    check(not any(launches.values()),
          f"dense {cfg.name}: no custom kernel on the dense path, got "
          f"{launches}")
    t0 = time.perf_counter()
    full = transformer.forward(params, {"tokens": torch.cat(
        [prompt, out.tokens], dim=1)}, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    consistency = serving_consistency(f"dense {cfg.name}", out, full, s_p,
                                      gen, b, cfg.vocab)
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "segments": [[sg.kind, sg.start, sg.end]
                         for sg in transformer.segments(cfg)],
            "params": sum(t.numel() for t in tensors),
            "count_params": count_params(cfg),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tensors),
            "param_build_seconds": build_s, "batch": b, "prompt": s_p,
            "gen": gen, "prefill_seconds": out.prefill_s,
            "decode_ms_per_token": out.decode_s * 1e3 / max(gen - 1, 1),
            "forward_seconds": forward_s, "launches": launches,
            "max_memory_allocated_serving": serve_peak,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "consistency": consistency,
            "sample_tokens": out.tokens[0, :16].tolist()}


def phase_dense(args) -> dict:
    """The dense family served at full width (gemma3 at a cut depth).
    -> launches over both runs (all zero)."""
    t0 = time.perf_counter()
    runs = []
    for arch, layers, b, s_p, gen in DENSE_RUNS:
        cfg = get_config(arch, smoke=args.lm_smoke)
        if args.lm_smoke:
            b, s_p, gen = b // 2 or 1, args.lm_prompt, args.lm_gen
        elif layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        runs.append(_serve_dense(cfg, args.seed, b, s_p, gen))
        torch.cuda.empty_cache()
    emit({"phase": "dense", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0,
          "smoke_config": args.lm_smoke, "runs": runs,
          "custom_kernel_launches": sum(sum(r["launches"].values())
                                        for r in runs)})
    return {k: sum(r["launches"][k] for r in runs)
            for k in runs[0]["launches"]}


def _last_loss_lines(text: str) -> list[float]:
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ") and " loss " in line]


def _train_example(args) -> dict:
    """``python -m repro_torch.examples.train_lm --steps 40`` on the card,
    as a user runs it: exit 0, a resume, and a falling loss."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.train_lm",
                        "--steps", "40"], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=EXAMPLE_TIMEOUT_S)
    secs = time.perf_counter() - t0
    first, _, resumed = r.stdout.partition("[resume]")
    a, b = _last_loss_lines(first), _last_loss_lines(resumed)
    ok = (r.returncode == 0 and bool(resumed) and bool(a) and bool(b)
          and b[-1] < a[0])
    check(ok, f"train: the train_lm example exits 0, resumes and ends "
              f"below its first loss (rc {r.returncode}, losses {a} / {b}; "
              f"stderr {r.stderr[-2000:]!r})")
    return {"seconds": secs, "returncode": r.returncode,
            "resumed": bool(resumed), "first_loss": a[0] if a else None,
            "resumed_last_loss": b[-1] if b else None}


def _card_vs_cpu_step(seed: int, card: str = "cuda") -> dict:
    """One smoke() train step on the card and one on the CPU from the
    same parameters and batch."""
    cfg = get_config(TRAIN_ARCH, smoke=True)
    host = serve.build_params(cfg, seed, "cpu")
    batch = next(synthetic_token_batches(batch=8, seq_len=256,
                                         vocab=cfg.vocab, seed=seed))
    out = {}
    for where, params in (("card", common.tree_map(
            lambda t: t.to(card, copy=True), host)), ("cpu", host)):
        step = make_train_step(cfg, microbatch=1,
                               device=card if where == "card" else "cpu")
        _, _, m = step(params, opt_init(cfg.optimizer, params), batch)
        out[where] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    check(max(rel.values()) <= CARD_CPU_REL,
          f"train: a smoke() step on the card within {CARD_CPU_REL} of the "
          f"CPU's (loss, grad norm), got {rel}")
    return {**out, "rel_err": rel}


def phase_train(args) -> dict:
    """Dense training at full width: fp32 AdamW steps of h2o-danube-1.8b
    on one batch, their checks and times; the smoke config's step on the
    card against the CPU; the train_lm example.  -> launches (all zero)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH, smoke=args.lm_smoke)
    b, s = (TRAIN_BATCH, 64) if args.lm_smoke else (TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.perf_counter()
    params = serve.build_params(cfg, args.seed)
    opt = opt_init(cfg.optimizer, params)
    batch = next(synthetic_token_batches(batch=b, seq_len=s, vocab=cfg.vocab,
                                         seed=args.seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in common.leaves(params))

    ops.reset_launch_counts()
    eval_loss = float(make_eval_step(cfg)(params, batch)["loss"])
    step = make_train_step(cfg, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=100)
    secs, mets = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in mets]
    finite = all(np.isfinite([m["loss"], m["grad_norm"]]).all()
                 for m in mets)
    check(finite, f"train: every loss and gradient norm finite ({mets})")
    check(all(m["skipped"] == 0 for m in mets), "train: no step skipped")
    check(losses[-1] < losses[0], f"train: the last loss below the first "
                                  f"({losses})")
    eval_rel = abs(losses[0] - eval_loss) / abs(eval_loss)
    check(eval_rel <= EVAL_REL, f"train: step 1's loss within {EVAL_REL} "
                                f"of make_eval_step's, got {eval_rel:.3g}")
    check(not any(launches.values()),
          f"train: no custom kernel on the training path, got {launches}")
    del params, opt
    torch.cuda.empty_cache()

    step_s = float(np.median(secs[1:]))
    flops = 6.0 * n_params * b * s
    card_vs_cpu = _card_vs_cpu_step(args.seed)
    example = _train_example(args)
    emit({"phase": "train", "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t_phase,
          "arch": cfg.name, "smoke_config": args.lm_smoke,
          "optimizer": cfg.optimizer, "remat": cfg.remat, "batch": b,
          "seq": s, "steps": TRAIN_STEPS, "params": n_params,
          "param_build_seconds": build_s, "step_seconds": secs,
          "step_seconds_median_2_to_last": step_s,
          "tokens_per_second": b * s / step_s,
          "model_flops_per_step_6ND": flops,
          "fp32_peak_flops": FP32[0],
          "fp32_peak_share": flops / step_s / FP32[0],
          "max_memory_allocated": peak, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in mets],
          "lr": [m["lr"] for m in mets],
          "eval_loss_initial": eval_loss, "eval_rel_err": eval_rel,
          "launches": launches,
          "custom_kernel_launches": sum(launches.values()),
          "card_vs_cpu_smoke_step": card_vs_cpu,
          "train_lm_example": example})
    return launches


def _compare_summarize(raw: torch.Tensor, n_slice: int) -> dict:
    """Bitwise: the kernel and the plain version evaluate the same float64
    operations in the same order and round the PAA once."""
    x_raw = raw[:n_slice]
    x_norm = isax.znorm(x_raw)
    bps = isax.breakpoints_on(isax.CARD, raw.device)
    out = {}
    for normalize, x in ((False, x_norm), (True, x_raw)):
        pk, sk = isax_summarize(x, w=isax.W, card=isax.CARD, normalize=normalize)
        pr, sr = ref.isax_summarize_ref(x, w=isax.W, card=isax.CARD,
                                        normalize=normalize)
        err = (pk - pr).abs()
        n_flips = int((sk != sr).sum())
        paa_ok = check(torch.equal(pk, pr), f"isax_summarize normalize="
                                            f"{normalize}: PAA bitwise")
        flips_ok = check(n_flips == 0, f"isax_summarize normalize={normalize}:"
                                       f" {n_flips} symbol flips, want 0")
        run = lambda: isax_summarize(x, w=isax.W, card=isax.CARD,
                                     normalize=normalize)
        ms = time_cuda(run)
        dev_ms = device_ms(run, SYMBOL["isax_summarize"])
        plain_ms = time_cuda(lambda: ref.isax_summarize_ref(
            x, w=isax.W, card=isax.CARD, normalize=normalize), reps=5)
        n, w = x.shape[1], isax.W
        nbytes = n_slice * n * 4 + n_slice * w * 8 + bps.numel() * 4
        # float64: per point one add, and with z-norm the variance's
        # subtract, multiply and add and the z-norm's subtract and divide;
        # per window its divide; the symbol search in fp32
        f64 = n_slice * (n * (6 if normalize else 1) + w)
        search = n_slice * w * int(np.ceil(np.log2(bps.numel() + 1)))
        b_ms, b_by, b_unit = bound(nbytes, f64, FP64, (search, FP32))
        out[normalize] = {"shape": [n_slice, n], "normalize": normalize,
                          "max_abs_err": float(err.max()),
                          "symbol_flips": n_flips, "match": paa_ok and flips_ok,
                          "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_unit": b_unit, "library_ms": None,
                          "tolerance": "bitwise: PAA and symbols"}
        emit({"phase": "kernels", "kernel": "isax_summarize", **out[normalize]})
    return out[False]           # the main path's branch


def lb_scan_chunked_ref(q_paa, lo, hi, n: int):
    """The plain ``ref.lb_scan_ref`` over LB_PLAIN_CHUNK columns at a time
    (whole, its (Q, w, N) intermediate would not fit at the flat shape):
    yields (first column, last column + 1, the chunk's (Q, cols) bounds)."""
    for s in range(0, lo.shape[1], LB_PLAIN_CHUNK):
        e = min(s + LB_PLAIN_CHUNK, lo.shape[1])
        yield s, e, ref.lb_scan_ref(q_paa, lo[:, s:e], hi[:, s:e], n=n)


def _lb_check(q_paa, lo, hi, n: int) -> tuple[bool, float, float]:
    """The kernel against the plain version over every column within rtol
    LB_RTOL. -> (ok, max |err|, max relative err)."""
    got = lb_scan(q_paa, lo, hi, n=n)
    ok, max_err, max_rel = True, 0.0, 0.0
    for s, e, want in lb_scan_chunked_ref(q_paa, lo, hi, n):
        err = (got[:, s:e] - want).abs()
        ok &= bool((err <= LB_RTOL * want.abs()).all())
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, float((err / want.abs().clamp(min=1e-30)).max()))
    return ok, max_err, max_rel


def _lb_case(q_paa, lo, hi, n: int) -> dict:
    """One shape: the kernel against the plain version over every column,
    timed beside it, and its byte bound."""
    ok, max_err, max_rel = _lb_check(q_paa, lo, hi, n)
    qn, w = q_paa.shape
    nb = lo.shape[1]
    b_ms, b_by, b_unit = bound(qn * w * 4 + 2 * w * nb * 4 + qn * nb * 4,
                               qn * nb * (6 * w + 1))
    run = lambda: lb_scan(q_paa, lo, hi, n=n)
    chunked = nb > LB_PLAIN_CHUNK

    def plain():
        for _ in lb_scan_chunked_ref(q_paa, lo, hi, n):
            pass
    return {"shape": [qn, w, nb], "max_abs_err": max_err,
            "max_rel_err": max_rel, "match": ok, "ms": time_cuda(run),
            "device_ms": device_ms(run, SYMBOL["lb_scan"]),
            "plain_ms": time_cuda(plain, reps=3 if chunked else 20),
            "plain": (f"ref.lb_scan_ref over {LB_PLAIN_CHUNK:,}-column chunks"
                      if chunked else "ref.lb_scan_ref, whole"),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "library_ms": None}


def _compare_lb_scan(q_paa, index, u_paa, l_paa, envelope_blocks) -> dict:
    """At every shape the search paths give the kernel: the flat scan over
    every series (``flat_view``'s (w, Np) bounds), the block envelopes
    (block ranking in ``engine.prepare``), and DTW's two passes against
    planes of +-SENTINEL built as ``engine.interval_planar_lb`` builds
    them.  Each is checked over every column within rtol LB_RTOL.  The
    line's own numbers are the flat case's, where the work is; the phase
    line adds each case's issue floor, worked out from the kernel's
    arithmetic a term (LB_INSTR_PER_TERM), not measured.  The serving
    walks rank the envelopes at other shapes: each (Q, blocks) of
    ``envelope_blocks`` is checked, untimed, on the first Q queries and
    the first blocks of this index's envelopes."""
    n = index.n
    flat = core.flat_view(index)
    plane = torch.full(index.elo.shape, isax.SENTINEL, dtype=torch.float32,
                       device=index.elo.device)
    cases = {"flat": (q_paa, flat.lo, flat.hi),
             "envelope": (q_paa, index.elo, index.ehi),
             "dtw_above": (u_paa, index.elo, plane),
             "dtw_below": (l_paa, -plane, index.ehi)}
    line = {}
    for label, (qq, lo, hi) in cases.items():
        line[label] = _lb_case(qq, lo, hi, n)
        check(line[label]["match"], f"lb_scan {label} "
                                    f"{tuple(line[label]['shape'])}: within "
                                    f"rtol {LB_RTOL} over every column")
    del flat
    sliced = {}
    for qn, nb in envelope_blocks:
        ok, err, rel = _lb_check(q_paa[:qn].contiguous(),
                                 index.elo[:, :nb].contiguous(),
                                 index.ehi[:, :nb].contiguous(), n)
        check(ok, f"lb_scan envelope ({qn}, {q_paa.shape[1]}, {nb}): "
                  f"within rtol {LB_RTOL} over every column")
        sliced[f"{qn}x{nb}"] = {"shape": [qn, q_paa.shape[1], nb],
                                "max_abs_err": err, "max_rel_err": rel,
                                "match": ok}
    out = {**line["flat"], "cases": line, "envelope_slices": sliced,
           "cases_match": all(c["match"] for c in line.values())
           and all(c["match"] for c in sliced.values()),
           "tolerance": f"rtol {LB_RTOL} over every column of every case"}
    floors = {label: c["shape"][0] * c["shape"][1] * c["shape"][2]
              * LB_INSTR_PER_TERM / INSTR_RATE * 1e3
              for label, c in line.items()}
    emit({"phase": "kernels", "kernel": "lb_scan", **out,
          "issue_floor_ms": floors,
          "issue_floor_unit": f"{LB_INSTR_PER_TERM} fp32 instructions a "
                              "(q, j, s) term (the kernel's arithmetic, no "
                              "loads) at one warp instruction a clock on "
                              "each of 528 schedulers at an assumed 1.98 GHz"})
    return out


def walk_topk_panels(index, queries, n_dtw: int, prep) -> dict:
    """The first panel each walk hands to ``block_topk`` at k = 10, built
    from the index with the engine's own steps: stage A's seed panel, the
    flat scan's first chunk with a live lane, the first query-major trip
    (QUERY_MAJOR_BLOCKS blocks a query) and the first DTW trip
    (DTW_BLOCKS blocks a query).  ``prep`` is ``engine.prepare`` of the
    queries under ``engine.ED()``."""
    metric = engine.ED()
    # stage A exactly as engine.prepare hands it to block_topk
    b0 = torch.argmin(prep.block_lb, dim=1)
    ids0 = index.ids[b0]
    d0 = torch.where(ids0 >= 0,
                     frontier.query_block_l2(prep.qs.q, index.raw[b0]), ref.INF)
    panels = {"stage_a": (d0, ids0)}
    thr = frontier.bound(prep.front)
    flat = core.flat_view(index)
    lb = metric.block_lb(prep.qs, flat.lo, flat.hi, n=flat.n)
    for s in range(0, flat.raw.shape[0], FLAT_CHUNK):
        e = min(s + FLAT_CHUNK, flat.raw.shape[0])
        ids_k = flat.ids[s:e]
        act = (lb[:, s:e] < thr[:, None]) & (ids_k[None, :] >= 0)
        if bool(act.any()):                   # the scan skips a dead chunk
            d = torch.where(act, metric.distances(prep.qs, flat.raw[s:e]),
                            ref.INF)
            panels["flat"] = (d, torch.where(act, ids_k[None, :], -1))
            break
    check("flat" in panels, "the flat scan has a chunk with a live lane")
    trips = (("query_major", metric, queries, QUERY_MAJOR_BLOCKS),
             ("dtw", engine.DTW(r=DTW_R), queries[:n_dtw].contiguous(),
              DTW_BLOCKS))
    for label, m, qq, kb in trips:
        p = prep if m is metric else engine.prepare(m, index, qq, 10)
        t = frontier.bound(p.front)
        idxs = torch.argsort(p.block_lb, dim=1, stable=True)[:, :kb]
        active = torch.gather(p.block_lb, 1, idxs) < t[:, None]
        d, ids, _ = engine.trip_panel(m, index, p.qs, idxs, active, t)
        panels[label] = (d, ids)
    return {label: (d.contiguous(), ids.contiguous())
            for label, (d, ids) in panels.items()}


def _compare_block_topk(panels: dict) -> dict:
    """Bitwise (distance bits and ids) on every walk panel, on panels of
    +-0 and negative ties (one with ids up to INT32_MAX - 1, one with rows
    past 4,096 lanes) and on all-pad rows, at k = 1, 2, 10, 16, 17, 32, 33
    (the k = 1 and k <= 32 kernels' largest k and one past each) and
    C + 5; timed on every walk panel at k = 1 and 10.  The line's own
    numbers are the flat scan's panel at k = 10, the shape most launches
    take."""
    dev = panels["stage_a"][0].device
    pad_rows = (torch.full((10, 300), ref.INF, device=dev),
                torch.full((10, 300), -1, dtype=torch.int32, device=dev))
    checked = {**panels,
               "signed_zero_ties": ref.signed_panel(100, 4096, seed=5,
                                                   device=dev),
               "ids_past_2e30": ref.signed_panel(
                   100, 4096, seed=6, device=dev,
                   id_offset=int(torch.iinfo(torch.int32).max) - 4 * 4096),
               "rows_past_a_block": ref.signed_panel(10, 9000, seed=7,
                                                     device=dev),
               "all_pad_rows": pad_rows}
    ok_all, n_cases = True, 0
    for label, (d, ids) in checked.items():
        for k in (1, 2, 10, 16, 17, 32, 33, d.shape[1] + 5):
            gd, gi = block_topk(d, ids, k=k)
            wd, wi = ref.block_topk_ref(d, ids, k)
            ok = (torch.equal(gd.view(torch.int32), wd.view(torch.int32))
                  and torch.equal(gi, wi))
            ok_all &= check(ok, f"block_topk {label} {tuple(d.shape)} k={k}: "
                                "bitwise")
            n_cases += 1
    shapes = {}
    for label, (d, ids) in panels.items():
        qn, c = d.shape
        for k in (1, 10):
            run = lambda d=d, ids=ids, k=k: block_topk(d, ids, k=k)
            lib = lambda d=d, k=k: torch.topk(d, k, dim=1, largest=False)
            b_ms, b_by, b_unit = bound(qn * c * 8 + qn * k * 8, qn * c)
            shapes[f"{label}_k{k}"] = {
                "shape": [qn, c], "k": k,
                "live_lanes": int((ids >= 0).sum()),
                "ms": time_cuda(run),
                "device_ms": device_ms(run, SYMBOL["block_topk"]),
                "plain_ms": time_cuda(
                    lambda d=d, ids=ids, k=k: ref.block_topk_ref(d, ids, k)),
                "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
                "library_ms": time_cuda(lib),
                "library_device_ms": device_ms_all(lib)}
    line = {**shapes["flat_k10"], "panel": "flat", "shapes": shapes,
            "cases": n_cases, "max_abs_err": 0.0 if ok_all else None,
            "match": ok_all,
            "library": "torch.topk(largest=False): not id-tie-exact",
            "tolerance": "bitwise (distance bits and ids) on every walk "
                         "panel, +-0 ties, ids up to INT32_MAX - 1, rows "
                         "of 9,000 lanes, all-pad rows; k in {1, 2, 10, "
                         "16, 17, 32, 33, C + 5}"}
    emit({"phase": "kernels", "kernel": "block_topk", **line})
    return line


def _fused_case(q, q_paa, block, lo, hi, ids, thr, k, n, label) -> tuple[bool, float, int]:
    """One kernel-vs-plain comparison. -> (ok, max |d err|, near ties)."""
    gd, gi, gn = fused_panel_topk(q, q_paa, block, lo, hi, ids, thr, k=k, n=n)
    wd, wi, wn = ref.fused_panel_topk_ref(q, q_paa, block, lo, hi, ids, thr,
                                          k=k, n=n)
    full = ref.batch_l2_ref(q, block)                          # (Q, C)
    real = ids >= 0
    xx = torch.where(real, (block * block).sum(1), 0.0).amax()
    tol = DIST_REL * ((q * q).sum(1) + xx)[:, None]            # (Q, 1)
    ok = check(torch.equal(gn, wn), f"fused {label} k={k}: n_live equal")
    both = (wi >= 0) & (gi >= 0)
    err = torch.where(both, (gd - wd).abs(), 0.0)
    ok &= check(bool((err <= tol).all()) and torch.equal(gi >= 0, wi >= 0),
                f"fused {label} k={k}: distances within {DIST_REL}*(|q|^2+|x|^2)")
    ok &= check(bool(torch.where(gi < 0, gd == ref.INF, True).all()),
                f"fused {label} k={k}: empty slots are (INF, -1)")
    # an id may differ only at a near tie: the plain distance of the
    # kernel's pick is within tol of the plain pick's distance
    diff = (gi != wi) & both
    ties = 0
    if bool(diff.any()):
        lane_of = torch.full((int(ids.max()) + 1,), -1, dtype=torch.long,
                             device=ids.device)
        lane_of[ids[real].long()] = torch.nonzero(real).flatten()
        qi, ri = torch.nonzero(diff, as_tuple=True)
        dk = full[qi, lane_of[gi[qi, ri].long()]]
        ok &= check(bool(((dk - wd[qi, ri]).abs() <= tol[qi, 0]).all()),
                    f"fused {label} k={k}: differing ids are near ties")
        ties = int(diff.sum())
    return ok, float(err.max()), ties


def _compare_fused(index, qs, front_thr, final_thr, block_lb, order,
                   batch_slices) -> dict:
    """Every case at k in {1, 10, 32}; timed at the walk's first block
    (stage-A bounds) and at the block 90% along the walk (the main path's
    final k=10 bounds: few live lanes).  The serving walks refine smaller
    batches: the first and the late block are also checked, untimed, on
    the first Q queries for each Q of ``batch_slices`` at k in {1, 10}."""
    q, q_paa = qs.q, qs.aux[0]
    n, qn = index.n, q.shape[0]
    neg = torch.zeros(qn, dtype=torch.bool, device=q.device)
    neg[::7] = True
    minus_inf = torch.tensor(float("-inf"), device=q.device)
    b0 = int(order[0])
    b_last = index.n_blocks - 1
    first_thr = torch.where(block_lb[:, b0] < front_thr, front_thr, minus_inf)
    live_all = torch.where(neg, minus_inf, torch.full_like(front_thr, ref.INF))
    b_late = int(order[(9 * index.n_blocks) // 10])
    late_thr = torch.where(block_lb[:, b_late] < final_thr, final_thr,
                           minus_inf)

    def blk(b, c=None):
        c = index.capacity if c is None else c
        return (index.raw[b][:c], index.slo[b][:, :c].contiguous(),
                index.shi[b][:, :c].contiguous(), index.ids[b][:c])

    cases = {"first_block": (blk(b0), first_thr),
             "late_block": (blk(b_late), late_thr),
             "all_live_some_inactive": (blk(b0), live_all),
             "all_dead": (blk(b0), torch.zeros_like(front_thr)),
             "pad_lanes": (blk(b_last), live_all),
             "ragged_c1000": (blk(b0, 1000), live_all)}
    ok_all, max_err, ties, n_cases = True, 0.0, 0, 0
    for label, ((block, lo, hi, ids), thr) in cases.items():
        for k in (1, 10, 32):
            ok, err, t = _fused_case(q, q_paa, block, lo, hi, ids, thr, k, n,
                                     label)
            ok_all &= ok
            max_err = max(max_err, err)
            ties += t
            n_cases += 1
    for sq in batch_slices:
        for label, b, thr in (("first_block", b0, first_thr),
                              ("late_block", b_late, late_thr)):
            block, lo, hi, ids = blk(b)
            for k in (1, 10):
                ok, err, t = _fused_case(q[:sq], q_paa[:sq], block, lo, hi,
                                         ids, thr[:sq], k, n,
                                         f"{label} Q={sq}")
                ok_all &= ok
                max_err = max(max_err, err)
                ties += t
                n_cases += 1
    pads = int((index.ids[b_last] < 0).sum())

    # time the main path's first refine call (k=10) and a late one, at the
    # walk's final bounds, and count their work
    k = 10
    w = q_paa.shape[1]
    timed = {}
    for label, b, thr in (("first_block", b0, first_thr),
                          ("late_block", b_late, late_thr)):
        block, lo, hi, ids = blk(b)
        c = block.shape[0]
        args = (q, q_paa, block, lo, hi, ids, thr)
        run = lambda: fused_panel_topk(*args, k=k, n=n)
        qe = q_paa[:, :, None]
        dd = torch.clamp(torch.maximum(lo[None] - qe, qe - hi[None]), min=0.0)
        live = ((n / w) * (dd * dd).sum(1) < thr[:, None]) & (ids >= 0)[None]
        n_live = int(live.sum())
        live_rows = int(live.any(0).sum())
        nbytes = (qn * (n + w + 1) * 4 + 2 * w * c * 4 + c * 4
                  + live_rows * n * 4 + qn * k * 8 + qn * 4)
        ops = qn * c * 6 * w + n_live * (2 * n + 3) + live_rows * 2 * n
        b_ms, b_by, b_unit = bound(nbytes, ops)
        timed[label] = {
            "block": b, "walk_position": int((order == b).nonzero()[0, 0]),
            "n_live": n_live, "live_rows": live_rows,
            "ms": time_cuda(run), "device_ms": device_ms(
                run, SYMBOL["fused_panel_topk"]),
            "plain_ms": time_cuda(lambda: ref.fused_panel_topk_ref(
                *args, k=k, n=n)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit}
    first = timed["first_block"]
    line = {"shape": [qn, index.capacity, n], "k": k, "cases": n_cases,
            "batch_slices": list(batch_slices),
            "pad_lanes_in_last_block": pads, "near_ties": ties,
            "timed_call": {"n_live": first["n_live"],
                           "live_rows": first["live_rows"]},
            "late_block": timed["late_block"],
            "max_abs_err": max_err, "match": ok_all, "ms": first["ms"],
            "device_ms": first["device_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bound_unit": first["bound_unit"],
            "library_ms": None,
            "tolerance": f"n_live equal; squared distances within "
                         f"{DIST_REL}*(|q|^2+max|x|^2); ids equal but at near ties"}
    emit({"phase": "kernels", "kernel": "fused_panel_topk", **line})
    return line


def _compare_batch_l2(q, flat_raw) -> dict:
    """At the flat scan's first chunk, a ragged chunk, Q = 1 and 13 (all
    timed but the ragged one), and a chunk that holds the queries
    themselves (distance ~ 0).  ``max_rel_err`` is the largest error over
    |q|^2 + |x|^2, the scale the tolerance is stated in."""
    x0 = flat_raw[:FLAT_CHUNK]
    twin = x0.clone()
    twin[:q.shape[0]] = q
    cases = {"first_chunk": (q, x0), "ragged_n1000": (q, flat_raw[:1000]),
             "q1": (q[:1], x0), "q13": (q[:13], x0), "zero_distance": (q, twin)}
    ok_all, max_err, max_rel = True, 0.0, 0.0
    for label, (qq, x) in cases.items():
        got = batch_l2(qq, x)
        want = ref.batch_l2_ref(qq, x)
        scale = (qq * qq).sum(1)[:, None] + (x * x).sum(1)[None, :]
        err = (got - want).abs()
        ok_all &= check(bool(torch.isfinite(got).all())
                        and bool((err <= DIST_REL * scale).all()),
                        f"batch_l2 {label} {tuple(qq.shape)} x "
                        f"{tuple(x.shape)}: within {DIST_REL}*(|q|^2+|x|^2)")
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, float((err / scale).max()))
    timed = {}
    for label in ("first_chunk", "q1", "q13"):
        qq, x = cases[label]
        qn, n = qq.shape
        m = x.shape[0]
        nbytes = 4 * (qn * n + m * n + qn * m)
        # the design that runs: three TF32 products on the tensor cores
        b_ms, b_by, b_unit = bound(nbytes, 3 * 2 * qn * m * n, TF32)
        run = lambda qq=qq, x=x: batch_l2(qq, x)
        lib = lambda qq=qq, x=x: torch.cdist(
            qq, x, compute_mode="use_mm_for_euclid_dist")
        timed[label] = {
            "shape": [qn, m, n], "ms": time_cuda(run),
            "device_ms": device_ms(run, SYMBOL["batch_l2"]),
            "plain_ms": time_cuda(lambda qq=qq, x=x: ref.batch_l2_ref(qq, x)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            # a note: the bound of one product at the fp32 rate
            "fp32_bound_ms": bound(nbytes, 2 * qn * m * n)[0],
            "library_ms": time_cuda(lib),
            "library_device_ms": device_ms_all(lib)}
    line = {**timed["first_chunk"], "cases": list(cases), "timed": timed,
            "max_abs_err": max_err, "max_rel_err": max_rel, "match": ok_all,
            "library": "torch.cdist(use_mm_for_euclid_dist): the expanded "
                       "form plus a sqrt",
            "tolerance": f"within {DIST_REL}*(|q|^2+|x|^2) per pair"}
    emit({"phase": "kernels", "kernel": "batch_l2", **line})
    return line


def band_cells(n: int, r: int) -> int:
    """Cells (i, j) of an n x n matrix with |i - j| <= r."""
    r = min(r, n - 1)
    return n * (2 * r + 1) - r * (r + 1)


def _compare_dtw(index, q) -> dict:
    """Shared: the first block (Q, C, n); gathered: each query's first two
    blocks in its own lower-bound order, as the query-major walk hands
    them over (Q, 2C, n); bitwise at r in {0, DTW_R, n - 1}."""
    qs = engine.DTW(r=DTW_R).prep_queries(q, w=index.w)
    block_lb = engine.DTW(r=DTW_R).block_lb(qs, index.elo, index.ehi,
                                            n=index.n)
    order = torch.argsort(block_lb, dim=1, stable=True)[:, :2]
    qn, n = qs.q.shape
    shared = index.raw[0]
    gathered = index.raw[order].reshape(qn, -1, n)
    ok_all = True
    for r in (0, DTW_R, n - 1):
        for label, x in (("shared", shared), ("gathered", gathered)):
            got = dtw_band_panel(qs.q, x, r=r)
            want = ref.dtw_band_panel_ref(qs.q, x, r=r)
            ok_all &= check(torch.equal(got, want),
                            f"dtw_band_panel {label} {tuple(x.shape)} "
                            f"r={r}: bitwise")
    m = gathered.shape[1]
    cells = qn * m * band_cells(n, DTW_R)
    b_ms, b_by, b_unit = bound(4 * (qn * n + qn * m * n + qn * m), 6 * cells)
    line = {"shape": [qn, m, n], "r": DTW_R, "form": "gathered",
            "band_cells": cells,
            "max_abs_err": 0.0 if ok_all else None, "match": ok_all,
            "ms": time_cuda(lambda: dtw_band_panel(qs.q, gathered, r=DTW_R)),
            "device_ms": device_ms(lambda: dtw_band_panel(
                qs.q, gathered, r=DTW_R), SYMBOL["dtw_band_panel"]),
            "plain_ms": time_cuda(lambda: ref.dtw_band_panel_ref(
                qs.q, gathered, r=DTW_R), reps=3, warmup=1),
            "shared_ms": time_cuda(lambda: dtw_band_panel(qs.q, shared,
                                                          r=DTW_R)),
            "shared_device_ms": device_ms(lambda: dtw_band_panel(
                qs.q, shared, r=DTW_R), SYMBOL["dtw_band_panel"]),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
            "library_ms": None,
            "tolerance": f"bitwise, shared {tuple(shared.shape)} and "
                         f"gathered {tuple(gathered.shape)}, r in "
                         f"{{0, {DTW_R}, {n - 1}}}"}
    emit({"phase": "kernels", "kernel": "dtw_band_panel", **line})
    return line


def _ssm_bound(b, s, d, n, with_h0: bool) -> tuple[float, str, str]:
    """Bytes: xc, dt, y (B, S, D), B, C (B, S, N), A (D, N), h_last and h0
    (B, D, N).  fp32 operations: per (b, t, d, n) dt*A, (dt*x)*B, a*h + b
    (two), h*C and one reduction add; per (b, t, d) dt*x.  Exps: one per
    (b, t, d, n), on the special-function units."""
    nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n
                  + (2 if with_h0 else 1) * b * d * n)
    return bound(nbytes, 6 * b * s * d * n + b * s * d, FP32,
                 (b * s * d * n, SFU))


def _compare_ssm(scan_in: dict) -> dict:
    """At the prefill shape on layer 0's real coefficients, at the decode
    shape (S = 1) from that scan's last state, and at a state size that is
    no power of two (the first SSM_ODD_N states of the same coefficients
    over SSM_ODD_STEPS steps; one state fewer than the config's where that
    is smaller), which the kernel pads in registers."""
    xc, dt, bm, cm, a = (scan_in[k] for k in ("xc", "dt", "bm", "cm", "a"))
    one = lambda t: t[:, -1:].contiguous()
    odd = min(SSM_ODD_N, max(bm.shape[-1] - 1, 1))
    part = lambda t: t[:, :SSM_ODD_STEPS, :odd].contiguous()
    cases = {"prefill": (xc, dt, bm, cm, a, None),
             "decode": (one(xc), one(dt), one(bm), one(cm), a,
                        scan_in["h_last"]),
             f"n{odd}": (xc[:, :SSM_ODD_STEPS].contiguous(),
                         dt[:, :SSM_ODD_STEPS].contiguous(), part(bm),
                         part(cm), a[:, :odd].contiguous(), None)}
    ok_all, line = True, {}
    for label, args in cases.items():
        y, h_last = ssm_scan(*args)
        yr, hr = ref.ssm_scan_ref(*args)
        errs = []
        for name, got, want in (("y", y, yr), ("h_last", h_last, hr)):
            err = (got - want).abs()
            tol = SSM_REL * (want.abs() + want.abs().max())
            ok_all &= check(bool(torch.isfinite(got).all())
                            and bool((err <= tol).all()),
                            f"ssm_scan {label} {name}: within {SSM_REL} x "
                            f"(|ref| + max|ref|)")
            errs.append(float(err.max()))
        b, s_len, d = args[0].shape
        n = args[2].shape[-1]
        b_ms, b_by, b_unit = _ssm_bound(b, s_len, d, n, args[5] is not None)
        line[label] = {"shape": [b, s_len, d, n],
                       "max_abs_err_y": errs[0], "max_abs_err_h_last": errs[1],
                       "ms": time_cuda(lambda: ssm_scan(*args)),
                       "device_ms": device_ms(lambda: ssm_scan(*args),
                                              SYMBOL["ssm_scan"]),
                       "plain_ms": time_cuda(lambda: ref.ssm_scan_ref(*args),
                                             reps=3, warmup=1),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bound_unit": b_unit}
    pre = line["prefill"]
    out = {"shape": pre["shape"], "cases": line,
           "max_abs_err": max(max(c["max_abs_err_y"], c["max_abs_err_h_last"])
                              for c in line.values()),
           "match": ok_all, "ms": pre["ms"], "device_ms": pre["device_ms"],
           "plain_ms": pre["plain_ms"],
           "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
           "bound_unit": pre["bound_unit"], "library_ms": None,
           "library": "none: no single PyTorch call computes a selective scan",
           "tolerance": f"y and h_last within {SSM_REL} x (|ref| + max|ref|): "
                        "fp32 with FMA contraction and ex2.approx a few ulps "
                        "from torch.exp, over a recurrence that decays"}
    emit({"phase": "kernels", "kernel": "ssm_scan", **out})
    return out


def phase_kernels(raw, index, queries, n_slice: int, n_dtw: int,
                  scan_in: dict, main_k10, sanitize_blocks: int,
                  shard_blocks: int) -> dict:
    """Every kernel against its plain version at the shapes the paths give
    it.  Beside the main batch, the serving walks' batches: ``serve``'s
    tenants (SERVE_BATCH queries) and the CLI's one-query warm-up on the
    10M index's envelopes, and ``sanitize``'s tenants and their drain
    (SANITIZE_BATCH and SANITIZE_TENANTS x SANITIZE_BATCH queries) on the
    ``sanitize_blocks`` envelopes of its index (the CLI's 4 x 4 queries
    at k=1 take the same two batch sizes); and the main batch on a
    ``dist4`` / ``dist_ooc`` shard's ``shard_blocks`` envelopes."""
    metric = engine.ED()
    prep = engine.prepare(metric, index, queries, 10)
    qs = prep.qs
    dqs = engine.DTW(r=DTW_R).prep_queries(queries[:n_dtw].contiguous(),
                                           w=index.w)
    order, _, _ = engine.block_major_schedule(prep.block_lb)
    topk_panels = walk_topk_panels(index, queries, n_dtw, prep)
    sanitize_qs = (SANITIZE_BATCH, SANITIZE_TENANTS * SANITIZE_BATCH)
    slices = sorted({q for q in (1, SERVE_BATCH, *sanitize_qs)
                     if q < queries.shape[0]})
    return {
        "isax_summarize": _compare_summarize(raw, n_slice),
        "lb_scan": _compare_lb_scan(
            qs.aux[0], index, dqs.aux[2], dqs.aux[3],
            [(qn, nb) for qn in slices for nb in
             ((index.n_blocks, sanitize_blocks) if qn in sanitize_qs
              else (index.n_blocks,))]
            + [(queries.shape[0], min(shard_blocks, index.n_blocks))]),
        "block_topk": _compare_block_topk(topk_panels),
        "fused_panel_topk": _compare_fused(
            index, qs, prep.front.threshold(),
            main_k10.dist[:, -1].double().square().float(), prep.block_lb,
            order, slices),
        "batch_l2": _compare_batch_l2(qs.q, index.raw.reshape(-1, index.n)),
        "dtw_band_panel": _compare_dtw(index, queries[:n_dtw]),
        "ssm_scan": _compare_ssm(scan_in),
    }


def phase_exact(raw, queries, paths: dict) -> None:
    """Brute force over every series with the plain versions, not ``ops``;
    ``paths`` maps a path's name to its {k: (result, seconds)}."""
    q = isax.znorm(queries)
    qn = q.shape[0]
    kmax = max(k for results in paths.values() for k in results)
    best_d = torch.full((qn, kmax), ref.INF, device=q.device)
    best_i = torch.full((qn, kmax), -1, dtype=torch.int32, device=q.device)
    t0 = time.perf_counter()
    for i in range(0, raw.shape[0], SCAN_CHUNK):
        j = min(i + SCAN_CHUNK, raw.shape[0])
        d = ref.batch_l2_ref(q, isax.znorm(raw[i:j]))
        ids = torch.arange(i, j, dtype=torch.int32,
                           device=q.device).expand(qn, -1)
        cd, ci = ref.topk_by_dist_id(d, ids, kmax)
        best_d, best_i = ref.topk_by_dist_id(torch.cat([best_d, cd], 1),
                                             torch.cat([best_i, ci], 1), kmax)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    tol = DIST_REL * 2 * (q * q).sum(1)                  # z-normed: |x|^2 = |q|^2
    line = {"phase": "exact", "scan_seconds": scan_s,
            "tolerance": f"squared distances within {DIST_REL}*(|q|^2+|x|^2)"}
    for name, results in paths.items():
        line[name] = {}
        for k, (res, _) in results.items():
            got_i = res.idx
            want_i, want_d = best_i[:, :k], best_d[:, :k]
            got_d = res.dist.double() ** 2
            dist_ok = bool(((got_d - want_d.double()).abs()
                            <= tol[:, None].double()).all())
            diff = got_i != want_i
            ties_ok = True
            if bool(diff.any()):
                qi, ri = torch.nonzero(diff, as_tuple=True)
                x = isax.znorm(raw[got_i[qi, ri].long()])
                dk = ((q[qi] - x) ** 2).sum(1)
                ties_ok = bool(((dk - want_d[qi, ri]).abs() <= tol[qi]).all())
            line[name][f"k{k}"] = {
                "ids_equal": int((~diff).sum()), "near_ties": int(diff.sum()),
                "max_sq_dist_err": float((got_d - want_d.double())
                                         .abs().max())}
            check(dist_ok and ties_ok, f"exact {name} k={k}: answers equal "
                                       "the brute-force scan (ids, but near "
                                       "ties)")
    emit(line)


def _drop_page_cache(path: Path) -> bool:
    """Ask the kernel to drop ``path``'s clean pages, so the next read of
    it goes to the disk.  -> whether the advice was accepted."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        return True
    except (OSError, AttributeError):
        return False


def _ooc_series(args, n_series: int) -> tuple[int, dict]:
    """How many series the on-disk phase writes: ``--ooc-series`` (all of
    them by default), cut in whole millions until the series file, the
    index file and the build's run and merge files take at most half the
    free disk.  -> (n, the disk line)."""
    OOC_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(OOC_DIR).free
    want = min(args.ooc_series or n_series, n_series)
    n = want
    while n > 0 and 2 * n * OOC_BYTES_PER_SERIES > free:
        n = (n - 1) // 1_000_000 * 1_000_000
    line = {"dir": str(OOC_DIR), "free_bytes": free,
            "bytes_per_series": OOC_BYTES_PER_SERIES,
            "needed_bytes": n * OOC_BYTES_PER_SERIES, "series": n}
    if n < want:
        line["cut"] = (f"series cut from {want} to {n}: the files must fit "
                       "in half the free disk")
    return n, line


def _ids_agree(name: str, got, want, q, raw) -> dict:
    """phase_exact's rule: ids equal, but where the two differ the id
    returned lies at a near tie (its true squared distance within
    DIST_REL * (|q|^2 + |x|^2) of the wanted one)."""
    tol = DIST_REL * 2 * (q * q).sum(1)
    want_d = want.dist.double() ** 2
    diff = got.idx != want.idx
    ties_ok = True
    if bool(diff.any()):
        qi, ri = torch.nonzero(diff, as_tuple=True)
        x = isax.znorm(raw[got.idx[qi, ri].long()])
        dk = ((q[qi] - x) ** 2).sum(1).double()
        ties_ok = bool(((dk - want_d[qi, ri]).abs() <= tol[qi]).all())
    check(ties_ok, f"{name}: ids equal (but near ties)")
    return {"ids_equal": int((~diff).sum()), "near_ties": int(diff.sum())}


def _bitwise(a, b) -> bool:
    return (torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)
            and all(torch.equal(x, y) for x, y in zip(a.stats, b.stats)))


def _io_line(res, secs: float, tel: dict | None = None) -> dict:
    io = res.io
    line = {"seconds": secs, "bytes_read": io.bytes_read,
            "read_fraction": io.read_fraction,
            "blocks_fetched": io.blocks_fetched, "cache_hits": io.cache_hits,
            "blocks_refined": io.blocks_refined}
    if tel is not None:
        line.update({key: tel[key] for key in
                     ("syncs", "dispatches", "walk_blocks",
                      "demand_misses") if key in tel})
    return line


def phase_ooc(args, raw, index, queries, refs: dict, dtw_res
              ) -> tuple[dict, dict | None]:
    """The on-disk index: the series written to a headerless file, the
    staged pipeline build, the file against the in-memory index bit for
    bit, the cached walk (ED at two pipeline settings, a warm repeat,
    DTW) against the in-memory answers.  The files stay under
    ``OOC_DIR`` for the later phases (the caller removes them).  -> (the
    phase's launches, {"n", "series", "index", "ucr10"} for the later
    phases, or None when the disk could not hold the files)."""
    n_all = raw.shape[0]
    n, disk = _ooc_series(args, n_all)
    line = {"phase": "ooc", "disk": disk, "capacity": CAPACITY,
            "shards": OOC_SHARDS, "workers": OOC_WORKERS,
            "cache_blocks": OOC_CACHE_BLOCKS}
    launches: dict[str, int] = {}

    def count(kernels: tuple, what: str) -> None:
        got = ops.launch_counts()
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c
        for name in kernels:
            check(got[name] > 0, f"kernel {name} launched on the ooc path "
                                 f"({what})")

    if not check(n > 0, "the disk holds the on-disk phase's files"):
        emit(line)
        return launches, None
    sub = raw[:n]
    if n < n_all:       # the cut: its own in-memory index and answers
        index = core.build(sub, capacity=CAPACITY)
        refs = {"block_major": {k: (core.search_block_major(
                    index, queries, k=k), 0.0) for k in (1, 10)},
                "ucr": {10: (core.search_scan(sub, queries, k=10), 0.0)}}
        dtw_res = dtw.search_dtw(index, queries[:args.dtw_queries]
                                 .contiguous(), r=DTW_R, k=10)
    # 1. the series, as the headerless f32 file users hand a build
    series = OOC_DIR / "series.f32"
    t0 = time.perf_counter()
    for i in range(0, n, SCAN_CHUNK):
        storage.SeriesStore.append(series,
                                   sub[i:i + SCAN_CHUNK].cpu().numpy())
    store = storage.SeriesStore(series, length=LENGTH)
    line["series_write_seconds"] = time.perf_counter() - t0
    line["series_bytes"] = store.nbytes

    # 2. the staged build (pipeline_build is run_pipeline + open_index;
    # the two are called apart to read the BuildReport)
    path = OOC_DIR / "index.dsix"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, report = storage.run_pipeline(store, path, capacity=CAPACITY,
                                     shards=OOC_SHARDS,
                                     workers=OOC_WORKERS)
    torch.cuda.synchronize()
    count(("isax_summarize",), "build")
    line["build"] = {"seconds": time.perf_counter() - t0,
                     "file_bytes": os.path.getsize(path),
                     "report": report.as_dict()}
    opened = storage.open_index(path)

    # 3. the file against the in-memory index, bit for bit
    same = all(torch.equal(getattr(opened, f), getattr(index, f))
               for f in ("ids", "slo", "shi", "elo", "ehi"))
    check(same, "ooc: ids/slo/shi/elo/ehi of the pipeline's file "
                "bitwise equal core.build's")
    raw_same = True
    mm = opened.host_raw.blocks
    # read from the disk: the rate bounds a cold walk that reads it all
    dropped = _drop_page_cache(path)
    t0 = time.perf_counter()
    for b0 in range(0, opened.n_blocks, OOC_COMPARE_BLOCKS):
        b1 = min(b0 + OOC_COMPARE_BLOCKS, opened.n_blocks)
        part = torch.from_numpy(np.array(mm[b0:b1])).to(index.raw.device)
        raw_same &= torch.equal(part, index.raw[b0:b1])
    secs = time.perf_counter() - t0
    check(raw_same, "ooc: the pipeline's raw section torch.equal "
                    "core.build's index.raw")
    line["byte_identity"] = {"summaries": same, "raw": raw_same}
    line["raw_sequential_read"] = {
        "page_cache_dropped": dropped, "seconds": secs,
        "bytes_per_s": mm.nbytes / secs,
        "what": "the raw section read in 256-block steps from the disk "
                "into the card and compared, one thread"}

    # 4. the ED walk from the disk, at two pipeline settings
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walks = {}
    q = isax.znorm(queries)
    for d, g in OOC_SETTINGS:
        for k in (1, 10):
            dropped = _drop_page_cache(path)
            tel: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = storage.ooc_search(opened, queries, k=k,
                                     cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g,
                                     telemetry=tel)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            walks[(d, g, k)] = res
            bm = refs["block_major"][k][0]
            entry = {"page_cache_dropped": dropped,
                     **_io_line(res, secs, tel),
                     "vs_block_major": _ids_agree(
                         f"ooc ({d}, {g}) k={k} vs block-major", res, bm,
                         q, raw)}
            if k in refs["ucr"]:
                entry["vs_ucr"] = _ids_agree(
                    f"ooc ({d}, {g}) k={k} vs UCR", res,
                    refs["ucr"][k][0], q, raw)
            gd, wd = res.dist.double() ** 2, bm.dist.double() ** 2
            check(bool(((gd - wd).abs() <= 1e-5 * wd + 1e-6).all()),
                  f"ooc ({d}, {g}) k={k}: squared distances within "
                  "rtol 1e-5 of block-major's")
            line[f"ed_d{d}_g{g}_k{k}"] = entry
    count(("lb_scan", "fused_panel_topk"), "ED walk")
    (d0, g0), (d1, g1) = OOC_SETTINGS
    for k in (1, 10):
        check(_bitwise(walks[(d0, g0, k)], walks[(d1, g1, k)]),
              f"ooc k={k}: ({d0}, {g0}) and ({d1}, {g1}) bitwise equal "
              "in dist, idx and every SearchStats counter")
    line["ed_max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # 5. a warm repeat through a session that holds every block
    _drop_page_cache(path)
    with storage.SearchSession(opened,
                               cache_blocks=max(opened.n_blocks, d1 + g1),
                               pipeline_depth=d1,
                               group_blocks=g1) as sess:
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.search(queries, k=10)
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0,
                         dict(sess.last_telemetry)))
        check(_bitwise(runs[0][0], runs[1][0]),
              "ooc warm repeat bitwise equal the cold batch")
        check(runs[1][0].io.bytes_read == 0,
              "ooc warm repeat read 0 bytes")
        line["warm"] = {"cold": _io_line(*runs[0]),
                        "warm": _io_line(*runs[1]),
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated()}

        # 6. DTW through the same session
        ops.reset_launch_counts()
        dq = queries[:args.dtw_queries].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.search(dq, k=10, metric=engine.DTW(r=DTW_R))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        count(("lb_scan", "block_topk", "dtw_band_panel"), "DTW walk")
        diff = res.idx != dtw_res.idx
        ties_ok = True
        if bool(diff.any()):
            qz = isax.znorm(dq)
            x = isax.znorm(raw[res.idx.long().flatten()]).reshape(
                res.idx.shape + (LENGTH,))
            dk = ref.dtw_band_panel_ref(qz, x, r=DTW_R).double()
            wd = dtw_res.dist.double() ** 2
            ties_ok = bool(((dk - wd).abs()
                            <= DIST_REL * wd + 1e-6)[diff].all())
        check(ties_ok, "ooc DTW k=10: ids equal phase dtw's (but near "
                       "ties)")
        line["dtw"] = {"r": DTW_R, "queries": dq.shape[0],
                       **_io_line(res, secs, sess.last_telemetry),
                       "ids_equal": int((~diff).sum()),
                       "near_ties": int(diff.sum())}
    line["launches"] = launches
    emit(line)
    return launches, {"n": n, "series": series, "index": path,
                      "ucr10": refs["ucr"][10][0]}


# ---------------------------------------------------------------------------
# the distributed protocol and search serving
# ---------------------------------------------------------------------------

class _SeriesRows:
    """Rows of the series file by id, on the card: ``_ids_agree``'s raw
    once the in-memory series are gone from the card."""

    def __init__(self, store, device):
        self.mm = store.memmap()
        self.device = device

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        rows = np.asarray(self.mm[ids.cpu().numpy()], dtype=np.float32)
        return torch.from_numpy(rows).to(self.device)


def _dist_ok(name: str, res, want, q, raw) -> dict:
    """The ids against a brute-force answer under ``exact``'s rule, the
    squared distances within DIST_REL * (|q|^2 + |x|^2) of it."""
    tol = DIST_REL * 2 * (q * q).sum(1)
    k = res.idx.shape[1]
    want = want._replace(dist=want.dist[:, :k], idx=want.idx[:, :k])
    gd, wd = res.dist.double() ** 2, want.dist.double() ** 2
    check(bool(((gd - wd).abs() <= tol[:, None].double()).all()),
          f"{name}: squared distances within {DIST_REL} x (|q|^2 + |x|^2) "
          "of the brute-force scan's")
    return {**_ids_agree(name, res, want, q, raw),
            "max_sq_dist_err": float((gd - wd).abs().max())}


def _group_init(name: str) -> str:
    """A fresh ``file://`` store for a process group, under build/."""
    path = ROOT / "build" / f"{name}.store"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    return f"file://{path}"


def phase_dist1(index, queries, bm: dict) -> dict:
    """``distributed.search_sharded`` on a world-size-1 NCCL group over the
    main index: with one shard the global threshold is the shard's own,
    so the answer and every counter must be bitwise block-major's."""
    import torch.distributed as tdist
    from datetime import timedelta
    tdist.init_process_group(DIST1_BACKEND, init_method=_group_init("dist1"),
                             world_size=1, rank=0,
                             timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        results, lines, launches = run_path(
            "block_major",
            lambda k: distributed.search_sharded(index, queries, k=k),
            ks=(10,))
        res = results[10][0]
        same = _bitwise(res, bm[10][0])
        check(same, "dist1: search_sharded on one rank bitwise equals "
                    "search_block_major (dist, idx, every counter)")
        emit({"phase": "dist1", "backend": tdist.get_backend(),
              "world_size": tdist.get_world_size(), "launches": launches,
              "bitwise_block_major": same, **lines})
    finally:
        tdist.destroy_process_group()
    return launches


def phase_serve(args, ooc: dict) -> dict:
    """Multi-tenant serving on the on-disk index: 4 tenant threads x 25
    near-data queries in one coalesced drain, each tenant bitwise its
    isolated ``SearchSession.search``; an anytime answer whose certificate
    brackets the exact k-th distance and whose ``refine_to_exact`` is
    bitwise the exact answer; and the ``launch.serve --search-index`` CLI
    once, as a subprocess, with 4 queries a tenant (its default) at
    k=``SERVE_CLI_K``.  Sessions walk at (pipeline_depth, group_blocks) =
    ``WALK_PIPELINE``; the index file stays in the page cache (the ooc
    phase just read it), so the phase times the walks, not the disk."""
    path = ooc["index"]
    opened = storage.open_index(path)
    loads = serve.tenant_traffic(opened, args.seed, SERVE_TENANTS,
                                 SERVE_BATCH)
    d, g = WALK_PIPELINE
    line = {"phase": "serve", "tenants": SERVE_TENANTS,
            "batch": SERVE_BATCH, "k": SERVE_K,
            "cache_blocks": OOC_CACHE_BLOCKS, "pipeline": [d, g],
            "n_blocks": opened.n_blocks, "page_cache": "warm"}

    def session():
        return storage.SearchSession(opened, cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g)

    torch.cuda.synchronize()
    ops.reset_launch_counts()

    # 1. every tenant alone, each in a fresh session
    isolated, fetched, t0 = [], 0, time.perf_counter()
    for q in loads:
        with session() as sess:
            isolated.append(sess.search(q, k=SERVE_K))
            fetched += sess.blocks_fetched
    torch.cuda.synchronize()
    line["isolated"] = {"seconds": time.perf_counter() - t0,
                        "disk_blocks": fetched}

    # 2. the same tenants as threads through one coalesced drain
    results: list = [None] * SERVE_TENANTS
    errors: list = []
    with session() as sess:
        admitted = threading.Barrier(SERVE_TENANTS)

        def tenant(i):
            try:
                t = sess.submit(loads[i], k=SERVE_K)
                admitted.wait(timeout=DIST_TIMEOUT_S)
                results[i] = t.result(timeout=DIST_TIMEOUT_S)
            except BaseException as e:     # reported as a failed check
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(SERVE_TENANTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=DIST_TIMEOUT_S)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(not errors and not any(th.is_alive() for th in threads),
              f"serve: every tenant thread answered ({errors})")
        drain_blocks = sess.blocks_fetched
        line["coalesced"] = {"seconds": secs, "disk_blocks": drain_blocks,
                             "batches_billed": sess.batches,
                             "hit_rate": sess.hit_rate}
    same = all(r is not None and torch.equal(r.idx, w.idx)
               and torch.equal(r.dist, w.dist)
               for r, w in zip(results, isolated))
    check(same, "serve: each tenant's coalesced answer bitwise its isolated "
                "SearchSession.search")
    check(drain_blocks <= fetched, "serve: the drain read no more disk "
                                   "blocks than the isolated runs together")
    line["coalesced"]["bitwise_isolated"] = same

    # 3. an anytime answer, certified, then refined to exact
    exact = isolated[0]
    with session() as sess:
        t0 = time.perf_counter()
        a = sess.search(loads[0], k=SERVE_K, deadline_blocks=SERVE_DEADLINE)
        torch.cuda.synchronize()
        anytime_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex = a.refine_to_exact()
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
    c = a.certificate
    kth = exact.dist[:, -1].cpu().numpy()
    brackets = bool((c.lower <= kth + 1e-5 * np.abs(kth)).all()
                    and (c.upper >= kth - 1e-5 * np.abs(kth)).all())
    check(brackets, "serve: the anytime certificate brackets the exact "
                    "k-th distance")
    refined_same = _bitwise(ex, exact)
    check(refined_same, "serve: refine_to_exact bitwise the exact answer "
                        "(dist, idx, every counter)")
    line["anytime"] = {"deadline_blocks": SERVE_DEADLINE,
                       "seconds": anytime_s, "refine_seconds": refine_s,
                       "gap_mean": float(c.gap.mean()),
                       "gap_max": float(c.gap.max()),
                       "certified_exact": int(c.exact.sum()),
                       "blocks_deferred_max": int(c.blocks_deferred.max()),
                       "refine_disk_blocks": ex.io.blocks_fetched,
                       "brackets": brackets,
                       "refine_bitwise_exact": refined_same}
    launches = ops.launch_counts()
    for name in ("lb_scan", "fused_panel_topk"):
        check(launches[name] > 0, f"kernel {name} launched on the serve path")
    line["launches"] = launches

    # 4. the serving CLI, once, in its own process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--search-index",
         str(path), "--tenants", str(SERVE_TENANTS), "--k",
         str(SERVE_CLI_K), "--deadline-blocks", str(SERVE_DEADLINE),
         "--seed", str(args.seed), "--device", str(opened.ids.device)],
        capture_output=True, text=True, env=env, timeout=DIST_TIMEOUT_S)
    out = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and "certificate verified True" in cli.stdout,
          f"serve: launch.serve --search-index exits 0 with a verified "
          f"certificate (rc {cli.returncode}: {cli.stderr[-2000:]})")
    line["cli"] = {"returncode": cli.returncode, "k": SERVE_CLI_K,
                   "cut": "k cut from the CLI's default 5 to "
                          f"{SERVE_CLI_K} for the time limit: at k=5 its "
                          "4 x 4 near-data queries walk ~7,700 of the "
                          "9,766 blocks",
                   "seconds": time.perf_counter() - t0, "stdout": out}
    emit(line)
    return launches


# ---------------------------------------------------------------------------
# static analysis and the runtime lock sanitizer
# ---------------------------------------------------------------------------

def phase_analysis() -> None:
    """The port's checkers (``repro_torch.analysis``: lock discipline,
    host syncs, kernel/oracle contracts) over ``src/repro_torch``, in
    process: any finding fails the run.  Prints the sanctioned ``# sync``
    sites of ``core/engine.py`` grouped by the frequency each comment
    states: the device->host transfers of the walks."""
    from repro_torch.analysis import cli, run_analysis
    from repro_torch.analysis import syncs as syncs_lib
    t0 = time.perf_counter()
    project, errors = cli.load_project([str(ROOT / "src" / "repro_torch")])
    findings = errors + run_analysis(project)
    check(not findings, "analysis: the port's checkers find nothing ("
          + "; ".join(f.text() for f in findings[:20]) + ")")
    eng = project.by_module.get("repro_torch.core.engine")
    check(eng is not None and eng.sync_trace_module(),
          "analysis: core/engine.py carries '# repro: sync-trace'")
    sites: dict[str, list[int]] = {}
    for ln, freq in (syncs_lib.sync_sites(eng) if eng else []):
        sites.setdefault(freq, []).append(ln)
    emit({"phase": "analysis", "files": len(project.files),
          "findings": len(findings),
          "engine_sync_sites": {f: {"count": len(v), "lines": v}
                                for f, v in sorted(sites.items())},
          "seconds": time.perf_counter() - t0})


def sanitize_child(cfg_path: str) -> int:
    """``phase_sanitize``'s subprocess, started with ``REPRO_SANITIZE=1``
    (the guarded classes read it when they are decorated, at import):
    the sanitizer armed, one deliberate off-lock write caught, the
    pipeline build of the phase's rows, and the tenants served isolated
    and through one coalesced drain from threads, on the index file of
    those rows that the main process built unsanitized.  Writes its
    numbers and answers beside ``cfg_path``; -> 0 if every check
    passed."""
    from repro_torch.analysis import sanitize
    from repro_torch.storage.format import IndexFileWriter
    cfg = json.loads(Path(cfg_path).read_text())
    work = Path(cfg_path).parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info: dict = {"seconds": {}, "launches": {}}

    def lap(step: str, t0: float) -> None:
        torch.cuda.synchronize()
        info["seconds"][step] = time.perf_counter() - t0

    # 1. armed: the guarded classes hold instrumented locks
    t0 = time.perf_counter()
    opened = storage.open_index(cfg["index"])
    d, g = WALK_PIPELINE

    def session():
        return storage.SearchSession(opened, cache_blocks=OOC_CACHE_BLOCKS,
                                     pipeline_depth=d, group_blocks=g)

    with session() as sess:
        info["locks"] = {"session": type(sess._coalescer_lock).__name__,
                         "cache": type(sess.cache._lock).__name__}
    info["enabled"] = sanitize.enabled()
    check(info["enabled"] and set(info["locks"].values())
          == {"InstrumentedLock"}, "sanitize: REPRO_SANITIZE=1 armed the "
          f"sanitizer and the session's locks ({info['locks']})")
    lap("open", t0)

    # 2. one deliberate off-lock write to a guarded field
    wr = IndexFileWriter(work / "probe.dsix", n=8, w=4, card=4, capacity=4,
                         n_real=16, n_blocks=4,
                         tmp_path=work / "probe.partial")
    try:
        wr.append_raw_rows(np.zeros((4, 8), np.float32))   # locked path
        with wr._lock:
            wr._raw_rows = 0                               # held: fine
        try:
            wr._raw_rows = 7                               # off-lock
            caught = False
        except sanitize.SanitizeError:
            caught = True
    finally:
        wr.abort()
    info["offlock_write_caught"] = caught
    check(caught, "sanitize: an off-lock write to IndexFileWriter._raw_rows "
                  "raised SanitizeError")

    # 3. the staged build of the phase's rows, sanitized
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, report = storage.run_pipeline(
        storage.SeriesStore(cfg["series"], length=LENGTH), cfg["sanitized"],
        capacity=CAPACITY, shards=OOC_SHARDS, workers=OOC_WORKERS)
    lap("build", t0)
    info["launches"]["build"] = ops.launch_counts()
    info["build_report"] = report.as_dict()
    check(info["launches"]["build"]["isax_summarize"] > 0,
          "kernel isax_summarize launched on the sanitized build")

    # 4. the tenants alone, then from threads through one coalesced drain
    loads = serve.tenant_traffic(opened, cfg["seed"], SANITIZE_TENANTS,
                                 SANITIZE_BATCH)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    isolated = []
    for q in loads:
        with session() as sess:
            isolated.append(sess.search(q, k=SERVE_K))
    lap("isolated", t0)
    results: list = [None] * SANITIZE_TENANTS
    errors: list = []
    t0 = time.perf_counter()
    with session() as sess:
        admitted = threading.Barrier(SANITIZE_TENANTS)

        def tenant(i):
            try:
                t = sess.submit(loads[i], k=SERVE_K)
                admitted.wait(timeout=DIST_TIMEOUT_S)
                results[i] = t.result(timeout=DIST_TIMEOUT_S)
            except BaseException as e:     # reported as a failed check
                errors.append(repr(e))

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(SANITIZE_TENANTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=DIST_TIMEOUT_S)
        alive = any(th.is_alive() for th in threads)
    lap("drain", t0)
    info["launches"]["walk"] = ops.launch_counts()
    for name in ("lb_scan", "fused_panel_topk"):
        check(info["launches"]["walk"][name] > 0,
              f"kernel {name} launched on the sanitized walks")
    check(not errors and not alive, "sanitize: every tenant thread's ticket "
          f"resolved with no SanitizeError ({errors})")
    same = all(r is not None and torch.equal(r.idx, w.idx)
               and torch.equal(r.dist, w.dist)
               for r, w in zip(results, isolated))
    info["drain_bitwise_isolated"] = same
    check(same, "sanitize: each tenant's drained answer bitwise its "
                "isolated SearchSession.search")
    if same:
        np.savez(work / "answers.npz",
                 queries=torch.cat(loads).cpu().numpy(),
                 idx=torch.cat([r.idx for r in results]).cpu().numpy(),
                 dist=torch.cat([r.dist for r in results]).cpu().numpy())
    (work / "child.json").write_text(json.dumps(info))
    return 1 if FAILURES else 0


def phase_sanitize(args, ooc: dict, raw, lb_blocks: int) -> dict:
    """The port's classes under the runtime lock sanitizer.  The first
    ``SANITIZE_ROWS`` rows of the on-disk phase's series file are built
    here unsanitized; a subprocess started with ``REPRO_SANITIZE=1``
    (``sanitize_child``) then builds the same rows and serves
    ``SANITIZE_TENANTS`` x ``SANITIZE_BATCH`` near-data queries at k=10
    on the unsanitized file, isolated and through one drain from
    threads (on the 10M file the walks would take ~35 s of a phase meant
    for well under a minute).  Its file must equal the unsanitized one
    byte for byte, and its drained ids the brute-force scan's over those
    rows under ``exact``'s rule.  ``lb_blocks`` are the envelope widths
    ``phase_kernels`` checked ``lb_scan`` at; the index's must be one."""
    work = OOC_DIR / "sanitize"
    work.mkdir(parents=True, exist_ok=True)
    m = min(SANITIZE_ROWS, ooc["n"])
    line = {"phase": "sanitize", "rows": m, "tenants": SANITIZE_TENANTS,
            "batch": SANITIZE_BATCH, "k": SERVE_K,
            "pipeline": list(WALK_PIPELINE), "seconds": {}}
    # 1. the phase's rows, as their own series file
    t0 = time.perf_counter()
    src = storage.SeriesStore(ooc["series"], length=LENGTH)
    series = work / "series.f32"
    for i in range(0, m, SCAN_CHUNK):
        storage.SeriesStore.append(series, src.read(i, min(i + SCAN_CHUNK,
                                                           m)))
    line["seconds"]["series"] = time.perf_counter() - t0
    # 2. the unsanitized build of those rows: the walks' index
    t0 = time.perf_counter()
    plain = work / "plain.dsix"
    storage.run_pipeline(storage.SeriesStore(series, length=LENGTH), plain,
                         capacity=CAPACITY, shards=OOC_SHARDS,
                         workers=OOC_WORKERS)
    torch.cuda.synchronize()
    line["seconds"]["plain_build"] = time.perf_counter() - t0
    n_blocks = -(-m // CAPACITY)
    line["n_blocks"] = n_blocks
    check(n_blocks == lb_blocks, f"sanitize: the walks' {n_blocks} envelope "
          f"blocks are the {lb_blocks} lb_scan was checked at")
    # 3. the sanitized subprocess
    cfg = work / "cfg.json"
    cfg.write_text(json.dumps({"index": str(plain),
                               "series": str(series),
                               "sanitized": str(work / "sanitized.dsix"),
                               "seed": args.seed}))
    env = dict(os.environ, REPRO_SANITIZE="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.sanitize_child(sys.argv[1]))", str(cfg)],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=DIST_RANKS_TIMEOUT_S)
    line["seconds"]["child"] = time.perf_counter() - t0
    check(child.returncode == 0, "sanitize: the REPRO_SANITIZE=1 subprocess "
          f"exits 0 (rc {child.returncode}: {child.stderr[-3000:]})")
    info = (json.loads((work / "child.json").read_text())
            if (work / "child.json").exists() else {})
    line["child"] = info
    # 4. the sanitized build's file, byte for byte the unsanitized one's
    t0 = time.perf_counter()
    same = (work / "sanitized.dsix").exists() and filecmp.cmp(
        plain, work / "sanitized.dsix", shallow=False)
    line["seconds"]["compare"] = time.perf_counter() - t0
    line["build_bitwise_unsanitized"] = same
    check(same, "sanitize: the sanitized pipeline's file is bitwise the "
                "unsanitized one's")
    # 5. the drained answers against the brute-force scan
    answers = work / "answers.npz"
    if check(answers.exists(), "sanitize: the subprocess wrote its answers"):
        ans = np.load(answers)
        dev = raw.device
        q = torch.from_numpy(ans["queries"]).to(dev)
        got = core.SearchResult(
            dist=torch.from_numpy(ans["dist"]).to(dev),
            idx=torch.from_numpy(ans["idx"]).to(dev), stats=None)
        t0 = time.perf_counter()
        want = core.search_scan(raw[:m], q, k=SERVE_K)
        torch.cuda.synchronize()
        line["seconds"]["scan"] = time.perf_counter() - t0
        line["vs_brute_force"] = _dist_ok("sanitize drain k=10", got, want,
                                          isax.znorm(q), raw)
    shutil.rmtree(work, ignore_errors=True)
    launches: dict[str, int] = {}
    for counts in info.get("launches", {}).values():
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    for name in ("isax_summarize", "lb_scan", "fused_panel_topk"):
        check(launches.get(name, 0) > 0,
              f"kernel {name} launched on the sanitize path")
    line["launches"] = launches
    emit(line)
    return launches

DIST4_CASES = ("block_major_k1", "block_major_k10", "query_major_k10",
               "scan_k10")
DIST4_KERNELS = {"block_major_k1": PATH_KERNELS["block_major"],
                 "block_major_k10": PATH_KERNELS["block_major"],
                 "query_major_k10": PATH_KERNELS["query_major"],
                 "scan_k10": PATH_KERNELS["ucr"]}


def _dist4_rank(rank: int, cfg: dict) -> None:
    """One rank of ``phase_dist4`` (a spawned process): its range of the
    series file, its shard with global ids, the sharded searches between
    barriers, its shard saved; results to ``cfg["out"]``."""
    import torch.distributed as tdist
    from datetime import timedelta
    started = time.time() - cfg["t0"]
    dev = torch.device(cfg["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    world = cfg["world"]
    tdist.init_process_group("gloo", init_method=cfg["init"],
                             world_size=world, rank=rank,
                             timeout=timedelta(seconds=cfg["timeout"]))
    grouped = time.time() - cfg["t0"]
    try:
        per = cfg["n"] // world
        lo = rank * per
        store = storage.SeriesStore(cfg["series"], length=LENGTH)
        t0 = time.perf_counter()
        rows = store.read(lo, lo + per)
        read_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        local = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        shard = distributed.build_sharded(local, lo, capacity=CAPACITY,
                                          device=dev)
        sync()
        info = {"rank": rank, "rows": [lo, lo + per], "started": started,
                "grouped": grouped, "read_seconds": read_s,
                "build_seconds": time.perf_counter() - t0,
                "launches": {"build": ops.launch_counts()}, "seconds": {}}
        q = torch.from_numpy(np.load(cfg["queries"])).to(dev)
        runs = {
            "block_major_k1": lambda: distributed.search_sharded(
                shard, q, k=1, device=dev),
            "block_major_k10": lambda: distributed.search_sharded(
                shard, q, k=10, device=dev),
            "query_major_k10": lambda: distributed.search_sharded(
                shard, q, k=10, schedule="query_major",
                blocks_per_iter=QUERY_MAJOR_BLOCKS, device=dev),
            "scan_k10": lambda: distributed.search_sharded_scan(
                local, lo, q, k=10, device=dev),
        }
        out = {}
        for name in DIST4_CASES:
            tdist.barrier()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = runs[name]()
            sync()
            tdist.barrier()
            info["seconds"][name] = time.perf_counter() - t0
            info["launches"][name] = ops.launch_counts()
            out[name + "_dist"] = res.dist.cpu().numpy()
            out[name + "_idx"] = res.idx.cpu().numpy()
            for f in res.stats._fields:
                out[name + "_" + f] = getattr(res.stats, f).cpu().numpy()
        info["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                        if cuda else None)
        t0 = time.perf_counter()
        storage.save_index(shard, cfg["shards"][rank])
        info["save_seconds"] = time.perf_counter() - t0
        np.savez(Path(cfg["out"]) / f"rank{rank}.npz", **out)
        tdist.barrier()
        info["done"] = time.time() - cfg["t0"]
        (Path(cfg["out"]) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        tdist.destroy_process_group()


def _spawn_ranks(fn, world: int, cfg: dict, timeout_s: float) -> bool:
    """Run ``fn(rank, cfg)`` in ``world`` spawned processes; -> whether
    every rank ended cleanly within ``timeout_s``.  A rank that raises or
    dies, or a run past the limit (the others are then killed), fails."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=(cfg,), nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                check(False, f"{world} ranks ended within {timeout_s} s")
                return False
        return True
    except Exception as e:     # torch's ProcessRaisedException / ...Exited
        check(False, f"every rank ended cleanly: {e}")
        return False
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)


def phase_dist4(args, ooc: dict, queries_np: np.ndarray) -> dict:
    """The two-round protocol across 4 processes on the one card, over
    gloo: each rank builds its quarter of the on-disk phase's series file
    with global ids, runs ``search_sharded`` (block-major k=1 and 10,
    query-major k=10) and ``search_sharded_scan`` (k=10), and saves its
    shard for ``dist_ooc``.  The ids are checked against the brute-force
    scan, and every rank must hold the same answer."""
    n, ref = ooc["n"], ooc["ucr10"]
    dev = ref.dist.device
    out = OOC_DIR / "dist4"
    out.mkdir(parents=True, exist_ok=True)
    # the queries go by file: a spawn argument over the pipe's 64 KiB
    # blocks each start until that child has imported this module
    np.save(out / "queries.npy", queries_np)
    cfg = {"world": DIST_WORLD, "n": n, "series": str(ooc["series"]),
           "queries": str(out / "queries.npy"), "out": str(out),
           "device": str(dev),
           "init": _group_init("dist4"), "timeout": DIST_TIMEOUT_S,
           "t0": time.time(),
           "shards": [str(OOC_DIR / f"shard{r}.dsix")
                      for r in range(DIST_WORLD)]}
    line = {"phase": "dist4", "world_size": DIST_WORLD, "backend": "gloo",
            "series": n, "series_per_rank": n // DIST_WORLD,
            "queries": queries_np.shape[0]}
    launches: dict[str, int] = {}
    if not check(n % DIST_WORLD == 0, f"dist4: the {n} series divide "
                                      f"into {DIST_WORLD} equal ranges"):
        emit(line)
        return launches
    t0 = time.perf_counter()
    ok = _spawn_ranks(_dist4_rank, DIST_WORLD, cfg, DIST_RANKS_TIMEOUT_S)
    line["seconds"] = time.perf_counter() - t0
    if not ok:
        emit(line)
        return launches
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(DIST_WORLD)]
    infos = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(DIST_WORLD)]
    check(all(Path(f).exists() for f in cfg["shards"]),
          "dist4: every rank saved its shard")
    # started / grouped / done: seconds after the spawn to the rank's
    # first line, to its group's forming, to its last barrier
    line["ranks"] = [{key: i[key] for key in
                      ("rank", "rows", "started", "grouped", "read_seconds",
                       "build_seconds", "save_seconds", "done",
                       "max_memory_allocated")}
                     for i in infos]
    q = isax.znorm(torch.from_numpy(queries_np).to(dev))
    rows = _SeriesRows(storage.SeriesStore(ooc["series"], length=LENGTH),
                       dev)
    for name in DIST4_CASES:
        r0 = ranks[0]
        same = all(np.array_equal(r[key], r0[key]) for r in ranks[1:]
                   for key in r0 if key.startswith(name + "_"))
        check(same, f"dist4 {name}: every rank holds the same answer")
        res = core.SearchResult(
            dist=torch.from_numpy(r0[name + "_dist"]).to(dev),
            idx=torch.from_numpy(r0[name + "_idx"]).to(dev),
            stats=core.SearchStats(*(torch.from_numpy(r0[name + "_" + f])
                                     for f in core.SearchStats._fields)))
        summed = {p: sum(i["launches"][name][p] for i in infos)
                  for p in infos[0]["launches"][name]}
        for kernel in DIST4_KERNELS[name]:
            check(summed[kernel] > 0, f"kernel {kernel} launched on the "
                                      f"dist4 {name} path")
        for kernel, c in summed.items():
            launches[kernel] = launches.get(kernel, 0) + c
        line[name] = {
            "seconds_rank0": infos[0]["seconds"][name],
            "seconds_by_rank": [i["seconds"][name] for i in infos],
            "blocks_visited_sum": int(res.stats.blocks_visited.sum()),
            "blocks_visited_mean": float(res.stats.blocks_visited.double()
                                         .mean()),
            "series_refined_mean": float(res.stats.series_refined.double()
                                         .mean()),
            "iters": int(res.stats.iters), "launches": summed,
            "ranks_agree": same,
            "vs_brute_force": _dist_ok(f"dist4 {name}", res, ref, q, rows)}
    build = {p: sum(i["launches"]["build"][p] for i in infos)
             for p in infos[0]["launches"]["build"]}
    check(build["isax_summarize"] > 0,
          "kernel isax_summarize launched on the dist4 build")
    launches["isax_summarize"] = (launches.get("isax_summarize", 0)
                                  + build["isax_summarize"])
    line["launches"] = launches
    emit(line)
    return launches


def phase_dist_ooc(ooc: dict, queries) -> dict:
    """``search_sharded_ooc`` over 4 ``SearchSession``s on dist4's shard
    files, from a cold disk, k=10, at ``WALK_PIPELINE``, checked against
    the brute-force scan."""
    shards = [OOC_DIR / f"shard{r}.dsix" for r in range(DIST_WORLD)]
    line = {"phase": "dist_ooc", "shards": DIST_WORLD,
            "cache_blocks": OOC_CACHE_BLOCKS}
    if not check(all(p.exists() for p in shards),
                 "dist_ooc: dist4's shard files exist"):
        emit(line)
        return {}
    opened = [storage.open_index(p) for p in shards]
    dropped = all([_drop_page_cache(p) for p in shards])
    d, g = WALK_PIPELINE
    line["pipeline"] = [d, g]
    sessions = [storage.SearchSession(o, cache_blocks=OOC_CACHE_BLOCKS,
                                      pipeline_depth=d, group_blocks=g)
                for o in opened]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = distributed.search_sharded_ooc(sessions, queries, k=10)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        for s in sessions:
            s.close()
    for name in ("lb_scan", "fused_panel_topk"):
        check(launches[name] > 0, f"kernel {name} launched on the dist_ooc "
                                  "path")
    q = isax.znorm(queries)
    rows = _SeriesRows(storage.SeriesStore(ooc["series"], length=LENGTH),
                       q.device)
    line.update({"page_cache_dropped": dropped,
                 **_io_line(res, secs),
                 "bytes_scan": res.io.bytes_scan,
                 "blocks_total": res.io.blocks_total,
                 "blocks_visited_sum": int(res.stats.blocks_visited.sum()),
                 "launches": launches,
                 "vs_brute_force": _dist_ok("dist_ooc k=10", res,
                                            ooc["ucr10"], q, rows)})
    emit(line)
    return launches


REPLACES = {
    "isax_summarize": ("src/repro_torch/kernels/csrc/isax_summarize.cu",
                       "src/repro/kernels/isax_summarize.py:41"),
    "lb_scan": ("src/repro_torch/kernels/csrc/lb_scan.cu",
                "src/repro/kernels/lb_scan.py:38"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:78"),
    "fused_panel_topk": ("src/repro_torch/kernels/csrc/fused_refine.cu",
                         "src/repro/kernels/fused_refine.py:91"),
    "batch_l2": ("src/repro_torch/kernels/csrc/batch_l2.cu",
                 "src/repro/kernels/batch_l2.py:36"),
    "dtw_band_panel": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                       "src/repro/kernels/dtw_band.py:66"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:54"),
}

# the path whose launch count the kernels line reports for each kernel
LAUNCH_PATH = {"isax_summarize": "block_major", "lb_scan": "flat",
               "block_topk": "block_major", "fused_panel_topk": "block_major",
               "batch_l2": "flat", "dtw_band_panel": "dtw", "ssm_scan": "lm"}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--dtw-queries", type=int, default=10)
    ap.add_argument("--lm-batch", type=int, default=LM_BATCH)
    ap.add_argument("--lm-prompt", type=int, default=LM_PROMPT)
    ap.add_argument("--lm-gen", type=int, default=LM_GEN)
    ap.add_argument("--lm-smoke", action="store_true",
                    help="the LM phases (lm, dense, train) on smoke() "
                         "configs at --lm-prompt / --lm-gen sizes")
    ap.add_argument("--ooc-series", type=int, default=None,
                    help="series the on-disk phase writes (default all; "
                         "cut in whole millions to fit half the free disk)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.analysis import sanitize
    if sanitize.enabled():
        print("chip_smoke: refusing to time with REPRO_SANITIZE set: the "
              "instrumented locks would be measured instead of the plain "
              "ones (the sanitize phase arms its own subprocess)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # no fp32 product in TF32
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase_build()
    raw = random_walk_cuda(args.n_series, LENGTH, args.seed)
    queries = random_walk_cuda(args.queries, LENGTH, args.seed + 1)
    index, main_results, main_launches = phase_main(args, raw, queries)
    sched_results, launches = phase_schedules(index, queries)
    launches["block_major"] = main_launches
    ucr_results, launches["ucr"] = phase_ucr(raw, queries)
    dtw_results, launches["dtw"] = phase_dtw(
        index, raw, queries[:args.dtw_queries].contiguous(), args.queries)
    launches["lm"], scan_in = phase_lm(args)
    launches["dense"] = phase_dense(args)
    launches["train"] = phase_train(args)
    # the envelope widths of the sanitize phase's index (its rows of the
    # on-disk phase's series) and of a dist4 shard
    ooc_n = min(args.ooc_series or args.n_series, args.n_series)
    sanitize_blocks = -(-min(SANITIZE_ROWS, ooc_n) // CAPACITY)
    lines = phase_kernels(raw, index, queries,
                          min(SUMMARIZE_SLICE, args.n_series),
                          args.dtw_queries, scan_in, main_results[10][0],
                          sanitize_blocks,
                          -(-(ooc_n // DIST_WORLD) // CAPACITY))
    phase_exact(raw, queries, {"block_major": main_results, **sched_results,
                               "ucr": ucr_results})
    try:
        launches["ooc"], ooc = phase_ooc(args, raw, index, queries,
                                         {"block_major": main_results,
                                          "ucr": ucr_results},
                                         dtw_results[10][0])
        launches["dist1"] = phase_dist1(index, queries, main_results)
        if ooc is not None:
            launches["serve"] = phase_serve(args, ooc)
            phase_analysis()
            launches["sanitize"] = phase_sanitize(args, ooc, raw,
                                                  sanitize_blocks)
            # the ranks share the card: free the main process's series
            # and index first
            del raw, index
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            launches["dist4"] = phase_dist4(args, ooc,
                                            queries.cpu().numpy())
            launches["dist_ooc"] = phase_dist_ooc(ooc, queries)
    finally:
        shutil.rmtree(OOC_DIR, ignore_errors=True)

    kernels = []
    for name, line in lines.items():
        source, replaces = REPLACES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[LAUNCH_PATH[name]][name],
                        "launches_path": LAUNCH_PATH[name],
                        "launches_by_path": {p: c[name] for p, c in
                                             launches.items() if c.get(name)},
                        "match": line["match"],
                        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
                        "device_ms": line["device_ms"],
                        "plain_ms": line["plain_ms"],
                        "bound_ms": line["bound_ms"],
                        "bound_by": line["bound_by"],
                        "bound_unit": line["bound_unit"],
                        "library_ms": line["library_ms"],
                        **({"cases": line["cases"]}
                           if name == "lb_scan" else {})})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
