#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--n-series 10000000] [--queries 100]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each printing one JSON line:

  1. device   — the card's name and count, and nvidia-smi's name and
                power limit; fails without a card;
  2. build    — builds the four CUDA kernels from ``src/repro_torch/kernels/csrc``
                (build seconds, ptxas registers / shared memory / spills);
  3. main     — the main path through the user's entry points:
                ``core.build`` over random-walk series generated on the card
                from ``--seed`` (the paper's Synthetic recipe), then
                ``core.search_block_major`` for k=1 and k=10 on
                ``--queries`` random-walk queries from ``--seed + 1``; the
                kernels' launch counts are set to 0 just before and read
                just after;
  4. kernels  — each kernel against its plain PyTorch version on the card,
                at the main path's shapes and on its data, with the stated
                tolerance, and timed (CUDA events) beside its plain
                version, a library call where one exists, and its bound;
  5. exact    — the index's answers against a brute-force scan of every
                series with the plain ``batch_l2_ref`` + ``topk_by_dist_id``.

Then nvidia-smi's line, the ``{"kernels": [...]}`` line and, if every
check passed, ``{"ok": true, "device": {...}}`` as the last line.  Any
failed check exits non-zero.  TF32 is off for every fp32 product.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.core import engine, frontier, isax  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402
from repro_torch.kernels.fused_refine import fused_panel_topk  # noqa: E402
from repro_torch.kernels.isax_summarize import isax_summarize  # noqa: E402
from repro_torch.kernels.lb_scan import lb_scan  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 rate outside the tensor cores
PAA_RTOL, PAA_ATOL = 1e-6, 1e-5
SAX_FLIP_BAND = 1e-5           # a symbol may differ only this close to a breakpoint
LB_RTOL = 1e-5                 # 16 non-negative terms summed in another order
DIST_REL = 1e-5                # squared-L2 tolerance: DIST_REL * (||q||^2 + ||x||^2)
LENGTH = 256                   # points per series (the paper's Synthetic)
CAPACITY = 1024                # series per block
SUMMARIZE_SLICE = 1_000_000    # series the summarize kernel is checked on

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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    results = {}
    for k in (1, 10):
        t0 = time.perf_counter()
        res = core.search_block_major(index, queries, k=k)
        torch.cuda.synchronize()
        results[k] = (res, time.perf_counter() - t0)
    launches = ops.launch_counts()

    resident = sum(t.numel() * t.element_size() for t in
                   (index.raw, index.slo, index.shi, index.elo, index.ehi,
                    index.ids))
    line = {"phase": "main", "n_series": args.n_series, "length": LENGTH,
            "capacity": CAPACITY, "n_blocks": index.n_blocks,
            "queries": args.queries, "build_seconds": build_s,
            "index_bytes": resident,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches}
    for k, (res, secs) in results.items():
        st = res.stats
        line[f"k{k}"] = {
            "query_seconds": secs,
            "blocks_visited_mean": st.blocks_visited.float().mean().item(),
            "blocks_visited_max": int(st.blocks_visited.max()),
            "series_refined_mean": st.series_refined.float().mean().item(),
            "lb_series_mean": st.lb_series.float().mean().item(),
            "iters": int(st.iters)}
        check(bool(torch.isfinite(res.dist).all()) and tuple(res.idx.shape)
              == (args.queries, k) and bool((res.idx >= 0).all()),
              f"main k={k}: finite distances of shape (Q, k) with real ids")
    emit(line)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} launched on the main path")
    return index, results, launches


def _compare_summarize(raw: torch.Tensor, n_slice: int) -> dict:
    x_raw = raw[:n_slice]
    x_norm = isax.znorm(x_raw)
    bps = isax.breakpoints_on(isax.CARD, raw.device)
    out = {}
    for normalize, x in ((False, x_norm), (True, x_raw)):
        pk, sk = isax_summarize(x, w=isax.W, card=isax.CARD, normalize=normalize)
        pr, sr = ref.isax_summarize_ref(x, w=isax.W, card=isax.CARD,
                                        normalize=normalize)
        err = (pk - pr).abs()
        paa_ok = bool((err <= PAA_ATOL + PAA_RTOL * pr.abs()).all())
        flips = sk != sr
        # a flip is excused only where the plain PAA lies within the band
        # of the breakpoint between the two symbols
        lo_sym = torch.minimum(sk, sr)[flips].long()
        near = (pr[flips] - bps[lo_sym.clamp(max=bps.numel() - 1)]).abs()
        n_flips = int(flips.sum())
        flips_ok = bool((near < SAX_FLIP_BAND).all()) and bool(
            ((sk - sr).abs() <= 1).all())
        check(paa_ok, f"isax_summarize normalize={normalize}: PAA within "
                      f"rtol {PAA_RTOL} + atol {PAA_ATOL}")
        check(flips_ok, f"isax_summarize normalize={normalize}: symbol flips "
                        f"only within {SAX_FLIP_BAND} of a breakpoint")
        ms = time_cuda(lambda: isax_summarize(x, w=isax.W, card=isax.CARD,
                                              normalize=normalize))
        plain_ms = time_cuda(lambda: ref.isax_summarize_ref(
            x, w=isax.W, card=isax.CARD, normalize=normalize), reps=5)
        n, w = x.shape[1], isax.W
        nbytes = n_slice * n * 4 + n_slice * w * 8 + bps.numel() * 4
        ops = n_slice * (n * (6 if normalize else 1)
                         + w * (1 + int(np.ceil(np.log2(bps.numel() + 1)))))
        b_ms, b_by = bound(nbytes, ops)
        out[normalize] = {"shape": [n_slice, n], "normalize": normalize,
                          "max_abs_err": float(err.max()),
                          "symbol_flips": n_flips, "match": paa_ok and flips_ok,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": None,
                          "tolerance": f"PAA rtol {PAA_RTOL} + atol {PAA_ATOL}; "
                                       f"symbol flips within {SAX_FLIP_BAND} "
                                       "of a breakpoint"}
        emit({"phase": "kernels", "kernel": "isax_summarize", **out[normalize]})
    return out[False]           # the main path's branch


def _compare_lb_scan(q_paa, index) -> dict:
    lo, hi, n = index.elo, index.ehi, index.n
    got = lb_scan(q_paa, lo, hi, n=n)
    want = ref.lb_scan_ref(q_paa, lo, hi, n=n)
    err = (got - want).abs()
    ok = check(bool((err <= LB_RTOL * want.abs()).all()),
               f"lb_scan within rtol {LB_RTOL}")
    qn, w = q_paa.shape
    nb = lo.shape[1]
    b_ms, b_by = bound(qn * w * 4 + 2 * w * nb * 4 + qn * nb * 4,
                       qn * nb * (6 * w + 1))
    line = {"shape": [qn, w, nb], "max_abs_err": float(err.max()),
            "match": ok, "ms": time_cuda(lambda: lb_scan(q_paa, lo, hi, n=n)),
            "plain_ms": time_cuda(lambda: ref.lb_scan_ref(q_paa, lo, hi, n=n)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "tolerance": f"rtol {LB_RTOL}"}
    emit({"phase": "kernels", "kernel": "lb_scan", **line})
    return line


def _compare_block_topk(d, ids) -> dict:
    qn, c = d.shape
    ok_all = True
    for k in (1, 10, 32, c + 5):
        gd, gi = block_topk(d, ids, k=k)
        wd, wi = ref.block_topk_ref(d, ids, k)
        ok = torch.equal(gd, wd) and torch.equal(gi, wi)
        ok_all &= check(ok, f"block_topk k={k} (C={c}) bitwise")
    k = 10
    b_ms, b_by = bound(qn * c * 8 + qn * k * 8, qn * c)
    line = {"shape": [qn, c], "k": k, "max_abs_err": 0.0 if ok_all else None,
            "match": ok_all,
            "ms": time_cuda(lambda: block_topk(d, ids, k=k)),
            "plain_ms": time_cuda(lambda: ref.block_topk_ref(d, ids, k)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_cuda(lambda: torch.topk(d, k, dim=1,
                                                       largest=False)),
            "library": "torch.topk(largest=False): not id-tie-exact",
            "tolerance": "bitwise, k in {1, 10, 32, C + 5}"}
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


def _compare_fused(index, qs, front_thr, block_lb, order) -> dict:
    q, q_paa = qs.q, qs.aux[0]
    n, qn = index.n, q.shape[0]
    neg = torch.zeros(qn, dtype=torch.bool, device=q.device)
    neg[::7] = True
    minus_inf = torch.tensor(float("-inf"), device=q.device)
    b0 = int(order[0])
    b_last = index.n_blocks - 1
    first_thr = torch.where(block_lb[:, b0] < front_thr, front_thr, minus_inf)
    live_all = torch.where(neg, minus_inf, torch.full_like(front_thr, ref.INF))

    def blk(b, c=None):
        c = index.capacity if c is None else c
        return (index.raw[b][:c], index.slo[b][:, :c].contiguous(),
                index.shi[b][:, :c].contiguous(), index.ids[b][:c])

    cases = {"first_block": (blk(b0), first_thr),
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
    pads = int((index.ids[b_last] < 0).sum())

    # time the main path's first refine call (k=10) and count its work
    k = 10
    block, lo, hi, ids = blk(b0)
    w, c = q_paa.shape[1], block.shape[0]
    args = (q, q_paa, block, lo, hi, ids, first_thr)
    ms = time_cuda(lambda: fused_panel_topk(*args, k=k, n=n))
    plain_ms = time_cuda(lambda: ref.fused_panel_topk_ref(*args, k=k, n=n))
    qe = q_paa[:, :, None]
    dd = torch.clamp(torch.maximum(lo[None] - qe, qe - hi[None]), min=0.0)
    live = ((n / w) * (dd * dd).sum(1) < first_thr[:, None]) & (ids >= 0)[None]
    n_live = int(live.sum())
    live_rows = int(live.any(0).sum())
    nbytes = (qn * (n + w + 1) * 4 + 2 * w * c * 4 + c * 4 + live_rows * n * 4
              + qn * k * 8 + qn * 4)
    ops = qn * c * 6 * w + n_live * (2 * n + 3) + live_rows * 2 * n
    b_ms, b_by = bound(nbytes, ops)
    line = {"shape": [qn, c, n], "k": k, "cases": n_cases,
            "pad_lanes_in_last_block": pads, "near_ties": ties,
            "timed_call": {"n_live": n_live, "live_rows": live_rows},
            "max_abs_err": max_err, "match": ok_all, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "tolerance": f"n_live equal; squared distances within "
                         f"{DIST_REL}*(|q|^2+max|x|^2); ids equal but at near ties"}
    emit({"phase": "kernels", "kernel": "fused_panel_topk", **line})
    return line


def phase_kernels(raw, index, queries, n_slice: int) -> dict:
    metric = engine.ED()
    prep = engine.prepare(metric, index, queries, 10)
    qs = prep.qs
    # the stage-A panel exactly as engine.prepare hands it to block_topk
    b0 = torch.argmin(prep.block_lb, dim=1)
    ids0 = index.ids[b0]
    d0 = torch.where(ids0 >= 0, frontier.query_block_l2(qs.q, index.raw[b0]),
                     ref.INF)
    order, _, _ = engine.block_major_schedule(prep.block_lb)
    return {
        "isax_summarize": _compare_summarize(raw, n_slice),
        "lb_scan": _compare_lb_scan(qs.aux[0], index),
        "block_topk": _compare_block_topk(d0.contiguous(), ids0.contiguous()),
        "fused_panel_topk": _compare_fused(index, qs, prep.front.threshold(),
                                           prep.block_lb, order),
    }


def phase_exact(raw, queries, results, chunk: int = 1 << 20) -> None:
    """Brute force over every series with the plain versions, not ``ops``."""
    q = isax.znorm(queries)
    qn, kmax = q.shape[0], max(results)
    best_d = torch.full((qn, kmax), ref.INF, device=q.device)
    best_i = torch.full((qn, kmax), -1, dtype=torch.int32, device=q.device)
    t0 = time.perf_counter()
    for i in range(0, raw.shape[0], chunk):
        j = min(i + chunk, raw.shape[0])
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
        line[f"k{k}"] = {"ids_equal": int((~diff).sum()),
                         "near_ties": int(diff.sum()),
                         "max_sq_dist_err": float((got_d - want_d.double())
                                                  .abs().max())}
        check(dist_ok and ties_ok, f"exact k={k}: index answers equal the "
                                   "brute-force scan (ids, but near ties)")
    emit(line)


REPLACES = {
    "isax_summarize": ("src/repro_torch/kernels/csrc/isax_summarize.cu",
                       "src/repro/kernels/isax_summarize.py:41"),
    "lb_scan": ("src/repro_torch/kernels/csrc/lb_scan.cu",
                "src/repro/kernels/lb_scan.py:38"),
    "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                   "src/repro/kernels/block_topk.py:78"),
    "fused_panel_topk": ("src/repro_torch/kernels/csrc/fused_refine.cu",
                         "src/repro/kernels/fused_refine.py:91"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=100)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # no fp32 product in TF32
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase_build()
    raw = random_walk_cuda(args.n_series, LENGTH, args.seed)
    queries = random_walk_cuda(args.queries, LENGTH, args.seed + 1)
    index, results, launches = phase_main(args, raw, queries)
    lines = phase_kernels(raw, index, queries,
                          min(SUMMARIZE_SLICE, args.n_series))
    phase_exact(raw, queries, results)

    kernels = []
    for name, line in lines.items():
        source, replaces = REPLACES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "match": line["match"],
                        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
                        "plain_ms": line["plain_ms"],
                        "bound_ms": line["bound_ms"],
                        "bound_by": line["bound_by"],
                        "library_ms": line["library_ms"]})
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
