"""Full similarity-search tour: the three systems of the paper, streaming
(ParIS+) ingestion, anytime answers, and the DTW extension
(``examples/similarity_search.py``).

    PYTHONPATH=src python -m repro_torch.examples.similarity_search \\
        [--n-series 60000] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.core as core
from repro_torch.core import dtw
from repro_torch.core.paris import search_paris
from repro_torch.core.ucr import search_scan
from repro_torch.data import make_dataset
from repro_torch.data.loader import build_streaming
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-series", type=int, default=60_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_series
    raw_np = make_dataset("seismic", n, 256)
    raw = torch.as_tensor(raw_np, device=dev)
    rng = np.random.default_rng(0)
    qs = torch.as_tensor(
        raw_np[rng.choice(n, 8, replace=False)]
        + 0.05 * rng.standard_normal((8, 256)).astype(np.float32),
        device=dev)

    # -- ParIS+-style streaming build (ingest/compute overlap) -------------
    t0 = time.perf_counter()
    index = build_streaming(raw_np, chunk=1 << 15, capacity=1024,
                            device=dev)
    _sync(dev)
    print(f"streaming build (ParIS+ overlap): {time.perf_counter()-t0:.2f}s "
          f"for {n} series on {dev}")

    # -- the three query systems -------------------------------------------
    for name, fn in [
            ("UCR-Suite-p", lambda: search_scan(raw, qs, device=dev)),
            ("ParIS", lambda: search_paris(index, qs, device=dev)),
            ("MESSI (paper)", lambda: core.search(index, qs, device=dev)),
            ("MESSI (block-major)",
             lambda: core.search_block_major(index, qs, device=dev))]:
        fn()                                            # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        dt = (time.perf_counter() - t0) / qs.shape[0] * 1e3
        refined = res.stats.series_refined.double().mean().item()
        print(f"{name:20s} {dt:8.2f} ms/query   refined {refined:9.0f}"
              f" series/query")

    # -- k-NN result lists (same frontier machinery, any k) -----------------
    res_k = core.search(index, qs, k=5, device=dev)
    print("top-5 ids for query 0:", res_k.idx[0].tolist(),
          "dists", [round(d, 3) for d in res_k.dist[0].tolist()])

    # -- anytime mode (straggler mitigation / deadline) ---------------------
    exact = core.search(index, qs, device=dev)
    rough = core.search(index, qs, deadline_blocks=4, device=dev)
    gap = (rough.dist / exact.dist - 1).cpu().numpy()
    print(f"anytime (4-block deadline): distance gap vs exact "
          f"mean {100 * gap.mean():.2f}% max {100 * gap.max():.2f}%")

    # -- DTW on the same index (paper SV) -----------------------------------
    res_d = dtw.search_dtw(index, qs[:2], r=6, device=dev)
    print("DTW 1-NN (same index, banded):", res_d.idx[:, 0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
