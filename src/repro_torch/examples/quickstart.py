"""Quickstart: build a MESSI index and answer exact 1-NN queries
(``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--n-series 100000] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

import repro_torch.core as core
from repro_torch.core.ucr import search_scan
from repro_torch.data import random_walk
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-series", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_series
    # random-walk series of 256 points (the paper's Synthetic recipe)
    raw = torch.as_tensor(random_walk(n, 256, seed=0), device=dev)
    queries = torch.as_tensor(random_walk(10, 256, seed=1), device=dev)

    print("building MESSI block index ...")
    index = core.build(raw, capacity=1024, device=dev)
    print(f"  {index.n_blocks} blocks x {index.capacity} series")

    print("searching (exact 1-NN) ...")
    res = core.search(index, queries, device=dev)  # (Q, 1); pass k= for more
    idx, dist = res.idx.tolist(), res.dist.tolist()
    refined = res.stats.series_refined.tolist()
    for i in range(queries.shape[0]):
        print(f"  query {i}: nn={idx[i][0]:6d} dist={dist[i][0]:8.4f} "
              f"refined {refined[i]} / {n} series")

    # cross-check against the brute-force oracle
    oracle = search_scan(raw, queries, device=dev)
    if not torch.equal(res.idx, oracle.idx):
        raise AssertionError("answers differ from the full scan")
    print("verified: answers identical to the full scan, "
          f"{n / (sum(refined) / len(refined)):.0f}x "
          "less real-distance work")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
