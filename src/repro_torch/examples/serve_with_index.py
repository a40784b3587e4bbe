"""End-to-end example, the paper's kind: serving similarity search over LM
embeddings (``examples/serve_with_index.py``).

The paper's SV notes the technique "applies to high-dimensional vectors in
general ... such as deep-learning embeddings".  This example is that
application end to end:

  1. embed a corpus of token sequences with a reduced LM (Hymba's
     ``smoke()`` shape, weights from a seed),
  2. build the MESSI vector index over the embeddings (Cosine),
  3. serve a LOOP of batched nearest-neighbour query batches (new
     sequences -> embed -> exact cosine top-k), reporting p50/p99
     latency a batch and, out of core, the block cache's hit rate.

With ``--index-path`` the index persists across launches: the first run
builds it through the staged pipeline and saves it; every later run skips
the embedding and the build and OPENS the file out of core (summaries on
the device, raw embeddings read from disk a batch at a time).  Out of
core, ``--concurrency`` tenant threads each ``submit`` their share of a
batch and one coalesced drain answers them all.

    PYTHONPATH=src python -m repro_torch.examples.serve_with_index \\
        [--arch hymba-1.5b] [--k 5] [--index-path corpus.dsix] \\
        [--concurrency 4] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  ``--arch`` takes any
architecture of the families the port runs (dense, vlm, hybrid); the
others raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np
import torch

from repro_torch import storage
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import vector
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_params
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.storage.ooc_search import OocSearchResult


@torch.no_grad()
def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Mean-pooled final hidden state as the sequence embedding. -> (B, d)."""
    x = T.embed_inputs(params, tokens, cfg)
    x, _ = T.decoder_stack(params, x, cfg, "train")
    x = common.rmsnorm(x, params["final_norm"])
    return torch.mean(x.to(torch.float32), dim=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--corpus", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--k", type=int, default=5,
                    help="neighbours returned per query (exact top-k)")
    ap.add_argument("--batches", type=int, default=8,
                    help="serving loop length: query batches answered "
                         "back to back (out-of-core runs share one "
                         "SearchSession, so later batches hit its cache)")
    ap.add_argument("--cache-blocks", type=int, default=64,
                    help="SearchSession LRU capacity, in raw blocks "
                         "(out-of-core serving only)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="speculative block reads kept in flight ahead "
                         "of the walk (out-of-core only; answers are "
                         "bit-identical at every setting)")
    ap.add_argument("--group-blocks", type=int, default=1,
                    help="surviving blocks batched per refine dispatch, "
                         "one threshold sync per group (out-of-core "
                         "only; answers are bit-identical)")
    ap.add_argument("--readers", type=int, default=2,
                    help="block-cache reader threads (out-of-core only)")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="tenant threads per batch (out-of-core only): "
                         "each thread submit()s its share of the queries "
                         "and blocks on its ticket; one coalesced drain "
                         "answers all of them through the shared cache")
    ap.add_argument("--index-path", default=None,
                    help="persisted index file: built and saved on the "
                         "first run, opened out-of-core afterwards")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = build_params(cfg, 0, dev)
    rng = np.random.default_rng(0)

    # corpus: documents from 8 topical clusters (cluster = token offset)
    topics = rng.integers(0, 8, args.corpus)
    toks = ((topics[:, None] * 61 + rng.integers(0, 32,
             (args.corpus, args.seq))) % cfg.vocab).astype(np.int64)

    def embed_tokens(t: np.ndarray) -> torch.Tensor:
        return embed(params, cfg, torch.as_tensor(t, device=dev))

    if args.index_path and os.path.exists(args.index_path):
        extra = storage.read_meta(args.index_path)["extra"]
        # the embedding space is defined by (model, corpus): a mismatch on
        # either would silently serve neighbours from the wrong space
        want = {"kind": "vector", "corpus": args.corpus, "arch": args.arch}
        if {k: extra.get(k) for k in want} != want:
            raise SystemExit(f"{args.index_path} holds {extra}, not a "
                             f"vector index for {want} — delete it "
                             f"or pass a different --index-path")
        index = storage.open_index(args.index_path, device=dev)
        print(f"opened {args.index_path} out-of-core: "
              f"{index.n_real} x {index.n} embeddings, "
              f"{index.n_blocks} blocks on disk")
    else:
        print(f"embedding {args.corpus} docs with {cfg.name} (reduced) "
              f"on {dev} ...")
        t0 = time.perf_counter()
        embs = torch.cat([embed_tokens(toks[i:i + 256])
                          for i in range(0, args.corpus, 256)])
        _sync(dev)
        print(f"  {time.perf_counter() - t0:.1f}s -> embeddings "
              f"{tuple(embs.shape)}")
        if args.index_path:
            # the first persisted launch goes through the staged build
            # pipeline: embeddings land in a SeriesStore beside the index,
            # and the build records every stage in a manifest, so a launch
            # killed mid-build resumes from the last completed unit
            prepped = vector.prep_vectors(embs, True).cpu().numpy()
            store = storage.SeriesStore.write(args.index_path + ".series",
                                              prepped)
            print("building MESSI vector index (staged pipeline, "
                  "resumable) ...")
            index = storage.pipeline_build(
                store, args.index_path, w=16, card=256, capacity=256,
                normalize=False, workers=2,
                extra={"kind": "vector", "dim": embs.shape[-1],
                       "corpus": args.corpus, "arch": args.arch},
                progress=lambda m: print(f"  [build] {m}"), device=dev)
            print(f"published index -> {args.index_path} (opened "
                  f"out-of-core; the next launch skips embed and build)")
        else:
            print("building MESSI vector index ...")
            index = vector.build_vector_index(embs, capacity=256,
                                              device=dev)

    # serving traffic: --batches query batches, each perturbed members of
    # known clusters (fresh draws a batch, so only the index blocks their
    # survivors share are reusable across batches)
    batches = []
    for _ in range(args.batches):
        qi = rng.choice(args.corpus, args.queries, replace=False)
        q_toks = toks[qi].copy()
        flip = rng.random(q_toks.shape) < 0.1
        q_toks[flip] = rng.integers(0, cfg.vocab, int(flip.sum()))
        batches.append((qi, embed_tokens(q_toks)))
    dim = index.n

    session = None
    if index.device_resident:
        def run(qe):
            return vector.search_vectors(index, qe, k=args.k, device=dev)
        run(batches[0][1])                              # warm-up
    else:
        # warm-up on a throwaway session, so the measured loop (and its
        # hit rate) starts cold
        with storage.SearchSession(index, cache_blocks=2,
                                   device=dev) as warmup:
            warmup.search(batches[0][1], k=args.k, metric=vector.Cosine())
        session = storage.SearchSession(
            index, cache_blocks=args.cache_blocks, readers=args.readers,
            pipeline_depth=args.pipeline_depth,
            group_blocks=args.group_blocks, device=dev)
        if args.concurrency > 1:
            # multi-tenant serving: split the batch over tenant threads;
            # every thread submits its slice and blocks on its own ticket,
            # the first to ask drains for everyone, and the answers are
            # bit-identical to the single-tenant path
            def run(qe):
                n_t = min(args.concurrency, qe.shape[0])
                cuts = np.array_split(np.arange(qe.shape[0]), n_t)
                results = [None] * n_t
                admitted = threading.Barrier(n_t)

                def tenant(i):
                    t = session.submit(qe[cuts[i]], k=args.k,
                                       metric=vector.Cosine())
                    admitted.wait()   # all tenants in before anyone drains
                    results[i] = t.result()

                threads = [threading.Thread(target=tenant, args=(i,))
                           for i in range(n_t)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                if any(r is None for r in results):
                    raise RuntimeError("a tenant thread got no answer")
                return OocSearchResult(
                    dist=torch.cat([r.dist for r in results]),
                    idx=torch.cat([r.idx for r in results]),
                    stats=results[0].stats, io=results[0].io)
        else:
            def run(qe):
                return session.search(qe, k=args.k, metric=vector.Cosine())

    lat_ms = []
    for qi, q_embs in batches:                          # the serving loop
        t0 = time.perf_counter()
        res = run(q_embs)
        _sync(dev)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = np.percentile(lat_ms, [50, 99])

    ids = res.idx.cpu().numpy()         # quality stats from the last batch
    cos = vector.cosine_scores(res, dim=dim).cpu().numpy()
    valid = ids >= 0                                    # k > corpus -> -1 pads
    hits = (topics[np.where(valid, ids, 0)] == topics[qi][:, None]) & valid
    same_topic = hits.sum() / max(valid.sum(), 1)
    self_hit = np.mean(ids[:, 0] == qi)
    refined = res.stats.series_refined.double().mean().item()
    print(f"served {args.batches} batches x {args.queries} queries "
          f"(top-{args.k}): p50 {p50:.1f} ms/batch  p99 {p99:.1f} ms/batch "
          f"({p50 / args.queries:.2f} ms/query at p50)")
    print(f"  exact self-retrieval@1: {100 * self_hit:.0f}%   "
          f"same-topic neighbours@{args.k}: {100 * same_topic:.0f}%")
    print(f"  rank-1 cosine {cos[:, 0].mean():.3f}  "
          f"rank-{args.k} cosine {cos[:, -1].mean():.3f}")
    print(f"  refined {refined:.0f} of {args.corpus} embeddings per query "
          f"(pruning at work)")
    if session is not None:
        if args.concurrency > 1:
            print(f"  served by {args.concurrency} tenant threads per "
                  f"batch through one coalesced drain (answers identical "
                  f"to the single-tenant path)")
        print(f"  block cache ({args.cache_blocks} blocks): "
              f"{100 * session.hit_rate:.0f}% hit-rate over the session "
              f"({session.cache_hits} hits / {session.blocks_fetched} "
              f"disk fetches); last batch read {res.io.bytes_read:,} of "
              f"{res.io.bytes_scan:,} scan bytes "
              f"({100 * res.io.read_fraction:.0f}%)")
        session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
