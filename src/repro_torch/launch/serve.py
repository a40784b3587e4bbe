"""Serving entry point: prefill + batched greedy decode, or, with
``--search-index``, multi-tenant similarity-search serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        [--smoke] --batch 4 --prompt-len 64 --gen 32 --seed 0 [--device cpu]

The counterpart of ``repro.launch.serve``.  The LM mode serves any
architecture of the families the port runs (dense, vlm, hybrid: ``RUNS``);
the others raise NotImplementedError naming their ROADMAP item.  It
builds parameters from ``--seed``, an fp32 cache, the prompt's prefill,
then a greedy decode loop; it prints the prefill time and the decode
time a token, synchronised with the card.

The search mode takes a saved data-series index and drives the
multi-tenant serving layer against it: ``--tenants`` threads each submit
``--batch`` queries (members of one random block of the index, perturbed
with 0.05 noise from ``--seed``), one coalesced drain answers all of
them, and with ``--deadline-blocks`` a certified anytime answer is then
refined to exact:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --search-index /path/to/idx.dsix --tenants 4 [--deadline-blocks 8]

Both run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.train.step import make_prefill_step, make_serve_step


# the architectures whose families the port runs
RUNS = tuple(a for a in list_archs()
             if get_config(a).family in transformer.SERVED)


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # (B, gen) int64, the greedy tokens
    logits: torch.Tensor        # (B, gen, V) f32: the prefill's, then each step's
    prefill_s: float            # seconds, synchronised
    decode_s: float             # seconds over the gen - 1 decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_params(cfg: ModelConfig, seed: int,
                 device: str | torch.device | None = "cuda") -> dict:
    """Random parameters of ``cfg`` on ``device`` from ``seed`` (a
    ``torch.Generator`` on that device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return common.build_params(transformer.param_specs(cfg), gen, dev)


def greedy_generate(params: dict, cfg: ModelConfig, prompt, gen: int, *,
                    device: str | torch.device | None = "cuda") -> Generation:
    """Serve a batch of prompts (B, S): an fp32 cache for S + gen tokens,
    the prefill (its argmax is the first token), then gen - 1 decode
    steps, each feeding back the last argmax."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    b, s = prompt.shape
    cache = transformer.init_cache(cfg, b, s + gen, dtype=torch.float32,
                                   device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    decode = make_serve_step(cfg, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt}, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks, steps = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, tok, s + i, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(tok)
        steps.append(logits[:, -1])
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return Generation(tokens=torch.cat(toks, dim=1),
                      logits=torch.stack(steps, dim=1),
                      prefill_s=prefill_s, decode_s=decode_s)


def tenant_traffic(index, seed: int, tenants: int, batch: int
                   ) -> list[torch.Tensor]:
    """Search traffic over an opened index: ``tenants`` batches of
    ``batch`` members of one random block each, plus 0.05 noise, from
    ``seed``, on the index's device.  Perturbed members of the corpus,
    from different blocks, so the tenants' walks overlap only partly
    (the interesting coalescing regime).  Blocks are drawn among the
    full ones, so no padding row becomes a query."""
    rng = np.random.default_rng(seed)
    loads = []
    for _ in range(tenants):
        b = rng.integers(0, index.n_real // index.capacity)
        base = np.asarray(index.host_raw.fetch(b))[
            rng.choice(index.capacity, batch, replace=False)]
        loads.append(torch.as_tensor(
            base + 0.05 * rng.standard_normal(base.shape).astype(np.float32),
            device=index.ids.device))
    return loads


def serve_search(args, dev: torch.device) -> int:
    """Multi-tenant search serving against a saved index on ``dev``."""
    from repro_torch import serve, storage

    index = storage.open_index(args.search_index, device=dev)
    print(f"opened {args.search_index}: {index.n_real} x {index.n} series, "
          f"{index.n_blocks} blocks on disk, device={dev}")
    loads = tenant_traffic(index, args.seed, args.tenants, args.batch)

    def session():
        return storage.SearchSession(index, cache_blocks=args.cache_blocks,
                                     device=dev)

    with session() as s:   # warm-up: the kernels' and the card's first use
        s.search(loads[0][:1], k=args.k, deadline_blocks=1)

    with session() as s:
        results = [None] * args.tenants
        admitted = threading.Barrier(args.tenants)

        def tenant(i):
            t = s.submit(loads[i], k=args.k)
            admitted.wait()
            results[i] = t.result()

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(args.tenants)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        if any(r is None for r in results):
            raise RuntimeError("a tenant thread got no answer")
        print(f"{args.tenants} tenants x {args.batch} queries (top-{args.k})"
              f": {wall:.1f} ms wall, {s.blocks_fetched} disk blocks for "
              f"the whole fleet ({index.n_blocks} in the index), "
              f"{100 * s.hit_rate:.0f}% coalesced hit-rate")

    if args.deadline_blocks:
        with session() as s:
            t0 = time.perf_counter()
            a = s.search(loads[0], k=args.k,
                         deadline_blocks=args.deadline_blocks)
            _sync(dev)
            anytime_ms = (time.perf_counter() - t0) * 1e3
            c = a.certificate
            print(f"anytime (deadline {args.deadline_blocks} blocks): "
                  f"{anytime_ms:.1f} ms, certified gap "
                  f"{float(c.gap.mean()):.3f} mean / "
                  f"{float(c.gap.max()):.3f} max, "
                  f"{int(c.exact.sum())}/{len(c.exact)} queries already "
                  f"certified exact")
            t0 = time.perf_counter()
            ex = a.refine_to_exact()
            _sync(dev)
            kth = ex.dist[:, -1].cpu().numpy()
            print(f"refine_to_exact: +{(time.perf_counter() - t0) * 1e3:.1f}"
                  f" ms, {ex.io.blocks_fetched} further disk blocks "
                  f"(answers now exact; certificate verified "
                  f"{bool((kth <= c.upper + 1e-5).all())})")
            if not isinstance(a, serve.AnytimeResult):
                raise TypeError("search(deadline_blocks=...) returned "
                                f"{type(a).__name__}, not an AnytimeResult")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="one of " + ", ".join(RUNS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--search-index", default=None,
                    help="saved .dsix index: serve multi-tenant similarity "
                         "search against it instead of LM decode")
    ap.add_argument("--tenants", type=int, default=4,
                    help="concurrent tenant threads (search mode)")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--cache-blocks", type=int, default=64)
    ap.add_argument("--deadline-blocks", type=int, default=None,
                    help="also serve a certified anytime answer with this "
                         "refine budget, then refine it to exact")
    args = ap.parse_args(argv)
    if not args.search_index and not args.arch:
        ap.error("--arch is required (or pass --search-index)")

    dev = resolve_device(args.device)
    if args.search_index:
        return serve_search(args, dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    params = build_params(cfg, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    out = greedy_generate(params, cfg, prompt, args.gen, device=dev)

    n_dec = max(1, args.gen - 1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {out.prefill_s * 1e3:.1f} ms   decode: "
          f"{out.decode_s * 1e3 / n_dec:.1f} ms/token")
    print("sample tokens:", out.tokens[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
