"""Serving entry point: prefill + batched greedy decode, or, with
``--search-index``, multi-tenant similarity-search serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        [--smoke] --batch 4 --prompt-len 64 --gen 32 --seed 0 [--device cpu]

The counterpart of ``repro.launch.serve``.  The LM mode serves any of the
ten architectures (``RUNS``).  It builds parameters from ``--seed``, an
fp32 cache, the prompt's prefill, then a greedy decode loop; it prints
the prefill time and the decode time a token, synchronised with the
card.  Whisper's request is ``--prompt-len`` frame embeddings (N(0, 0.1)
from ``--seed``) and the first min(prompt, decoder_len / 2) prompt
tokens as its decoder prompt, as the reference builds it.

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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import common, parallel, transformer
from repro_torch.train.step import make_prefill_step, make_serve_step


RUNS = tuple(list_archs())      # the port serves every family


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # (B, gen) int64, the greedy tokens
    logits: torch.Tensor        # (B, gen, V) f32: the prefill's, then each step's
    prefill_s: float            # seconds, synchronised
    decode_s: float             # seconds over the gen - 1 decode steps
    cache: list | None = None   # the cache after the last step (a rank's blocks)


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


def greedy_pick(block: torch.Tensor, group) -> torch.Tensor:
    """The greedy tokens (B,) of the logits (B, n) that ``block`` holds:
    the whole row (``group`` None), or this rank's block of the columns
    over ``group`` (columns [r·n, (r+1)·n) of rank r).  Each rank's
    (max, global index) pairs are all-gathered over ``group`` (one
    float64 message, exact for fp32 logits and for the indices); the
    largest value wins, the lowest global index on ties, as
    ``torch.argmax`` picks over the whole row."""
    idx = torch.argmax(block, dim=-1)
    if parallel.size(group) == 1:
        return idx
    top = torch.gather(block, -1, idx[:, None])[:, 0]
    lo = parallel.rank(group) * block.shape[-1]
    pairs = torch.stack([top.to(torch.float64),
                         (idx + lo).to(torch.float64)])        # (2, B)
    every = parallel.all_gather(pairs[None], 0, group)         # (M, 2, B)
    # ranks hold ascending columns: the first rank at the max holds the
    # lowest index of it
    first = torch.argmax(every[:, 0], dim=0, keepdim=True)     # (1, B)
    return torch.take_along_dim(every[:, 1], first, dim=0)[0].to(
        torch.int64)


def greedy_generate(params: dict, cfg: ModelConfig, prompt, gen: int, *,
                    frames=None, plan=None,
                    device: str | torch.device | None = "cuda") -> Generation:
    """Serve a batch of prompts (B, S): an fp32 cache for S + gen tokens,
    the prefill (its argmax is the first token), then gen - 1 decode
    steps, each feeding back the last argmax.

    An enc_dec model also takes ``frames`` (B, F, d): ``prompt`` is its
    decoder prompt, the cache's cross K/V spans the F frames, and
    S + gen must fit in ``decoder_len``.

    ``plan`` (a serving ``parallel.Plan`` with its ``mesh`` and
    ``coords``): every rank of the mesh calls this with the whole
    ``prompt`` (and ``frames``) and its shards of ``params``; it serves
    its rows of the batch (``launch.specs.serving_specs``) from cache
    blocks laid out as the reference's prefill cell lays them, re-cuts
    them to the decode cell's layout (``specs.recut_cache``: the
    full-attention positions over "model" or the data axes, where
    ``kv_shard_axes`` puts them) and decodes.  It returns its rows.
    Where "model" cuts the vocabulary, each step's logits are the rank's
    block and the token its ``greedy_pick``; the blocks are gathered
    once, at the end, into ``Generation.logits``."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    b, s = prompt.shape
    if cfg.enc_dec:
        if frames is None:
            raise ValueError(f"{cfg.name} serves frames: pass frames=")
        if s + gen > cfg.decoder_len:
            raise ValueError(f"{cfg.name}: {s} prompt + {gen} generated "
                             f"tokens exceed decoder_len {cfg.decoder_len}")
        frames = torch.as_tensor(frames, device=dev)
        batch = {"frames": frames, "dec_tokens": prompt}
        max_len = frames.shape[1]
    else:
        batch, max_len = {"tokens": prompt}, s + gen
    kv_shard, lay, sizes, group = None, None, None, None
    if plan is None:
        cache = transformer.init_cache(cfg, b, max_len, dtype=torch.float32,
                                       device=dev)
    else:
        lay = specs.serving_specs(cfg, plan.mesh, b, max_len)
        sizes = mesh_lib.axis_sizes(plan.mesh)
        batch = {k: common.shard(v, (lay["batch"],), plan.coords, sizes)
                 for k, v in batch.items()}
        shapes = specs.cut_cache_shapes(
            specs.cache_shapes(cfg, b, max_len, torch.float32),
            lay["prefill"], sizes)
        cache = [{k: torch.zeros(shp, dtype=torch.float32, device=dev)
                  for k, shp in seg.items()} for seg in shapes]
        axes = lay["kv_shard"]
        if axes:
            kv_shard = plan.model if "model" in axes else plan.data
        group = plan.vocab
    prefill = make_prefill_step(cfg, plan=plan, device=dev)
    decode = make_serve_step(cfg, kv_shard=kv_shard, plan=plan, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    tok = greedy_pick(logits[:, -1], group)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    if lay is not None:
        cache = specs.recut_cache(cache, lay["prefill"], lay["decode"],
                                  plan.coords, sizes)

    toks, steps = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, tok, s + i, cache)
        tok = greedy_pick(logits[:, -1], group)[:, None]
        toks.append(tok)
        steps.append(logits[:, -1])
    _sync(dev)
    decode_s = time.perf_counter() - t0
    logits = torch.stack(steps, dim=1)
    if group is not None:           # the blocks, whole, padding dropped
        logits = parallel.all_gather(logits, -1, group)[..., :cfg.vocab]
    return Generation(tokens=torch.cat(toks, dim=1), logits=logits,
                      prefill_s=prefill_s, decode_s=decode_s, cache=cache)


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
    frames = None
    if cfg.enc_dec:
        frames = (rng.standard_normal((args.batch, args.prompt_len,
                                       cfg.d_model)) * 0.1
                  ).astype(np.float32)
        prompt = prompt[:, :min(args.prompt_len, cfg.decoder_len // 2)]
    out = greedy_generate(params, cfg, prompt, args.gen, frames=frames,
                          device=dev)

    n_dec = max(1, args.gen - 1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {out.prefill_s * 1e3:.1f} ms   decode: "
          f"{out.decode_s * 1e3 / n_dec:.1f} ms/token")
    print("sample tokens:", out.tokens[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
