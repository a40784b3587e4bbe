"""Serving entry point: prefill + batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        [--smoke] --batch 4 --prompt-len 64 --gen 32 --seed 0 [--device cpu]

The counterpart of the LM mode of ``repro.launch.serve``: parameters
built from ``--seed``, an fp32 cache, the prompt's prefill, then a
greedy decode loop; prints the prefill time and the decode time a token,
synchronised with the card.  It runs on the card unless ``--device cpu``
is given.  The search-serving mode (``--search-index``) waits for the
on-disk and serving slices (ROADMAP.md Queue 1, items 11-15).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.train.step import make_prefill_step, make_serve_step


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--search-index", default=None,
                    help="not yet in the port: search serving waits for the "
                         "on-disk and serving slices")
    args = ap.parse_args(argv)
    if args.search_index:
        raise NotImplementedError(
            "--search-index: ROADMAP.md Queue 1, items 11-15 (the on-disk "
            "index and search serving) are not ported yet")

    dev = resolve_device(args.device)
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
