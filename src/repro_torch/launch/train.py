"""Training entry point: any architecture the port trains (every family
but the hybrid one), on synthetic tokens, with checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --smoke --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1 \\
        [--device cpu]

The counterpart of ``repro.launch.train``, on one device (the card unless
``--device cpu``).  Fault tolerance: it resumes from the latest
checkpoint in ``--ckpt-dir``, takes a synchronous final checkpoint on
SIGTERM (or SIGINT), skips a non-finite step inside the step and keeps the
last three checkpoints.  There is no ``--mesh``: sharding the batch over
ranks is ROADMAP.md Queue 1, item 18e.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_params
from repro_torch.train import Checkpointer, make_train_step, opt_init


def make_batch_fn(cfg, batch: int, seq: int, seed: int = 0):
    """step -> the next batch (numpy) of the token stream from ``seed``;
    a vlm batch gets a patch prefix (N(0, 0.1) from ``seed + 1``) in
    place of its first tokens; an enc_dec batch is ``seq`` frame
    embeddings (N(0, 0.1) from ``seed + 1``) and the first
    ``decoder_len`` tokens as "dec_tokens"."""
    gen = synthetic_token_batches(batch=batch, seq_len=seq, vocab=cfg.vocab,
                                  seed=seed)
    rng = np.random.default_rng(seed + 1)

    def next_batch(step: int) -> dict:
        tokens = next(gen)["tokens"]
        if cfg.enc_dec:
            return {"frames": rng.standard_normal(
                        (batch, seq, cfg.d_model)).astype(np.float32) * 0.1,
                    "dec_tokens": tokens[:, :cfg.decoder_len]}
        if cfg.family == "vlm":
            p = min(cfg.n_patches, seq // 2)
            return {"patches": rng.standard_normal(
                        (batch, p, cfg.d_model)).astype(np.float32) * 0.1,
                    "tokens": tokens[:, :seq - p]}
        return {"tokens": tokens}

    return next_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 epilog="No --mesh: sharded training is "
                                        "ROADMAP.md Queue 1, item 18e.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    step_fn = make_train_step(cfg, base_lr=args.lr, total_steps=args.steps,
                              warmup=min(100, args.steps // 10 + 1),
                              microbatch=1 if args.smoke else None,
                              device=dev)
    params = build_params(cfg, args.seed, dev)
    opt_state = opt_init(cfg.optimizer, params)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step()
        if latest is not None:
            tree = ckpt.restore({"params": params, "opt": opt_state,
                                 "meta": {"step": 0}})
            params, opt_state = tree["params"], tree["opt"]
            start_step = int(tree["meta"]["step"]) + 1
            print(f"[resume] from step {latest} -> starting at {start_step}")

    stop = {"now": False}

    def on_sigterm(signum, frame):
        print("[sigterm] checkpointing and exiting...", flush=True)
        stop["now"] = True

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    next_batch = make_batch_fn(cfg, args.batch, args.seq, args.seed)
    t0 = time.time()
    for step in range(start_step, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next_batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} "
                  f"skipped {int(m['skipped'])} ({time.time() - t0:.1f}s)",
                  flush=True)
        if ckpt and (step % args.ckpt_every == 0 or stop["now"]
                     or step == args.steps - 1):
            ckpt.save(step, {"params": params, "opt": opt_state,
                             "meta": {"step": step}})
        if stop["now"]:
            break
    if ckpt:
        ckpt.wait()
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
