"""Training entry point: any of the ten architectures, on synthetic
tokens, with checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --smoke --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1 \\
        [--mesh 2x1] [--grad-compression int8] [--device cpu]

The counterpart of ``repro.launch.train``, on the card unless ``--device
cpu``.  Fault tolerance: it resumes from the latest checkpoint in
``--ckpt-dir``, takes a synchronous final checkpoint on SIGTERM (or
SIGINT), skips a non-finite step inside the step and keeps the last
three checkpoints.

``--mesh DxM`` trains data-parallel: the command starts D rank processes
on one ``torch.distributed`` group (a ``file://`` store in a temporary
directory; NCCL when each rank has a card of its own, gloo otherwise),
rank r steps on rows r·B/D .. (r+1)·B/D - 1 of each
global batch of ``--batch`` rows, and the gradients are averaged by one
all-reduce a step (``--grad-compression int8``: the int8 all-gather with
error feedback).  Every rank holds the same parameters; rank 0 logs and
writes the checkpoints.  M, the reference's model axis, must be 1: the
port shards no parameter.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core.frontier import comm_device
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_axes_of, make_mesh
from repro_torch.launch.serve import build_params
from repro_torch.train import Checkpointer, make_train_step, opt_init
from repro_torch.train.step import COMPRESSION


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


def parse_mesh(text: str) -> tuple[int, int]:
    """"DxM" -> (D, M); M must be 1 (no parameter is sharded)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM, e.g. 2x1, got {text!r}")
    if d < 1 or m != 1:
        raise ValueError(f"--mesh {text}: the port shards the batch over D "
                         "data ranks and no parameter, so M must be 1")
    return d, m


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    ap.add_argument("--mesh", default=None,
                    help="DxM: D data-parallel ranks (M must be 1)")
    ap.add_argument("--grad-compression", choices=COMPRESSION,
                    default="none", help="the gradient all-reduce's wire "
                                         "format with --mesh")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    world = parse_mesh(args.mesh)[0] if args.mesh else 1
    if world == 1:
        return _train(args, rank=0, world=1)
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over {world} "
                         "data ranks")
    backend = ("nccl" if torch.device(args.device).type == "cuda"
               and torch.cuda.device_count() >= world else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(args, world, backend,
                                                   f"file://{tmp}/store"),
                                 nprocs=world, join=False,
                                 start_method="spawn")

        def forward(signum, frame):     # every rank checkpoints and stops
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signal.SIGTERM)

        signal.signal(signal.SIGTERM, forward)
        signal.signal(signal.SIGINT, forward)
        while not ctx.join():
            pass
    return 0


def _rank_main(rank: int, args, world: int, backend: str, init: str):
    """One data rank of ``--mesh`` (a spawned process): the mesh over the
    group, and training on the group of its data axis."""
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh((world, 1), ("data", "model"),
                         "cuda" if backend == "nccl" else "cpu")
        _train(args, rank=rank, world=world,
               group=mesh.get_group(data_axes_of(mesh)[0]))
    finally:
        dist.destroy_process_group()


def _train(args, *, rank: int, world: int, group=None) -> int:
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if world > 1:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    step_fn = make_train_step(cfg, base_lr=args.lr, total_steps=args.steps,
                              warmup=min(100, args.steps // 10 + 1),
                              microbatch=1 if args.smoke else None,
                              group=group,
                              compression=args.grad_compression,
                              device=dev)
    params = build_params(cfg, args.seed, dev)
    opt_state = opt_init(cfg.optimizer, params)
    log = rank == 0

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
            if log:
                print(f"[resume] from step {latest} -> starting at "
                      f"{start_step}")

    stop = {"now": False}

    def on_sigterm(signum, frame):
        if log:
            print("[sigterm] checkpointing and exiting...", flush=True)
        stop["now"] = True

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    next_batch = make_batch_fn(cfg, args.batch, args.seq, args.seed)
    rows = args.batch // world
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next_batch(step)
        if world > 1:
            batch = {k: v[rank * rows:(rank + 1) * rows]
                     for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if log and (step % args.log_every == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} "
                  f"skipped {int(m['skipped'])} ({time.time() - t0:.1f}s)",
                  flush=True)
        if world > 1:                 # the ranks stop at the same step
            flag = torch.tensor([float(stop["now"])],
                                device=comm_device(group))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            stop["now"] = bool(flag.item())
        if log and ckpt and (step % args.ckpt_every == 0 or stop["now"]
                             or step == args.steps - 1):
            ckpt.save(step, {"params": params, "opt": opt_state,
                             "meta": {"step": step}})
        if stop["now"]:
            break
    if ckpt:
        ckpt.wait()
    if log:
        print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
