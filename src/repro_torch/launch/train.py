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

``--mesh DxM`` trains on a (data, model) mesh of D x M rank processes:
the command starts them on one ``torch.distributed`` group (a
``file://`` store in a temporary directory; NCCL when each rank has a
card of its own, gloo otherwise), rank r = d·M + m at data coordinate
d and model coordinate m, with a group for each axis.  Every rank holds
the shards of the parameters and of the optimizer state that the
reference's specs give it (``launch.specs.param_pspecs``: tensor
parallel over "model", FSDP over "data" for an ``fsdp`` config).  The M
ranks of data coordinate d step on rows d·B/D .. (d+1)·B/D - 1 of each
global batch of ``--batch`` rows; the model runs its tensor- and
expert-parallel blocks, its embedding and cross-entropy over the
vocabulary's blocks over the model group, and gathers its other
sharded leaves where it uses them (``models.parallel``); gradients are
averaged over the data group (``--grad-compression int8``: the int8
all-gather with error feedback, on each rank's shards).  The parameters
are built whole from ``--seed`` on the CPU, then cut and moved, so a
mesh run starts from the weights one process starts from.  Rank 0 logs
and writes the checkpoints, in the one-process format: every rank takes
part in gathering each leaf whole, and a restore cuts the shards again,
so a checkpoint moves between meshes and one process.  With a mesh rank
0 prints, at the end, one ``[rank] {json}`` line a rank: the elements it
holds, its peak memory, its step seconds, its tensor-parallel,
vocabulary and gathered leaves (and the gathered ones' paths) and its
kernel launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshSpec, make_mesh
from repro_torch.launch.serve import build_params
from repro_torch.models import common, parallel
from repro_torch.train import Checkpointer, make_train_step, opt_init
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import COMPRESSION

AXES = ("data", "model")


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
    """"DxM" -> (D, M), each at least 1."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM, e.g. 2x2, got {text!r}") \
            from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text}: DxM takes D, M >= 1")
    return d, m


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="the config cut to its first N layers")
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
                    help="DxM: D data x M model ranks")
    ap.add_argument("--grad-compression", choices=COMPRESSION,
                    default="none", help="the gradient all-reduce's wire "
                                         "format with --mesh")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    shape = parse_mesh(args.mesh) if args.mesh else (1, 1)
    world = shape[0] * shape[1]
    if args.batch % shape[0]:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{shape[0]} data ranks")
    if world == 1:
        return _train(args, rank=0, shape=shape)
    backend = ("nccl" if torch.device(args.device).type == "cuda"
               and torch.cuda.device_count() >= world else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(rank_main, args=(args, shape, backend,
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


def rank_main(rank: int, args, shape: tuple, backend: str, init: str,
              cfg=None):
    """One rank of ``--mesh`` (a spawned process): the (data, model) mesh
    over a group of ``backend`` from ``init`` (a ``file://`` store), and
    training on its two axes' groups.  ``args``: ``main``'s parsed
    arguments; ``cfg``: a config in place of ``args.arch``'s."""
    dist.init_process_group(backend, init_method=init,
                            world_size=shape[0] * shape[1], rank=rank)
    try:
        mesh = make_mesh(shape, AXES, "cuda" if backend == "nccl" else "cpu")
        _train(args, rank=rank, shape=shape, data=mesh.get_group("data"),
               model=mesh.get_group("model"), cfg=cfg)
    finally:
        dist.destroy_process_group()


class _Layout:
    """This rank's place on the mesh and the specs of what it holds."""

    def __init__(self, cfg, rank: int, shape: tuple, data, model):
        self.sizes = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, divmod(rank, shape[1])))
        mesh = MeshSpec(tuple(shape), AXES)
        self.params = specs.param_pspecs(cfg, mesh)
        self.opt = opt_lib.opt_state_specs(cfg.optimizer, self.params,
                                           specs.param_shapes(cfg))
        self.plan = parallel.Plan(cfg, self.params, model=model, data=data)

    def cut(self, tree, spec_tree, dev):
        """This rank's shards of a whole tree, on ``dev``."""
        sp = dict(common.leaves(spec_tree))
        return common.with_leaves(tree, {
            p: common.shard(t, sp[p], self.coords, self.sizes).to(dev)
            for p, t in common.leaves(tree)})

    def cut_state(self, state, dev):
        return type(state)(state.step.to(dev), *(
            self.cut(getattr(state, f), getattr(self.opt, f), dev)
            for f in state._fields[1:]))

    def whole(self, tree, spec_tree):
        """The whole tree on the host, every rank taking part."""
        sp = dict(common.leaves(spec_tree))
        return common.with_leaves(tree, {
            p: self.plan.whole(t, sp[p]).cpu()
            for p, t in common.leaves(tree)})

    def whole_state(self, state):
        return type(state)(state.step.cpu(), *(
            self.whole(getattr(state, f), getattr(self.opt, f))
            for f in state._fields[1:]))


def _host_template(cfg) -> dict:
    """A restore template of the whole tree: host tensors, never written
    (``restore`` reads their shapes)."""
    meta = {"params": specs.param_shapes(cfg), "opt": specs.opt_shapes(cfg)}
    empty = lambda t: torch.empty(t.shape, dtype=t.dtype)
    opt = meta["opt"]
    return {"params": common.tree_map(empty, meta["params"]),
            "opt": type(opt)(empty(opt.step), *(common.tree_map(empty, x)
                                                for x in opt[1:])),
            "meta": {"step": 0}}


def _train(args, *, rank: int, shape: tuple = (1, 1), data=None,
           model=None, cfg=None) -> int:
    world = shape[0] * shape[1]
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if world > 1:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
        torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    lay = _Layout(cfg, rank, shape, data, model) if world > 1 else None
    step_fn = make_train_step(cfg, base_lr=args.lr, total_steps=args.steps,
                              warmup=min(100, args.steps // 10 + 1),
                              microbatch=1 if args.smoke else None,
                              plan=lay.plan if lay else None,
                              compression=args.grad_compression,
                              device=dev)
    log = rank == 0

    start_step = 0
    ckpt = None
    tree = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step()
        if latest is not None:
            tree = ckpt.restore(_host_template(cfg))
            start_step = int(tree["meta"]["step"]) + 1
            if log:
                print(f"[resume] from step {latest} -> starting at "
                      f"{start_step}")
    if tree is None:
        tree = {"params": build_params(cfg, args.seed, "cpu"), "opt": None}
    if lay is None:
        params = common.tree_map(lambda t: t.to(dev), tree["params"])
    else:
        params = lay.cut(tree["params"], lay.params, dev)
    opt = tree["opt"]
    if opt is None:                   # a fresh state, on the shards
        opt_state = opt_init(cfg.optimizer, params)
    elif lay is None:
        opt_state = type(opt)(opt.step.to(dev), *(
            common.tree_map(lambda t: t.to(dev), x) for x in opt[1:]))
    else:
        opt_state = lay.cut_state(opt, dev)
    del tree, opt

    stop = {"now": False}

    def on_sigterm(signum, frame):
        if log:
            print("[sigterm] checkpointing and exiting...", flush=True)
        stop["now"] = True

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    next_batch = make_batch_fn(cfg, args.batch, args.seq, args.seed)
    rows = args.batch // shape[0]
    d = rank // shape[1]
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_s, metrics = [], None
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next_batch(step)
        if world > 1:
            batch = {k: v[d * rows:(d + 1) * rows]
                     for k, v in batch.items()}
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t_step)
        if log and (step % args.log_every == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f} "
                  f"skipped {int(m['skipped'])} ({time.time() - t0:.1f}s)",
                  flush=True)
        if world > 1:                 # the ranks stop at the same step
            flag = parallel.all_reduce(torch.tensor([float(stop["now"])]),
                                       dist.group.WORLD, dist.ReduceOp.MAX)
            stop["now"] = bool(flag.item())
        if ckpt and (step % args.ckpt_every == 0 or stop["now"]
                     or step == args.steps - 1):
            if lay is None:
                state = {"params": params, "opt": opt_state}
            else:                     # every rank takes part in the gather
                state = {"params": lay.whole(params, lay.params),
                         "opt": lay.whole_state(opt_state)}
            if log:
                ckpt.save(step, {**state, "meta": {"step": step}})
            del state
        if stop["now"]:
            break
    if ckpt:
        ckpt.wait()
    if lay is not None:
        _report(rank, lay, params, opt_state, metrics, step_s, dev)
    if log:
        print("done.")
    return 0


def _shapes(tree) -> dict:
    return {"/".join(p): list(t.shape) for p, t in common.leaves(tree)}


def _report(rank: int, lay: _Layout, params, opt_state, metrics, step_s,
            dev) -> None:
    """Every rank's ``[rank] {json}`` line, printed by rank 0 in rank
    order: what the rank holds, its peak memory, its step seconds, its
    plan's counts and gathered paths, its kernel launches and the last
    step's loss and gradient norm."""
    opt = {f: _shapes(getattr(opt_state, f)) for f in opt_state._fields[1:]}
    mine = {
        "rank": rank, "coords": lay.coords,
        "params_held": sum(t.numel() for _, t in common.leaves(params)),
        "opt_held": sum(math.prod(s) for f in opt.values()
                        for s in f.values()),
        "param_shapes": _shapes(params), "opt_shapes": opt,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "step_s": step_s, **lay.plan.counts(),
        "gathered": ["/".join(p) for p in lay.plan.gathered()],
        "launches": ops.launch_counts(),
        **({"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])} if metrics else {})}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        for rep in every:
            print("[rank] " + json.dumps(rep), flush=True)

if __name__ == "__main__":
    sys.exit(main())
