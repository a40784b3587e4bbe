"""Train, eval and serving steps of the port, the counterparts of
``repro.train.step``: gradients accumulated in fp32 over microbatches,
a non-finite step skipped without a host round trip, and the learning
rate computed on the device.

PyTorch runs eagerly, so a step is a closure over the config and the
device, not a jitted function.  The train step updates the parameters
and the optimizer state in place and returns them, as the reference's
trainer donates them: a caller keeps no other use of what it passed.

Data parallelism: given a ``torch.distributed`` group, every rank of it
steps on its own shard of the batch from the same parameters, and the
gradients (with the loss and metrics) are averaged over the ranks by one
all-reduce a step, or by ``compression.ddp_allreduce_int8`` with error
feedback; every rank then applies the same update.  The reference's
mesh step shards the batch over its data axes inside one jitted program.

The model axis: given a ``parallel.Plan``, every rank of a (D, M) mesh
holds its shards of the parameters and the optimizer state, the M ranks
of a model group step on the same rows, and the model runs its
tensor-parallel blocks, its embedding and cross-entropy over the
vocabulary's blocks, and gathers its other sharded leaves
(``models.parallel``).  Replicated and model-sharded gradients are
averaged over the data group; FSDP gradients come out of their gathers'
reduce-scatter already summed over it and are only scaled.  The
gradient norm counts each element of the whole gradient once, and the
finite check is agreed by every rank of the world, so no rank skips a
step alone.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.frontier import comm_device
from repro_torch.device import resolve_device
from repro_torch.models import common, parallel, transformer
from repro_torch.train import compression as compression_lib
from repro_torch.train import optimizer as opt_lib

COMPRESSION = ("none", "int8")


def lr_schedule(step, *, base_lr: float = 3e-4, warmup: int = 100,
                total: int = 10_000, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_frac``; a 0-d fp32
    tensor on ``step``'s device."""
    t = torch.as_tensor(step).to(torch.float32) + 1.0  # first update lr > 0
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(t < warmup, warm, cos)


def _split(batch: dict, mb: int) -> list[dict]:
    """``mb`` microbatches of a batch, cut along its first axis.  The
    batch must divide into them, as the reference's reshape demands: a
    remainder would go untrained."""
    out = [{} for _ in range(mb)]
    for key, a in batch.items():
        if a.shape[0] % mb:
            raise ValueError(f"batch {key!r} of {a.shape[0]} rows does not "
                             f"divide into {mb} microbatches")
        n = a.shape[0] // mb
        for i in range(mb):
            out[i][key] = a[i * n:(i + 1) * n]
    return out


def _mean_over_ranks(loss, metrics: dict, grads: dict, group,
                     compression: str, err: dict):
    """Loss, metrics and gradients averaged over the ranks of ``group``:
    one all-reduce of everything, or with ``compression="int8"`` the
    gradients through ``ddp_allreduce_int8`` (``err`` holds each leaf's
    error feedback across steps) and one all-reduce of the scalars.  The
    messages travel on the device the group's backend takes."""
    inv = 1.0 / dist.get_world_size(group)
    comm = comm_device(group)
    names = sorted(metrics)
    scalars = torch.stack([loss] + [metrics[k].to(torch.float32)
                                    for k in names]).to(comm)
    paths = list(grads)
    if compression == "int8":
        on_comm = {p: grads[p].to(comm) for p in paths}
        if not err:
            err.update(compression_lib.init_error_state(on_comm))
        mean, new_err = compression_lib.ddp_allreduce_int8(on_comm, err,
                                                           group)
        err.update(new_err)
        dist.all_reduce(scalars, group=group)
        scalars = scalars.mul_(inv)
        out = {p: mean[p].to(grads[p].device) for p in paths}
    else:
        flat = torch.cat([scalars] + [grads[p].reshape(-1).to(comm)
                                      for p in paths])
        dist.all_reduce(flat, group=group)
        flat = flat.mul_(inv)
        scalars, off, out = flat[:scalars.numel()], scalars.numel(), {}
        for p in paths:
            n = grads[p].numel()
            out[p] = flat[off:off + n].reshape(grads[p].shape).to(
                grads[p].device)
            off += n
    scalars = scalars.to(loss.device)
    return (scalars[0], {k: scalars[i + 1] for i, k in enumerate(names)},
            out)


def _grad_norm(grads: dict, plan, device) -> torch.Tensor:
    """The whole gradient's norm from this rank's shards: each leaf's
    squares summed over the groups that cut it (a replicated leaf's
    once), the same on every rank."""
    by = {k: torch.zeros((), dtype=torch.float32, device=device)
          for k in ((), ("model",), ("data",), ("data", "model"))}
    for path, g in grads.items():
        key = tuple(sorted(plan.axes_of(path)))
        by[key] = by[key] + torch.sum(g.to(torch.float32) ** 2)
    m = parallel.all_reduce(torch.stack([by[("model",)],
                                         by[("data", "model")]]), plan.model)
    d = parallel.all_reduce(torch.stack([by[("data",)], m[1]]), plan.data)
    return torch.sqrt(by[()] + m[0] + d[0] + d[1])


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4,
                    total_steps: int = 10_000, warmup: int = 100,
                    microbatch: int | None = None, group=None,
                    plan=None, compression: str = "none",
                    device: str | torch.device | None = "cuda") -> Callable:
    """The train step of one architecture config:
    (params, opt_state, batch) -> (params, opt_state, metrics), the first
    two updated in place.

    Gradients are accumulated in fp32 over ``microbatch`` slices of the
    batch (``cfg.microbatch`` by default).  If a gradient or the loss is
    not finite, every parameter and state leaf keeps its value, the step
    counter still advances and ``metrics["skipped"]`` is 1; the choice is
    made on the device.  Metrics are 0-d tensors on the device.

    With ``group`` (a ``torch.distributed`` group), every rank of it calls
    the step with its own shard of the batch; gradients, loss and metrics
    are averaged over the ranks (``compression`` "none": one all-reduce;
    "int8": ``compression.ddp_allreduce_int8`` with error feedback), so
    the ranks take the same step: on equal shards, the step a single
    process takes over the whole batch in ``microbatch`` x world
    slices.

    With ``plan`` (a ``parallel.Plan``; ``group`` is then its data group)
    the parameters and the optimizer state are this rank's shards, and
    the metrics add the plan's counts (``Plan.counts``).  Where "model"
    cuts the vocabulary, the loss runs over its blocks and each rank's
    gradient of its block is that block of one process's gradient, so
    the shards, the optimizer state and the norm keep their layout."""
    if compression not in COMPRESSION:
        raise ValueError(f"compression must be one of {COMPRESSION}, got "
                         f"{compression!r}")
    mb = microbatch if microbatch is not None else max(1, cfg.microbatch)
    dev = resolve_device(device)
    err: dict = {}                    # int8 error feedback, by leaf path
    fsdp: set = set()                 # leaves cut over the data axes
    if plan is not None:
        group = plan.data
        fsdp = {p for p in plan.flat if "data" in plan.axes_of(p)}

    def grads_of(params, batch):
        paths, leaves = zip(*common.leaves(params))
        live = [t.detach().requires_grad_(True) for t in leaves]
        tree = common.with_leaves(params, dict(zip(paths, live)))
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(
                tree, batch, cfg, device=dev, plan=plan)
            # a parameter the config never reads (a parallel block's
            # ln2) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(paths, grads)))

    def train_step(params, opt_state, batch):
        if mb > 1:
            loss = 0.0
            acc = {path: torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device)
                   for path, t in common.leaves(params)}
            sums: dict = {}
            for part in common.identical(_split(batch, mb),
                                         first_differs=True):
                l_i, m_i, g_i = grads_of(params, part)
                for path, g in g_i.items():
                    acc[path] += g.to(torch.float32)
                loss = loss + l_i
                for k, v in m_i.items():
                    sums[k] = sums[k] + v if k in sums else v
            grads = {path: g.mul_(1.0 / mb) for path, g in acc.items()}
            loss = loss / mb
            metrics = {k: v / mb for k, v in sums.items()}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if group is not None:
            # FSDP gradients are summed over the data ranks already
            rest = {p: g for p, g in grads.items() if p not in fsdp}
            loss, metrics, rest = _mean_over_ranks(loss, metrics, rest,
                                                   group, compression, err)
            inv = 1.0 / dist.get_world_size(group)
            grads = {p: rest[p] if p in rest else grads[p].mul_(inv)
                     for p in grads}
        by_path = grads
        grads = common.with_leaves(params, grads)

        lr = lr_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                         total=total_steps)
        flat = [g for _, g in common.leaves(grads)]
        ok = torch.isfinite(loss)
        for g in flat:
            ok = ok & torch.isfinite(g).all()
        if plan is None:
            gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                   for g in flat))
            cut = None
        else:                       # no rank skips a step alone
            ok = parallel.all_reduce(ok.to(torch.float32), dist.group.WORLD,
                                     dist.ReduceOp.MIN) > 0
            gnorm = _grad_norm(by_path, plan, loss.device)
            cut = {p: plan.dim_groups(p) for p in by_path}
        opt_lib.opt_update_(cfg.optimizer, grads, opt_state, params, lr=lr,
                            ok=ok, dim_groups=cut)
        metrics.update(loss=loss, lr=lr, grad_norm=gnorm,
                       skipped=(~ok).to(torch.int32))
        if plan is not None:
            metrics.update({k: torch.tensor(v, device=loss.device)
                            for k, v in plan.counts().items()})
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, plan=None,
                   device: str | torch.device | None = "cuda") -> Callable:
    """(params, batch) -> the loss's metrics, without autograd.  ``plan``
    (a ``parallel.Plan``): the parameters are this rank's shards and the
    batch its rows, as ``make_train_step(plan=)`` takes them; the
    metrics are averaged over the data group."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = transformer.loss_fn(params, batch, cfg, device=device,
                                         plan=plan)
        if plan is None or parallel.size(plan.data) == 1:
            return metrics
        names = sorted(metrics)
        mean = parallel.all_reduce(torch.stack(
            [metrics[k].to(torch.float32) for k in names]), plan.data)
        mean = mean / parallel.size(plan.data)
        return {k: mean[i] for i, k in enumerate(names)}
    return eval_step


def make_serve_step(cfg: ModelConfig, *, kv_shard=None, plan=None,
                    device: str | torch.device | None = "cuda") -> Callable:
    """One-token decode step: (params, tokens (B, 1), pos, cache) ->
    (logits (B, 1, V), cache).  ``kv_shard``: the group over which the
    full-attention caches split their positions (``decode_step``);
    ``plan``: a serving ``parallel.Plan``, the parameters this rank's
    shards and the cache its blocks by the decode ``cache_pspecs``."""
    def serve_step(params, tokens, pos, cache):
        return transformer.decode_step(params, tokens, pos, cache, cfg,
                                       kv_shard=kv_shard, plan=plan,
                                       device=device)
    return serve_step


def make_prefill_step(cfg: ModelConfig, *, plan=None,
                      device: str | torch.device | None = "cuda") -> Callable:
    """Prompt step: (params, batch {"tokens": (B, S)} or an enc_dec
    model's {"frames", "dec_tokens"}, cache) -> (last-position logits
    (B, 1, V), cache).  ``plan``: a serving ``parallel.Plan``, the
    parameters this rank's shards, the batch its rows and the cache its
    blocks by the prefill ``cache_pspecs``."""
    def prefill_step(params, batch, cache):
        return transformer.prefill(params, batch, cache, cfg, plan=plan,
                                   device=device)
    return prefill_step
