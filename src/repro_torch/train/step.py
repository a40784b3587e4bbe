"""Train, eval and serving steps of the port, the counterparts of
``repro.train.step``: gradients accumulated in fp32 over microbatches,
a non-finite step skipped without a host round trip, and the learning
rate computed on the device.

PyTorch runs eagerly, so a step is a closure over the config and the
device, not a jitted function.  The train step updates the parameters
and the optimizer state in place and returns them, as the reference's
trainer donates them: a caller keeps no other use of what it passed.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.train import optimizer as opt_lib


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


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4,
                    total_steps: int = 10_000, warmup: int = 100,
                    microbatch: int | None = None,
                    device: str | torch.device | None = "cuda") -> Callable:
    """The train step of one architecture config:
    (params, opt_state, batch) -> (params, opt_state, metrics), the first
    two updated in place.

    Gradients are accumulated in fp32 over ``microbatch`` slices of the
    batch (``cfg.microbatch`` by default).  If a gradient or the loss is
    not finite, every parameter and state leaf keeps its value, the step
    counter still advances and ``metrics["skipped"]`` is 1; the choice is
    made on the device.  Metrics are 0-d tensors on the device."""
    transformer._check_family(cfg, train=True)
    mb = microbatch if microbatch is not None else max(1, cfg.microbatch)
    dev = resolve_device(device)

    def grads_of(params, batch):
        paths, leaves = zip(*common.leaves(params))
        live = [t.detach().requires_grad_(True) for t in leaves]
        tree = common.with_leaves(params, dict(zip(paths, live)))
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(
                tree, batch, cfg, device=dev)
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
            for part in _split(batch, mb):
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
        grads = common.with_leaves(params, grads)

        lr = lr_schedule(opt_state.step, base_lr=base_lr, warmup=warmup,
                         total=total_steps)
        flat = [g for _, g in common.leaves(grads)]
        ok = torch.isfinite(loss)
        for g in flat:
            ok = ok & torch.isfinite(g).all()
        gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                               for g in flat))
        opt_lib.opt_update_(cfg.optimizer, grads, opt_state, params, lr=lr,
                            ok=ok)
        metrics.update(loss=loss, lr=lr, grad_norm=gnorm,
                       skipped=(~ok).to(torch.int32))
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *,
                   device: str | torch.device | None = "cuda") -> Callable:
    """(params, batch) -> the loss's metrics, without autograd."""
    transformer._check_family(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = transformer.loss_fn(params, batch, cfg, device=device)
        return metrics
    return eval_step


def make_serve_step(cfg: ModelConfig, *,
                    device: str | torch.device | None = "cuda") -> Callable:
    """One-token decode step: (params, tokens (B, 1), pos, cache) ->
    (logits (B, 1, V), cache)."""
    def serve_step(params, tokens, pos, cache):
        return transformer.decode_step(params, tokens, pos, cache, cfg,
                                       device=device)
    return serve_step


def make_prefill_step(cfg: ModelConfig, *,
                      device: str | torch.device | None = "cuda") -> Callable:
    """Prompt step: (params, batch {"tokens": (B, S)}, cache) ->
    (last-position logits (B, 1, V), cache)."""
    def prefill_step(params, batch, cache):
        return transformer.prefill(params, batch, cache, cfg, device=device)
    return prefill_step
