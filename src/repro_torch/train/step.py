"""Serving step factories, the counterparts of ``repro.train.step``'s
``make_prefill_step`` and ``make_serve_step``.  PyTorch runs eagerly, so
a step is a closure over the config and the device, not a jitted
function.  The train and eval steps wait for the training slice
(ROADMAP.md Queue 1, item 18)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


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
