"""Shared model machinery: parameter specs and their initialisation,
norms, RoPE, activations.

The PyTorch counterpart of ``repro.models.common``.  Parameters are plain
nested dicts of tensors with the reference's names and stacked (L, ...)
layouts, so carrying weights across is a name-for-name copy
(``repro_torch.interop``).  The logical sharding axes and their resolver
wait for the distributed slice; a spec keeps its ``axes`` so the trees
stay comparable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


@dataclasses.dataclass
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | value
    scale: float = 1.0
    value: float = 0.0
    dtype: torch.dtype = torch.float32

    def make(self, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
        """The reference's init rules: zeros, ones, a constant, or a normal
        with std ``scale / sqrt(fan_in)``, fan_in the second-to-last dim."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "value":
            return torch.full(self.shape, self.value, dtype=self.dtype,
                              device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        out = torch.randn(self.shape, generator=generator, device=device)
        return out.mul_(std).to(self.dtype)


def leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict in sorted key order, the order
    in which ``jax.tree`` flattens a dict."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def tree_map(fn: Callable[[Any], Any], tree: dict) -> dict:
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def with_leaves(tree: dict, values: dict) -> dict:
    """``tree``'s nested-dict structure with the leaf at each path (a
    tuple of keys, as ``leaves`` gives them) taken from ``values``."""
    def go(node, prefix):
        return {k: go(v, prefix + (k,)) if isinstance(v, dict)
                else values[prefix + (k,)] for k, v in node.items()}
    return go(tree, ())


def build_params(specs: dict, generator: torch.Generator,
                 device: str | torch.device | None = "cuda") -> dict:
    """Instantiate a nested dict of ParamSpec on ``device`` (the card by
    default), drawing the normal leaves from ``generator`` one after the
    other in sorted key order.  The generator must live on that device."""
    dev = resolve_device(device)
    out: dict = {}
    for path, spec in leaves(specs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = spec.make(generator, dev)
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma), in float32."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.to(torch.float32))).to(dt)


def _squared_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if kind == "silu":
        return F.silu
    if kind == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "squared_relu":
        return _squared_relu
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x (..., S, H, hd); positions (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)        # (..., S, 1, half)
    dt = x.dtype
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(dt)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Loops of identical bodies, as a count sees them
# ---------------------------------------------------------------------------

# ``launch.op_analysis``'s counter while it counts a call, else None
loop_counter = None


def identical(items, key: str | None = None, *,
              first_differs: bool = False):
    """``items``, the inputs of a loop whose bodies do the same work (a
    run of identical layers, a query chunk's KV chunks, the microbatches
    of a step).  Outside a count it returns ``items`` unchanged.  In a
    count, the counter runs a few of the bodies and multiplies their
    work, as the reference's HLO analysis multiplies a ``while`` body by
    its trip count (``launch.op_analysis``): with ``first_differs`` the
    first body runs alone and the second stands for the rest; loops
    given the same ``key`` in one enclosing body (a stack's runs of one
    layer kind) share their bodies."""
    if loop_counter is None:
        return items
    return loop_counter.loop(list(items), key, first_differs)
