"""Shared model machinery: parameter specs and their initialisation,
the logical-axis resolver that places each parameter on a mesh, norms,
RoPE, activations.

The PyTorch counterpart of ``repro.models.common``.  Parameters are plain
nested dicts of tensors with the reference's names and stacked (L, ...)
layouts, so carrying weights across is a name-for-name copy
(``repro_torch.interop``).  Each leaf's *logical axes* (one name a dim,
e.g. ``("layers", "embed", "q_heads")``) are kept in its spec;
``resolve_pspecs`` turns them into a spec tree for a mesh, by the
reference's priorities and divisibility fallbacks.  A spec is a tuple
with one entry a dim, as ``jax.sharding.PartitionSpec`` holds them: an
axis name, a tuple of axis names, or None (the dim is whole).  ``shard``
cuts a whole tensor into one rank's contiguous block of it, as JAX
places a ``NamedSharding``; ``unshard`` puts the blocks back together.
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


def axes_tree(specs: dict) -> dict:
    """The logical axes of every leaf of a ParamSpec tree."""
    return tree_map(lambda s: s.axes, specs)


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


# ---------------------------------------------------------------------------
# Logical axis -> mesh axis resolution
# ---------------------------------------------------------------------------

# mesh-axis placement preferences a logical axis, tried in order; a
# placement is taken only if the dim's size divides the mesh axis's
MODEL_AXIS_PRIORITY = ("experts", "vocab", "ff", "q_heads", "kv_fused",
                       "kv_heads", "d_inner", "heads_x_dim", "embed_out")
FSDP_AXIS_PRIORITY = ("embed", "ff_in", "frames")


def _place(dims: tuple, shape: tuple, priority: tuple, mesh_size: int,
           taken: set) -> int | None:
    for want in priority:
        for i, name in enumerate(dims):
            if name == want and i not in taken and shape[i] % mesh_size == 0:
                return i
    return None


def resolve_pspec(axes: tuple, shape: tuple, sizes: dict, *, fsdp: bool,
                  data_axes: tuple, model_axis: str = "model") -> tuple:
    """One leaf's spec from its logical axes: the first dim of
    ``MODEL_AXIS_PRIORITY`` that the model axis divides goes over it;
    with ``fsdp``, then the first of ``FSDP_AXIS_PRIORITY`` that the data
    axes together divide goes over them.  ``sizes``: {axis: size} of the
    mesh."""
    entries: list = [None] * len(axes)
    taken: set = set()
    msize = sizes.get(model_axis, 1)
    if msize > 1:
        i = _place(axes, shape, MODEL_AXIS_PRIORITY, msize, taken)
        if i is not None:
            entries[i] = model_axis
            taken.add(i)
    if fsdp and data_axes:
        dsize = math.prod(sizes[a] for a in data_axes)
        i = _place(axes, shape, FSDP_AXIS_PRIORITY, dsize, taken)
        if i is not None:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            taken.add(i)
    return tuple(entries)


def resolve_pspecs(axes_t: dict, shapes_t: dict, sizes: dict, *,
                   fsdp: bool, data_axes: tuple) -> dict:
    """The spec tree of a whole parameter tree (``shapes_t``'s leaves are
    tensors, meta ones included, or shapes)."""
    shapes = dict(leaves(shapes_t))
    return with_leaves(axes_t, {
        path: resolve_pspec(a, tuple(getattr(shapes[path], "shape",
                                             shapes[path])),
                            sizes, fsdp=fsdp, data_axes=data_axes)
        for path, a in leaves(axes_t)})


def spec_axes(entry) -> tuple:
    """The mesh axes a spec entry names, in order: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(entry, coords: dict, sizes: dict) -> tuple[int, int]:
    """(index, count) of a rank's block along a dim of spec ``entry``:
    the rank's coordinates over the entry's axes, the first major."""
    idx, count = 0, 1
    for a in spec_axes(entry):
        idx, count = idx * sizes[a] + coords[a], count * sizes[a]
    return idx, count


def shard_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    """What ``spec`` leaves of ``shape`` on every rank."""
    out = []
    for i, n in enumerate(shape):
        count = _block(spec[i] if i < len(spec) else None,
                       dict.fromkeys(sizes, 0), sizes)[1]
        if n % count:
            raise ValueError(f"dim {n} does not split over {spec[i]}")
        out.append(n // count)
    return tuple(out)


def shard(t: torch.Tensor, spec: tuple, coords: dict, sizes: dict
          ) -> torch.Tensor:
    """The rank at ``coords`` ({axis: index}) of a mesh of ``sizes``: its
    contiguous block of the whole tensor ``t`` under ``spec``, a copy (so
    the whole tensor can be freed)."""
    out = t
    for i, entry in enumerate(spec):
        idx, count = _block(entry, coords, sizes)
        if count > 1:
            n = t.shape[i] // count
            out = out.narrow(i, idx * n, n)
    return out.clone(memory_format=torch.contiguous_format)


def unshard(blocks: list, spec: tuple, shape: tuple, axis_names: tuple
            ) -> torch.Tensor:
    """``shard``'s inverse: the whole tensor from the blocks of every rank
    of a mesh of ``shape`` over ``axis_names``, ``blocks[r]`` rank r's in
    row-major order over the axes."""
    sizes = dict(zip(axis_names, shape))
    first = blocks[0]
    whole = tuple(n * _block(spec[i] if i < len(spec) else None,
                             dict.fromkeys(sizes, 0), sizes)[1]
                  for i, n in enumerate(first.shape))
    out = first.new_empty(whole)
    for r, b in enumerate(blocks):
        coords = dict(zip(axis_names, _coords(r, shape)))
        view = out
        for i, entry in enumerate(spec):
            idx, count = _block(entry, coords, sizes)
            if count > 1:
                view = view.narrow(i, idx * b.shape[i], b.shape[i])
        view.copy_(b)
    return out


def _coords(rank: int, shape: tuple) -> tuple:
    """A rank's coordinates on a mesh of ``shape``, row-major."""
    out = []
    for n in reversed(shape):
        rank, c = divmod(rank, n)
        out.append(c)
    return tuple(reversed(out))


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
