"""Stand-ins for every (arch x shape) cell, and each rank's shard of them.

The counterpart of ``repro.launch.specs``.  Where the reference builds
``jax.ShapeDtypeStruct`` stand-ins, these are tensors on the ``meta``
device: shapes and dtypes, nothing allocated (``param_shapes`` of
nemotron-4-340b describes 341 B parameters).  ``build_cell`` gives a
cell's step function (``train.make_train_step``, ``make_prefill_step``
or ``make_serve_step``) and its meta arguments.

The reference's sharding rules (its DESIGN.md §7) place the batch over
the data axes, parameters by their logical axes (tensor parallel over
"model", FSDP over the data axes for the largest archs), the optimizer
state as its parameters, and a decode cell's full-attention caches over
"model" by heads, or, where the batch cannot be split (long_500k) or
the KV heads do not divide "model", by their positions
(``kv_shard_axes``).  ``param_pspecs`` and ``opt_specs`` give the
parameters' and the optimizer state's specs by the reference's resolver
(``common.resolve_pspecs``, ``optimizer.opt_state_specs``): a spec is a
tuple with one entry a dim, as a ``PartitionSpec`` holds them, and
``cache_pspecs`` the caches' by the reference's own function.  A rank
of the port holds its shard of what it steps on and nothing else
(``launch.train --mesh DxM``, ``launch.serve.greedy_generate(plan=)``),
so ``shard_shapes`` gives the per-rank shapes of a cell's batch,
caches, parameters and optimizer state on a ``mesh.MeshSpec``, by those
rules; ``cache_blocks`` cuts a whole cache into a rank's blocks and
``recut_cache`` takes a rank's prefill blocks to the decode layout.
``core.distributed`` has no counterpart of ``index_pspecs``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common, transformer
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Whole shapes
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, cell: ShapeCell, *,
                act_dtype: torch.dtype = torch.bfloat16) -> dict:
    """A cell's train or prefill batch, on the meta device."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.enc_dec:
        return {"frames": _meta((b, s, cfg.d_model), act_dtype),
                "dec_tokens": _meta((b, cfg.decoder_len), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.n_patches
        return {"patches": _meta((b, p, cfg.d_model), act_dtype),
                "tokens": _meta((b, s - p), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device: a normal-initialized leaf
    in the config's ``param_dtype``, the others in their spec's dtype, as
    the reference's ``params_shape_tree``."""
    dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
        else torch.float32

    def leaf(spec: common.ParamSpec) -> torch.Tensor:
        return _meta(spec.shape, dtype if spec.init == "normal"
                     else spec.dtype)
    return common.tree_map(leaf, transformer.param_specs(cfg))


def opt_shapes(cfg: ModelConfig):
    """The optimizer state of ``cfg.optimizer`` on the meta device."""
    return opt_lib.opt_init(cfg.optimizer, param_shapes(cfg))


def param_pspecs(cfg: ModelConfig, mesh, data_axes: tuple | None = None
                 ) -> dict:
    """The spec tree of the parameters on ``mesh`` (a ``MeshSpec`` or a
    ``DeviceMesh``): tensor parallel over "model", then, for an
    ``fsdp`` config, over ``data_axes`` (all but "model" by default)."""
    if data_axes is None:
        data_axes = mesh_lib.data_axes_of(mesh)
    specs = transformer.param_specs(cfg)
    return common.resolve_pspecs(common.axes_tree(specs), param_shapes(cfg),
                                 mesh_lib.axis_sizes(mesh), fsdp=cfg.fsdp,
                                 data_axes=tuple(data_axes))


def opt_specs(cfg: ModelConfig, mesh, data_axes: tuple | None = None):
    """(the optimizer state on the meta device, its spec tree)."""
    return (opt_shapes(cfg),
            opt_lib.opt_state_specs(cfg.optimizer,
                                    param_pspecs(cfg, mesh, data_axes),
                                    param_shapes(cfg)))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16) -> list:
    """``transformer.init_cache``'s cache on the meta device."""
    return transformer.init_cache(cfg, batch, max_len, dtype, device=META)


def runnable_shapes(cfg: ModelConfig) -> list[str]:
    """The cells this arch runs: long_500k only for sub-quadratic archs."""
    return [s for s in SHAPES if cfg.runs_shape(s)]


# ---------------------------------------------------------------------------
# Each rank's shard on a mesh
# ---------------------------------------------------------------------------


def _divisible(n: int, sizes: dict, axis: str) -> bool:
    return axis in sizes and n % sizes[axis] == 0


def _batch_entry(batch: int, sizes: dict, data_axes: tuple):
    """The batch dim's spec entry: the data axes (a name, or a tuple of
    them) where they divide ``batch``, else None."""
    if not data_axes or batch % math.prod(sizes[a] for a in data_axes):
        return None
    return data_axes if len(data_axes) > 1 else data_axes[0]


def kv_shard_axes(cfg: ModelConfig, cell: ShapeCell, mesh,
                  data_axes: tuple[str, ...]) -> tuple | None:
    """The axes over which a decode cell's full-attention caches split
    their positions: the data axes for long_500k (a batch of 1 cannot
    split), "model" where the KV heads do not divide it (splitting
    head_dim instead would gather the whole cache every step), else
    None."""
    if cell.kind != "decode":
        return None
    sizes = mesh_lib.axis_sizes(mesh)
    nd = math.prod(sizes[a] for a in data_axes)
    if cell.global_batch % nd != 0:
        return data_axes                      # long_500k
    if cfg.enc_dec or cfg.family == "ssm":
        return None
    if "model" in sizes and not _divisible(cfg.n_kv_heads, sizes, "model") \
            and cell.seq_len % sizes["model"] == 0:
        return ("model",)
    return None


def cache_pspecs(cfg: ModelConfig, cell: ShapeCell, mesh,
                 data_axes: tuple[str, ...], kv_shard: tuple | None = None
                 ) -> list:
    """The spec tree of ``init_cache``'s cache, the reference's
    ``cache_pspecs``: the batch over the data axes where it divides; K/V
    heads over "model" where they divide; with ``kv_shard``
    (``kv_shard_axes`` of a decode cell) the full-attention segments'
    positions over those axes, the batch then over the data axes only
    where the positions are over "model"; Hymba's ``m_h`` / ``m_conv``
    over "model" by channel and RWKV's state by head where those
    divide."""
    sizes = mesh_lib.axis_sizes(mesh)
    bp = _batch_entry(cell.global_batch, sizes, data_axes)
    mdl = "model"

    def kv_spec(full_attn: bool) -> tuple:
        h_ax = mdl if _divisible(cfg.n_kv_heads, sizes, mdl) else None
        if kv_shard and full_attn:
            s_ax = kv_shard if len(kv_shard) > 1 else kv_shard[0]
            if "model" in kv_shard:
                return (None, bp, s_ax, None, None)
            return (None, None, s_ax, h_ax, None)
        return (None, bp, None, h_ax, None)

    if cfg.enc_dec:
        sp = kv_spec(False)
        return [dict(k=sp, v=sp, xk=sp, xv=sp)]
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_head_dim
        h_ax = mdl if _divisible(h, sizes, mdl) else None
        return [dict(s=(None, bp, h_ax, None, None),
                     x_tm=(None, bp, None), x_cm=(None, bp, None))]
    out = []
    for seg in transformer.segments(cfg):
        full = seg.kind == "full"
        c = dict(k=kv_spec(full), v=kv_spec(full))
        if cfg.family == "hybrid":
            d_ax = mdl if _divisible(cfg.q_dim, sizes, mdl) else None
            c.update(m_h=(None, bp, d_ax, None),
                     m_conv=(None, bp, None, d_ax))
        out.append(c)
    return out


def cut_cache_shapes(caches: list, spec_tree: list, sizes: dict) -> list:
    """Each leaf's shape on a rank under ``spec_tree`` (``caches``' leaves
    are tensors, meta ones included)."""
    return [{k: common.shard_shape(tuple(seg[k].shape), sp[k], sizes)
             for k in seg} for seg, sp in zip(caches, spec_tree)]


def cache_blocks(cache: list, spec_tree: list, coords: dict,
                 sizes: dict) -> list:
    """The rank at ``coords`` ({axis: index}) of a mesh of ``sizes``: its
    blocks of a whole cache (a copy of each) under ``spec_tree``
    (``cache_pspecs``' layout).  Every cut dim must split evenly."""
    cut_cache_shapes(cache, spec_tree, sizes)          # raises if one does not
    return [{k: common.shard(t, sp[k], coords, sizes) for k, t in seg.items()}
            for seg, sp in zip(cache, spec_tree)]


def recut_cache(cache: list, src: list, dst: list, coords: dict,
                sizes: dict) -> list:
    """A rank's cache blocks under spec tree ``src`` (a prefill's) re-cut
    to ``dst`` (the decode's), on the rank itself: ``dst`` must cut every
    dim that ``src`` cuts the same way, and may cut more (the
    full-attention positions over ``kv_shard_axes``); the rank keeps its
    block of each further cut dim and sends nothing.  A leaf that keeps
    its layout is the same tensor."""
    out = []
    for seg, s_sp, d_sp in zip(cache, src, dst):
        new = {}
        for k, t in seg.items():
            a = tuple(s_sp[k]) + (None,) * (t.ndim - len(s_sp[k]))
            b = tuple(d_sp[k]) + (None,) * (t.ndim - len(d_sp[k]))
            if a == b:
                new[k] = t
                continue
            if any(x is not None and x != y for x, y in zip(a, b)):
                raise ValueError(f"{k}: {b} does not refine {a}: the "
                                 "blocks would move between ranks")
            extra = tuple(y if x is None else None for x, y in zip(a, b))
            common.shard_shape(tuple(t.shape), extra, sizes)
            new[k] = common.shard(t, extra, coords, sizes)
        out.append(new)
    return out


def serving_specs(cfg: ModelConfig, mesh, batch: int, max_len: int
                  ) -> dict:
    """The layout of a serving request of ``batch`` sequences and a cache
    of ``max_len`` positions (``init_cache``'s) on ``mesh``, as the
    reference lays out a prefill cell and a decode cell of those sizes:
    "batch" the batch dim's spec entry, "prefill" and "decode" the cache
    spec trees, "kv_shard" the axes the decode's full-attention
    positions split over (None where no such cache splits: an ssm or
    enc_dec model, or no axis needs it)."""
    data = mesh_lib.data_axes_of(mesh)
    pre = ShapeCell("serve_prefill", max_len, batch, "prefill")
    dec = ShapeCell("serve_decode", max_len, batch, "decode")
    kvs = kv_shard_axes(cfg, dec, mesh, data)
    return {"batch": _batch_entry(batch, mesh_lib.axis_sizes(mesh), data),
            "prefill": cache_pspecs(cfg, pre, mesh, data),
            "decode": cache_pspecs(cfg, dec, mesh, data, kv_shard=kvs),
            "kv_shard": None if cfg.enc_dec or cfg.family == "ssm" else kvs}


def state_shard_shapes(cfg: ModelConfig, mesh) -> dict:
    """Each rank's shapes of the parameters ("params") and of the
    optimizer state ("opt", the state's NamedTuple of shape trees; its
    step ()) on ``mesh``, by ``param_pspecs`` and ``opt_specs``."""
    sizes = mesh_lib.axis_sizes(mesh)
    p_specs = param_pspecs(cfg, mesh)
    o_shapes, o_specs = opt_specs(cfg, mesh)

    def cut(shapes, specs):
        sp = dict(common.leaves(specs))
        return common.with_leaves(shapes, {
            path: common.shard_shape(tuple(t.shape), sp[path], sizes)
            for path, t in common.leaves(shapes)})
    opt = type(o_shapes)((), *(cut(getattr(o_shapes, f), getattr(o_specs, f))
                               for f in o_shapes._fields[1:]))
    return {"params": cut(param_shapes(cfg), p_specs), "opt": opt}


def held_elements(shapes: dict) -> int:
    """Elements a tree of shapes holds."""
    return sum(math.prod(s) for _, s in common.leaves(shapes))


def shard_shapes(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Each rank's shapes of a cell's batch ("batch", train and prefill
    cells) and caches ("cache", prefill and decode cells; decode also
    "tokens") on ``mesh`` (a ``MeshSpec`` or a ``DeviceMesh``), and, on
    a mesh with a "model" axis, of the parameters ("params") and, in a
    train cell, the optimizer state ("opt"; ``state_shard_shapes``), by
    the reference's rules: the batch over the data axes where it divides;
    a K/V cache's heads over "model" where they divide, its positions
    over ``kv_shard_axes`` in a decode cell's full-attention segments
    (then its batch is over the data axes only where the positions are
    over "model"); Mamba states over "model" by channel and RWKV states
    by head where those divide."""
    cell = SHAPES[shape_name]
    sizes = mesh_lib.axis_sizes(mesh)
    data = mesh_lib.data_axes_of(mesh)
    bp = _batch_entry(cell.global_batch, sizes, data)
    out: dict = {}
    if "model" in sizes:
        state = state_shard_shapes(cfg, mesh)
        out["params"] = state["params"]
        if cell.kind == "train":
            out["opt"] = state["opt"]
    if cell.kind in ("train", "prefill"):
        out["batch"] = {k: common.shard_shape(tuple(t.shape), (bp,), sizes)
                        for k, t in batch_specs(cfg, cell).items()}
    if cell.kind == "train":
        return out
    kvs = kv_shard_axes(cfg, cell, mesh, data)
    out["cache"] = cut_cache_shapes(
        cache_shapes(cfg, cell.global_batch, cell.seq_len),
        cache_pspecs(cfg, cell, mesh, data, kv_shard=kvs), sizes)
    if cell.kind == "decode":
        out["tokens"] = common.shard_shape((cell.global_batch, 1), (bp,),
                                           sizes)
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step function
    args: tuple                     # its arguments, on the meta device
    kv_shard_axes: tuple | None     # decode: the axes the caches split over
    shards: dict | None             # shard_shapes on the mesh, if one given


def build_cell(cfg: ModelConfig, shape_name: str, mesh=None, *,
               act_dtype: torch.dtype = torch.bfloat16) -> Cell:
    """One cell's step function and its meta arguments: train (params,
    optimizer state, batch), prefill (params, batch, cache), decode
    (params, tokens (B, 1), pos, cache of ``seq_len`` positions).  With
    ``mesh``, also each rank's shard shapes and, for a decode cell, the
    axes its full-attention caches split their positions over (the
    step's ``kv_shard`` group is made from those axes by the caller)."""
    cell = SHAPES[shape_name]
    kvs, shards = None, None
    if mesh is not None:
        kvs = kv_shard_axes(cfg, cell, mesh, mesh_lib.data_axes_of(mesh))
        shards = shard_shapes(cfg, shape_name, mesh)
    params = param_shapes(cfg)
    if cell.kind == "train":
        fn = step_lib.make_train_step(cfg, device=META)
        args = (params, opt_shapes(cfg),
                batch_specs(cfg, cell, act_dtype=act_dtype))
    elif cell.kind == "prefill":
        fn = step_lib.make_prefill_step(cfg, device=META)
        args = (params, batch_specs(cfg, cell, act_dtype=act_dtype),
                cache_shapes(cfg, cell.global_batch, cell.seq_len))
    else:
        fn = step_lib.make_serve_step(cfg, device=META)
        args = (params, _meta((cell.global_batch, 1), torch.int32),
                _meta((), torch.int32),
                cache_shapes(cfg, cell.global_batch, cell.seq_len))
    return Cell(cfg.name, shape_name, cell.kind, fn, args, kvs, shards)
