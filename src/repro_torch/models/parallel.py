"""The model axis: the collectives of tensor-, expert- and fully sharded
data parallelism as autograd Functions, and one rank's plan of which
parameter runs which way.

The reference places its parameters by ``PartitionSpec``s and lets GSPMD
insert the collectives.  Here each collective is explicit, on
``torch.distributed`` groups for the mesh's "data" and "model" axes:

  * ``copy_to(x, group)``: forward the identity, backward an all-reduce
    SUM.  It enters a region whose ranks each compute a part of a
    replicated input's consumers (the heads of a layer, its FFN columns,
    its experts), so each holds a part of that input's gradient.
  * ``reduce_from(x, group)``: forward an all-reduce SUM of the ranks'
    partial outputs, backward the identity.  It leaves such a region.
  * ``gather_leaf(shard, dim, group, kind)``: forward an all-gather of a
    parameter's blocks along ``dim``.  Over "model" every rank then
    computes the same whole gradient, and the backward keeps this rank's
    slice of it.  Over the data axes (FSDP) each rank's gradient comes
    from its own rows, and the backward is a reduce-scatter SUM: such a
    gradient is already summed over the data ranks.
  * ``gather_acts(x, group)``: forward an all-gather of the ranks'
    blocks of an activation along its last dim, backward a
    reduce-scatter SUM: each rank's consumers compute a part of the
    gathered tensor's gradient (the heads of an attention whose column
    blocks cut a head, ``transformer._qkv``).
  * ``reduce_scatter(x, group)``: forward the SUM of the ranks' partial
    outputs, of which this rank keeps its block of the last dim;
    backward an all-gather, since each rank's partial product needs the
    whole gradient (RWKV's channel mix, ``rwkv.channel_mix``).
  * ``gather_replicated(x, group)``: forward an all-gather of such
    blocks along the last dim into a tensor that replicated consumers
    read (the residual); backward this rank's slice of the gradient,
    which every rank already holds whole.  It is ``gather_leaf``'s
    "model" kind, not ``gather_acts``, whose reduce-scatter would count
    that replicated gradient M times.

Messages travel on the device that the group's backend takes
(``core.frontier.comm_device``): the card for NCCL, the host for gloo.
The reduce-scatter is an all-reduce and this rank's slice on every
backend (gloo has no reduce-scatter), so gloo and NCCL compute the same
numbers.

``Plan`` decides once, from the reference's specs (``launch.specs.
param_pspecs``), which blocks run tensor-parallel: attention whose
``wq``/``wk``/``wv`` columns and ``wo`` rows lie over "model"
(column-parallel projections, a row-parallel ``wo``, one
``reduce_from``), by whole heads where the KV heads divide M, else
"ragged": the cut falls inside a head, and the rank gathers the
projected activations of the heads it needs (``transformer._qkv``); an
FFN whose ``ff`` dim lies over "model"; a MoE whose experts split over
"model" (``moe.moe_ffn_ep``); Hymba's Mamba by channel (its ``d_inner``
leaves over "model", its ``w_in`` block's projection gathered,
``mamba.mamba_mix(tp=)``); RWKV's time mix by head (``w_r``/``w_k``/
``w_v``/``w_g`` columns, ``w_o`` rows, ``bonus_u``) and its channel mix
by ``ff`` (``w_ck`` columns, ``w_cv`` rows, ``w_cr`` columns;
``rwkv.rwkv_layer(tp=, ffn_tp=)``).  Training and serving take the same
plan.  Where "model" cuts the vocabulary (dim 0 of ``embed``, dim 1 of
``lm_head``), the plan keeps those blocks local (``Plan.vocab``): the
lookup, the head, the cross-entropy and the greedy pick run over the
vocabulary shards (``transformer.vocab_embed``, ``vocab_logits``,
``launch.serve.greedy_pick``).  Every other sharded leaf is gathered
where it is used (``Plan.take``), inside the per-layer checkpoint, so
the backward gathers it again and no whole stack is held.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.frontier import comm_device
from repro_torch.models import common

MODEL = "model"
# the blocks that can run tensor-parallel, by their path in the tree
ATTN_BLOCKS = (("layers", "attn"), ("dec", "attn"), ("dec", "xattn"))
FFN_BLOCKS = (("layers", "ffn"), ("dec", "ffn"))
MOE_BLOCK = ("layers", "moe")
MAMBA_BLOCK = ("layers", "mamba")
# RWKV's leaves lie in "layers" itself: its two halves are named blocks
RWKV_TIME, RWKV_CHANNEL = ("layers", "time_mix"), ("layers", "channel_mix")
# the leaves a Mamba or RWKV block keeps local, each with the dim that
# "model" must cut (of the stacked (L, ...) leaf); RWKV's ``ln_x``,
# token-shift mixes and decay LoRA are not cut over "model"
MAMBA_LOCAL = dict(w_in=-1, conv=-1, w_dt=1, dt_bias=-1, w_b=1, w_c=1,
                   a_log=1, d_skip=-1, w_out=1)
RWKV_TIME_LOCAL = dict(w_r=-1, w_k=-1, w_v=-1, w_g=-1, w_o=1, bonus_u=1)
RWKV_CHANNEL_LOCAL = dict(w_ck=-1, w_cr=-1, w_cv=1)
# the vocabulary's leaves, each with its vocab dim
VOCAB_LOCAL = {("embed",): 0, ("lm_head",): 1}
STACKS = ("layers", "dec")       # stacked (L, ...) subtrees


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# Plain collectives (no autograd), on the backend's device
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor; ``t`` itself for one
    rank), on ``t``'s device."""
    if size(group) == 1:
        return t
    buf = t.to(comm_device(group), copy=True,
               memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of every rank of ``group``, joined along ``dim`` in
    rank order, on ``t``'s device."""
    if size(group) == 1:
        return t
    buf = t.to(comm_device(group), copy=True,
               memory_format=torch.contiguous_format)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``."""
    n = t.shape[dim] // size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n).contiguous()


# ---------------------------------------------------------------------------
# The collectives as autograd Functions
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(all_reduce(x, group), -1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, -1, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, kind):
        ctx.dim, ctx.group, ctx.kind = dim, group, kind
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.kind != MODEL:      # FSDP, activations: a reduce-scatter SUM
            g = all_reduce(g, ctx.group)
        return _slice(g, ctx.dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the gradient over ``group``."""
    return x if size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward is the identity."""
    return x if size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_leaf(shard: torch.Tensor, dim: int, group, kind: str
                ) -> torch.Tensor:
    """A parameter's blocks gathered along ``dim`` over ``group``;
    ``kind`` "model" (the backward keeps this rank's slice) or "data"
    (the backward is a reduce-scatter SUM)."""
    if size(group) == 1:
        return shard
    return _Gather.apply(shard, dim, group, kind)


def gather_acts(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of an activation, joined along the last dim in
    rank order; the backward is a reduce-scatter SUM (each rank's
    consumers give a part of the gradient)."""
    if size(group) == 1:
        return x
    return _Gather.apply(x, -1, group, "acts")


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the last dim of the sum of ``x`` over
    ``group``; the backward is an all-gather."""
    return x if size(group) == 1 else _ReduceScatter.apply(x, group)


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of an activation that replicated consumers
    read, joined along the last dim in rank order; the backward keeps
    this rank's slice of the (whole, replicated) gradient."""
    if size(group) == 1:
        return x
    return _Gather.apply(x, -1, group, MODEL)


# ---------------------------------------------------------------------------
# One rank's plan
# ---------------------------------------------------------------------------


def _is(spec: tuple, dim: int, axis: str = MODEL) -> bool:
    return len(spec) >= abs(dim) and spec[dim] == axis


def ragged(cfg, m: int) -> bool:
    """Whether a tensor-parallel attention over ``m`` ranks cuts a KV
    head (and then maybe a q head): its column blocks are not whole
    heads."""
    return m > 1 and cfg.n_kv_heads % m != 0


def _tensor_parallel(cfg, flat: dict, m: int) -> dict:
    """{block path: the leaf paths it keeps local} for each block that
    runs tensor- or expert-parallel over a model axis of ``m`` ranks."""
    out: dict = {}
    if m <= 1:
        return out
    for blk in ATTN_BLOCKS:
        names = ("wq", "wk", "wv", "wo")
        if blk + ("wq",) not in flat:
            continue
        cols = all(_is(flat[blk + (n,)], -1) for n in names[:3])
        if cols and _is(flat[blk + ("wo",)], -2):
            out[blk] = tuple(blk + (n,) for n in names)
    for blk in FFN_BLOCKS:
        names = tuple(n for n in ("wg", "wu", "wd") if blk + (n,) in flat)
        if not names:
            continue
        if all(_is(flat[blk + (n,)], -2 if n == "wd" else -1)
               for n in names):
            out[blk] = tuple(blk + (n,) for n in names)
    if MOE_BLOCK + ("wg",) in flat and cfg.n_experts % m == 0 and all(
            _is(flat[MOE_BLOCK + (n,)], 1) for n in ("wg", "wu", "wd")):
        out[MOE_BLOCK] = tuple(MOE_BLOCK + (n,) for n in ("wg", "wu", "wd"))
    return out


def _local(flat: dict, prefix: tuple, dims: dict) -> tuple | None:
    """The paths of ``dims``' leaves under ``prefix`` if "model" cuts
    each at its dim, else None."""
    paths = tuple(prefix + (n,) for n in dims)
    if all(p in flat and _is(flat[p], d) for p, d in zip(paths,
                                                           dims.values())):
        return paths
    return None


def _recurrent_parallel(cfg, flat: dict, m: int) -> dict:
    """The recurrent blocks that run over a model axis of ``m`` ranks:
    Hymba's Mamba by channel where ``q_dim`` (its ``d_inner``) divides
    ``m``, ``w_in`` by its block of the fused x|z columns, RWKV's time mix
    by whole heads where they divide ``m`` and its channel mix by ``ff``
    (``w_cr`` by its column block)."""
    out: dict = {}
    if m <= 1:
        return out
    if cfg.family == "hybrid" and cfg.q_dim % m == 0:
        keep = _local(flat, MAMBA_BLOCK, MAMBA_LOCAL)
        if keep:
            out[MAMBA_BLOCK] = keep
    if cfg.family == "ssm":
        if (cfg.d_model // cfg.rwkv_head_dim) % m == 0:
            keep = _local(flat, ("layers",), RWKV_TIME_LOCAL)
            if keep:
                out[RWKV_TIME] = keep
        keep = _local(flat, ("layers",), RWKV_CHANNEL_LOCAL)
        if keep:
            out[RWKV_CHANNEL] = keep
    return out


def _vocab_parallel(flat: dict, m: int) -> tuple:
    """The paths of the vocabulary's leaves if "model" cuts each at its
    vocab dim (a tied model has ``embed`` alone), else ()."""
    if m <= 1:
        return ()
    paths = tuple(p for p in VOCAB_LOCAL if p in flat)
    if all(_is(flat[p], VOCAB_LOCAL[p]) for p in paths):
        return paths
    return ()


class Plan:
    """How one rank of a (data, model) mesh holds and uses the parameters.

    ``specs``: the spec tree of the parameters (``launch.specs.
    param_pspecs``); ``model`` and ``data``: this rank's groups of the
    model axis and of the data axes together (None: one rank).  A spec
    entry "model" is cut over ``model``, any other (a data axis or a
    tuple of them) over ``data``.  ``mesh`` (a ``launch.mesh.MeshSpec``)
    and ``coords`` ({axis: index}, this rank's place on it): what a
    serving run needs to cut its batch and caches (``launch.serve.
    greedy_generate``).  ``vocab``: the model
    group where it cuts the vocabulary of ``embed`` (and ``lm_head``),
    whose blocks are then used where they lie, else None."""

    def __init__(self, cfg, specs: dict, *, model=None, data=None,
                 mesh=None, coords: dict | None = None):
        self.specs = specs
        self.flat = dict(common.leaves(specs))
        self.model, self.data = model, data
        self.mesh, self.coords = mesh, coords
        m = size(model)
        blocks = _tensor_parallel(cfg, self.flat, m)
        recurrent = _recurrent_parallel(cfg, self.flat, m)
        blocks.update(recurrent)
        self.tp_blocks = frozenset(blocks)
        self.keep = frozenset(p for paths in blocks.values() for p in paths)
        self.vocab_leaves = _vocab_parallel(self.flat, m)
        self.vocab = model if self.vocab_leaves else None
        self.local = self.keep | frozenset(self.vocab_leaves)
        self._by_kind = {
            "ragged_attn": sum(b in blocks for b in ATTN_BLOCKS)
            if ragged(cfg, m) else 0,
            "mamba_leaves": len(recurrent.get(MAMBA_BLOCK, ())),
            "rwkv_leaves": len(recurrent.get(RWKV_TIME, ()))
            + len(recurrent.get(RWKV_CHANNEL, ()))}

    def group(self, entry):
        return self.model if entry == MODEL else self.data

    def tp(self, block: tuple):
        """The model group if ``block`` runs tensor-parallel, else None."""
        return self.model if block in self.tp_blocks else None

    def axes_of(self, path: tuple) -> set:
        """"model" and / or "data": what cuts the leaf at ``path``."""
        return {MODEL if e == MODEL else "data"
                for e in self.flat[path] if e is not None}

    def dim_groups(self, path: tuple) -> tuple:
        """The group that cuts each dim of the leaf at ``path`` (None:
        whole)."""
        return tuple(None if e is None else self.group(e)
                     for e in self.flat[path])

    def counts(self) -> dict:
        """Leaves used tensor- or expert-parallel over "model" (of them,
        the Mamba leaves by channel and the RWKV leaves by head or
        ``ff``), the attention blocks among them whose column blocks
        cut a head (``ragged_attn``), the vocabulary's leaves used by
        vocab block, and the other leaves gathered where they are used
        (over "model", the data axes, or both)."""
        return {"tp_leaves": len(self.keep),
                "gathered_leaves": len(self.gathered()),
                "vocab_leaves": len(self.vocab_leaves), **self._by_kind}

    def gathered(self) -> list:
        """The paths of the leaves gathered where they are used."""
        return [p for p in self.flat
                if p not in self.local and self.axes_of(p)]

    def take(self, tree: dict, prefix: tuple = (), *,
             stacked: bool = False) -> dict:
        """``tree`` (the subtree at ``prefix``; ``stacked``: one layer's
        slice of a stack, its leading dim gone) with every leaf whole,
        save the model-axis blocks of the tensor-parallel and vocabulary
        leaves."""
        out = {}
        for key, val in tree.items():
            path = prefix + (key,)
            if isinstance(val, dict):
                out[key] = self.take(val, path, stacked=stacked)
                continue
            spec = self.flat[path][1:] if stacked else self.flat[path]
            t = val
            for dim, entry in enumerate(spec):
                if entry is not None and entry != MODEL:
                    t = gather_leaf(t, dim, self.data, "data")
            if path not in self.local:
                for dim, entry in enumerate(spec):
                    if entry == MODEL:
                        t = gather_leaf(t, dim, self.model, MODEL)
            out[key] = t
        return out

    def take_top(self, params: dict) -> dict:
        """``params`` with its unstacked leaves (embedding, head, norms,
        prefixes) gathered whole, save the vocabulary blocks over
        "model", and its stacks left as they are."""
        top = self.take({k: v for k, v in params.items()
                         if k not in STACKS})
        return {**top, **{k: params[k] for k in STACKS if k in params}}

    def whole(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """A leaf of spec ``spec`` whole on every rank (no autograd; the
        checkpoint's gather), on the device the groups' backend takes."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = all_gather(t.to(comm_device(self.group(entry))), dim,
                               self.group(entry))
        return t
