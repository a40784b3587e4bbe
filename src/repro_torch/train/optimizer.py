"""Optimizers of the port: AdamW and factored Adafactor.

The PyTorch counterpart of ``repro.train.optimizer``, with its field
names and its arithmetic in the same order.  AdamW keeps two fp32
moments a parameter.  Adafactor factors the second moment of any rank
>= 2 leaf into row and column accumulators and keeps no first moment;
the nemotron-4-340b config uses it.

States are NamedTuples of a 0-d int32 ``step`` and nested dicts that
mirror the parameter tree (slots that do not apply hold size-0 tensors,
so the trees always match), so the checkpointer writes them like any
other tree.  ``opt_update_`` writes an update into the parameters and
the state in place, leaf by leaf, which is what the train step uses: a
leaf's temporaries are its only extra memory.  ``opt_update`` returns
new tensors, as the reference does.

On a mesh a rank holds its shard of each leaf and of its state
(``opt_state_specs``, the reference's rule).  AdamW is elementwise.
Adafactor's row and column means and its update-clipping RMS reduce
over a leaf's dims, so ``opt_update_`` takes, a leaf, the group that
cuts each dim, and each of those reductions is summed over the group
that cuts the dim it runs along: every rank computes the statistics one
process computes over the whole leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import common, parallel


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any       # row accumulator (shape[:-1]) for rank >= 2 leaves
    vc: Any       # column accumulator (shape[:-2] + shape[-1:])
    v: Any        # full accumulator for rank < 2 leaves (size 0 otherwise)


def _device(params) -> torch.device:
    return next(common.leaves(params))[1].device


def _zeros(shape, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# -- AdamW -------------------------------------------------------------------


def adamw_init(params) -> AdamWState:
    zeros = lambda p: _zeros(p.shape, p.device)
    return AdamWState(step=_step0(params), m=common.tree_map(zeros, params),
                      v=common.tree_map(zeros, params))


def _adamw_prep(state: AdamWState, *, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, wd: float = 0.01):
    step = state.step + 1
    t = step.to(torch.float32)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t

    def leaf(p, g, m, v, lr):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.ndim >= 2:                 # decoupled wd on matrices only
            u = u + wd * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

    return step, leaf, ("m", "v")


# -- Adafactor ---------------------------------------------------------------


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        return _zeros(p.shape[:-1] if _factored(p) else (0,), p.device)

    def vc(p):
        return _zeros(p.shape[:-2] + p.shape[-1:] if _factored(p) else (0,),
                      p.device)

    def v(p):
        return _zeros((0,) if _factored(p) else p.shape, p.device)

    return AdafactorState(step=_step0(params),
                          vr=common.tree_map(vr, params),
                          vc=common.tree_map(vc, params),
                          v=common.tree_map(v, params))


def _mean(t: torch.Tensor, dim: int, group, keepdim: bool = False
          ) -> torch.Tensor:
    """The mean along ``dim`` of a tensor whose ``dim`` is cut over
    ``group`` (None: whole here)."""
    if group is None:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    s = parallel.all_reduce(torch.sum(t, dim=dim, keepdim=keepdim), group)
    return s / (t.shape[dim] * parallel.size(group))


def _mean_all(t: torch.Tensor, groups: tuple) -> torch.Tensor:
    """The mean of every element of a leaf cut over ``groups``."""
    cut = [g for g in dict.fromkeys(groups) if g is not None]
    if not cut:
        return torch.mean(t)
    s = torch.sum(t)
    for g in cut:
        s = parallel.all_reduce(s, g)
    return s / (t.numel() * math.prod(parallel.size(g) for g in groups
                                      if g is not None))


def _adafactor_prep(state: AdafactorState, *, decay: float = 0.8,
                    eps: float = 1e-30, clip: float = 1.0):
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - torch.pow(t, -decay)

    def leaf(p, g, vr, vc, v, lr, groups=None):
        groups = groups or (None,) * p.ndim
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(p):
            vr = beta * vr + (1 - beta) * _mean(g2, -1, groups[-1])
            vc = beta * vc + (1 - beta) * _mean(g2, -2, groups[-2])
            rf = vr / torch.clamp(_mean(vr, -1, groups[-2], keepdim=True),
                                  min=eps)
            u = g * torch.rsqrt(torch.clamp(rf[..., None], min=eps)) \
                * torch.rsqrt(torch.clamp(vc, min=eps))[..., None, :]
        else:
            v = beta * v + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
        rms = torch.sqrt(_mean_all(u * u, groups) + 1e-30)  # update clipping
        u = u / torch.clamp(rms / clip, min=1.0)
        return (p.to(torch.float32) - lr * u).to(p.dtype), vr, vc, v

    return step, leaf, ("vr", "vc", "v")


# -- the front door ----------------------------------------------------------

_PREP: dict[str, Callable] = {"adamw": _adamw_prep,
                              "adafactor": _adafactor_prep}


def opt_init(kind: str, params):
    if kind == "adamw":
        return adamw_init(params)
    if kind == "adafactor":
        return adafactor_init(params)
    raise ValueError(kind)


def opt_update_(kind: str, grads, state, params, *, lr, ok=None,
                dim_groups=None, **kw):
    """One update written into ``params`` and ``state`` in place, leaf by
    leaf.  ``ok`` (a 0-d bool tensor): where it is False every leaf keeps
    its value (``torch.where``, no host sync); the step counter advances
    either way.  ``dim_groups`` (path -> the group that cuts each dim of
    the leaf, None where whole): the leaves are shards, and Adafactor's
    reductions run over those groups.  -> (params, state), the same
    objects."""
    if kind not in _PREP:
        raise ValueError(kind)
    step, leaf, fields = _PREP[kind](state, **kw)
    g_of = dict(common.leaves(grads))
    slots = [dict(common.leaves(getattr(state, f))) for f in fields]
    cut = {} if dim_groups is None or kind == "adamw" else dim_groups
    for path, p in common.leaves(params):
        old = [p, *(s[path] for s in slots)]
        extra = (cut[path],) if path in cut else ()
        new = leaf(p, g_of[path], *old[1:], lr, *extra)
        for dst, src in zip(old, new):
            dst.copy_(src if ok is None else torch.where(ok, src, dst))
    state.step.copy_(step)
    return params, state


def opt_state_specs(kind: str, param_specs: dict, param_shapes: dict):
    """The spec tree of the optimizer state, mirroring the parameters'
    (the reference's rule): AdamW's moments take their leaf's spec;
    Adafactor's ``vr`` drops the last entry and ``vc`` the second to
    last, a factored leaf's size-0 ``v`` and an unfactored leaf's ``vr``
    and ``vc`` are replicated (), an unfactored leaf's ``v`` takes its
    spec.  ``step`` is replicated."""
    if kind == "adamw":
        return AdamWState(step=(), m=param_specs, v=param_specs)
    if kind != "adafactor":
        raise ValueError(kind)
    ndim = {p: len(getattr(t, "shape", t))
            for p, t in common.leaves(param_shapes)}

    def drop(which):
        def f(path, spec):
            if ndim[path] < 2:
                return ()
            ent = list(spec) + [None] * (ndim[path] - len(spec))
            del ent[-1 if which == "vr" else -2]
            return tuple(ent)
        return f

    def v(path, spec):
        return () if ndim[path] >= 2 else spec

    def over(f):
        return common.with_leaves(param_specs, {
            p: f(p, s) for p, s in common.leaves(param_specs)})
    return AdafactorState(step=(), vr=over(drop("vr")), vc=over(drop("vc")),
                          v=over(v))


def opt_update(kind: str, grads, state, params, *, lr, **kw):
    """One update -> (new params, new state), as the reference returns
    them; the inputs are left as they are."""
    clone = lambda tree: common.tree_map(torch.clone, tree)
    state = type(state)(state.step.clone(), *map(clone, state[1:]))
    return opt_update_(kind, grads, state, clone(params), lr=lr, **kw)
