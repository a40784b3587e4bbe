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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import common


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


def _adafactor_prep(state: AdafactorState, *, decay: float = 0.8,
                    eps: float = 1e-30, clip: float = 1.0):
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - torch.pow(t, -decay)

    def leaf(p, g, vr, vc, v, lr):
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(p):
            vr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
            rf = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                  min=eps)
            u = g * torch.rsqrt(torch.clamp(rf[..., None], min=eps)) \
                * torch.rsqrt(torch.clamp(vc, min=eps))[..., None, :]
        else:
            v = beta * v + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)     # update clipping
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


def opt_update_(kind: str, grads, state, params, *, lr, ok=None, **kw):
    """One update written into ``params`` and ``state`` in place, leaf by
    leaf.  ``ok`` (a 0-d bool tensor): where it is False every leaf keeps
    its value (``torch.where``, no host sync); the step counter advances
    either way.  -> (params, state), the same objects."""
    if kind not in _PREP:
        raise ValueError(kind)
    step, leaf, fields = _PREP[kind](state, **kw)
    g_of = dict(common.leaves(grads))
    slots = [dict(common.leaves(getattr(state, f))) for f in fields]
    for path, p in common.leaves(params):
        old = [p, *(s[path] for s in slots)]
        new = leaf(p, g_of[path], *old[1:], lr)
        for dst, src in zip(old, new):
            dst.copy_(src if ok is None else torch.where(ok, src, dst))
    state.step.copy_(step)
    return params, state


def opt_update(kind: str, grads, state, params, *, lr, **kw):
    """One update -> (new params, new state), as the reference returns
    them; the inputs are left as they are."""
    clone = lambda tree: common.tree_map(torch.clone, tree)
    state = type(state)(state.step.clone(), *map(clone, state[1:]))
    return opt_update_(kind, grads, state, clone(params), lr=lr, **kw)
