"""Token-choice top-k Mixture-of-Experts with sort-based dispatch.

The PyTorch counterpart of ``repro.models.moe``, in plain tensor
operations.  Two execution paths share the same math:

  * local (``moe_ffn_local``) — every expert on this device; the path the
    single-card entry points take;
  * expert-parallel (``moe_ffn_ep``) — the experts split over the ranks
    of a ``torch.distributed`` group.  Every rank holds every token (the
    reference's activation layout, replicated over the model axis), routes
    them all, fills only its own experts' buffers, runs its experts, and
    the combine is one ``all_reduce(SUM)`` of the (T, d) output.  It
    trains: the tokens and the combine weights enter the experts through
    ``parallel.copy_to`` and the combine is ``parallel.reduce_from``.

Dispatch is a stable sort by expert and a scatter into fixed-capacity
per-expert buffers, never a one-hot einsum.  Capacity C = ceil(T·k·cf /
E) rounded up to a multiple of 8 (at least 8); an assignment past its
expert's C is dropped (the token keeps its other experts'
contributions), ranked in (token, k) order so the same assignments drop
as in the reference, and counted in ``MoEAux.dropped_frac``.

Capacity is computed per call from the call's T tokens, so a
teacher-forced forward over B·S tokens can drop assignments that a
B-token decode step keeps: the two agree only with enough headroom.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common, parallel


class MoEAux(NamedTuple):
    load_balance: torch.Tensor     # Switch-style aux loss (scalar)
    router_z: torch.Tensor         # router z-loss (scalar)
    dropped_frac: torch.Tensor     # fraction of assignments dropped (scalar)


def capacity(n_tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    """Slots an expert, the reference's Python arithmetic."""
    c = int(-(-n_tokens * top_k * cf // n_experts))   # ceil
    return max(8, -(-c // 8) * 8)                     # round up to 8


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor, MoEAux]:
    """x (T, d) -> (weights (T, K), expert ids (T, K), aux losses).

    The top k are taken by a stable descending sort, so equal
    probabilities go to the lower expert id, as ``jax.lax.top_k`` breaks
    ties."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    e = probs.shape[-1]
    # Switch load-balance loss: E * sum_e f_e * p_e over the top-1 choice
    sel = F.one_hot(ids[:, 0], e).to(torch.float32)
    lb = e * torch.sum(torch.mean(sel, dim=0) * torch.mean(probs, dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return w, ids, MoEAux(lb, z, torch.zeros((), dtype=torch.float32,
                                             device=x.device))


def _dispatch_indices(ids: torch.Tensor, n_experts: int, cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based slot assignment.

    ids (T, K) -> (token of each assignment (A,), slot (A,), kept (A,)),
    A = T·K: ``slot`` indexes an (E·cap) buffer, E·cap when dropped.
    Assignments are ranked within their expert in (token, k) order."""
    t, k = ids.shape
    a = t * k
    dev = ids.device
    eids = ids.reshape(a)
    tok = torch.arange(a, device=dev) // k
    order = torch.argsort(eids, stable=True)                   # by expert
    # a fixed-shape count (bincount's length depends on the data, and the
    # meta device has no bincount)
    counts = torch.zeros(n_experts, dtype=eids.dtype, device=dev
                         ).scatter_add_(0, eids, torch.ones_like(eids))
    starts = torch.cumsum(counts, dim=0) - counts
    pos_sorted = torch.arange(a, device=dev) - starts[eids[order]]
    pos = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    kept = pos < cap
    slot = torch.where(kept, eids * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return tok, slot, kept


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, act: Callable) -> torch.Tensor:
    """buf (E, C, d); wg/wu (E, d, f); wd (E, f, d) -> (E, C, d)."""
    return (act(torch.bmm(buf, wg)) * torch.bmm(buf, wu)) @ wd


def _combine(out_e: torch.Tensor, slot, tok, kept, w, t: int):
    """(n·cap, d) expert outputs -> (T, d): each kept assignment's row,
    weighted, added to its token.  ``slot`` == n·cap reads a zero row."""
    d = out_e.shape[-1]
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))])
    contrib = out_e[slot] * w.reshape(-1)[:, None].to(out_e.dtype)
    contrib = torch.where(kept[:, None], contrib, 0.0)
    return out_e.new_zeros((t, d)).index_add(0, tok, contrib)


def moe_ffn_local(x: torch.Tensor, params: dict, *, top_k: int,
                  capacity_factor: float, act: Callable
                  ) -> tuple[torch.Tensor, MoEAux]:
    """All experts local.  x (T, d) -> ((T, d), aux)."""
    t, d = x.shape
    e = params["wg"].shape[0]
    cap = capacity(t, e, top_k, capacity_factor)
    w, ids, aux = route(x, params["router"], top_k)
    tok, slot, kept = _dispatch_indices(ids, e, cap)
    buf = x.new_zeros((e * cap + 1, d)).index_put((slot,), x[tok])
    out_e = _expert_ffn(buf[:-1].reshape(e, cap, d), params["wg"],
                        params["wu"], params["wd"], act)
    y = _combine(out_e.reshape(e * cap, d), slot, tok, kept, w, t)
    dropped = 1.0 - torch.mean(kept.to(torch.float32))
    return y, aux._replace(dropped_frac=dropped)


def moe_ffn_ep(x: torch.Tensor, params: dict, *, top_k: int,
               capacity_factor: float, act: Callable, group=None,
               data_group=None) -> tuple[torch.Tensor, MoEAux]:
    """Expert-parallel MoE over the ranks of ``group`` (SPMD: every rank
    calls it).  x (B, S, d) is this data shard's tokens, the same on every
    rank of ``group``; ``params["router"]`` is whole, ``wg``/``wu``/``wd``
    hold this rank's E / world experts (rank r the r-th contiguous run).

    Each rank routes every token (redundant arithmetic, no exchange),
    fills only its own experts' buffers, runs its experts, adds their
    weighted rows to its tokens, and one all-reduce SUM over ``group``
    combines the ranks.  The aux terms are averaged over ``data_group``
    when one is given.

    The gradient: routing reads the replicated tokens outside the
    parallel region, so the aux terms' share of the router's gradient is
    whole on every rank; the tokens and the combine weights enter the
    experts through ``copy_to``, whose backward sums the ranks' parts
    (each rank's experts see only their own assignments), and the
    combine is ``reduce_from``."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    el = params["wg"].shape[0]
    e = el * world
    if params["router"].shape[-1] != e:
        raise ValueError(f"router has {params['router'].shape[-1]} experts, "
                         f"{world} ranks x {el} local experts make {e}")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = capacity(t, e, top_k, capacity_factor)
    w, ids, aux = route(xt, params["router"], top_k)
    tok, slot, kept = _dispatch_indices(ids, e, cap)
    lo, n_mine = rank * el * cap, el * cap
    mine = kept & (slot >= lo) & (slot < lo + n_mine)
    lslot = torch.where(mine, slot - lo, torch.full_like(slot, n_mine))
    xc, wc = parallel.copy_to(xt, group), parallel.copy_to(w, group)
    buf = xc.new_zeros((n_mine + 1, d)).index_put((lslot,), xc[tok])
    out_e = _expert_ffn(buf[:-1].reshape(el, cap, d), params["wg"],
                        params["wu"], params["wd"], act)
    y = _combine(out_e.reshape(n_mine, d), lslot, tok, mine, wc, t)
    y = parallel.reduce_from(y, group)                          # combine
    terms = torch.stack([aux.load_balance, aux.router_z,
                         1.0 - torch.mean(kept.to(torch.float32))])
    if data_group is not None:
        terms = parallel.reduce_from(terms, data_group) \
            / dist.get_world_size(data_group)
    return y.reshape(b, s, d), MoEAux(terms[0], terms[1], terms[2])


def moe_ffn(x: torch.Tensor, params: dict, *, top_k: int,
            capacity_factor: float, act: Callable, group=None,
            data_group=None) -> tuple[torch.Tensor, MoEAux]:
    """Dispatcher: (B, S, d) -> ((B, S, d), aux).  Expert-parallel over
    ``group`` when it has more than one rank and they divide the router's
    experts (``params`` then holds this rank's), else all experts
    local."""
    if group is not None:
        import torch.distributed as dist
        m = dist.get_world_size(group)
        if m > 1 and params["router"].shape[-1] % m == 0:
            return moe_ffn_ep(x, params, top_k=top_k,
                              capacity_factor=capacity_factor, act=act,
                              group=group, data_group=data_group)
    b, s, d = x.shape
    y, aux = moe_ffn_local(x.reshape(b * s, d), params, top_k=top_k,
                           capacity_factor=capacity_factor, act=act)
    return y.reshape(b, s, d), aux


def param_specs(cfg) -> dict:
    """ParamSpec tree of one MoE FFN layer stack (leading 'layers' dim)."""
    L, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    S = common.ParamSpec
    return {
        "router": S((L, d, e), ("layers", "embed", "experts_r"), scale=0.1),
        "wg": S((L, e, d, f), ("layers", "experts", "ff_in", "ff")),
        "wu": S((L, e, d, f), ("layers", "experts", "ff_in", "ff")),
        "wd": S((L, e, f, d), ("layers", "experts", "ff", "embed_out")),
    }
