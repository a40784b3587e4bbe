"""The LM stack of every family: ``forward`` / ``prefill`` /
``decode_step`` and the training loss ``loss_fn`` over stacked per-layer
parameters.

The PyTorch counterpart of ``repro.models.transformer``.  A dense layer
is pre-norm attention then a dense FFN (gated or not), or with
``parallel_block`` both on the same normed input added to one residual;
a MoE layer (granite-moe, moonshot) puts ``models.moe``'s routed experts
in place of the FFN, and its load-balance and z-loss terms are summed
over the layers into the loss; a hybrid layer (Hymba) runs attention and
a Mamba mixer side by side and averages their normed outputs; a vlm
model is a dense one with a patch-embedding prefix; an ssm model
(RWKV6) is a stack of ``models.rwkv`` blocks, no attention; an enc_dec
model (Whisper) runs a non-causal encoder over frame embeddings and a
decoder with self- and cross-attention, no RoPE.  Heterogeneous layer
patterns (gemma3's 5:1 local:global, Hymba's explicit global layers) are
cut into *segments*, runs of one attention kind; parameters stay stacked
over all layers with the reference's names, and each stack is a host
loop over its layers where the reference scans them.

Caches are the reference's list of per-segment dicts: full-attention
segments carry (run, B, S, KVH, hd) K/V, SWA segments ring buffers of
width ``window``, hybrid segments also the Mamba states ``m_h``
(run, B, D, N) and ``m_conv`` (run, B, K-1, D); an ssm model has one
segment of RWKV states ``s`` (L, B, H, n, n) f32, ``x_tm`` and ``x_cm``
(L, B, d); Whisper one of the decoder's self K/V over ``decoder_len``
positions and its cross K/V ``xk`` / ``xv`` over the frames.
``prefill`` and ``decode_step`` write the cache in place and return it.

Entry points take ``device=`` (the card by default) and raise if the
parameters do not lie there.  Every family trains: a hybrid model's
Mamba recurrence goes through ``ops.ssm_scan``'s autograd ``Function``
(the ``ssm_scan`` kernel forward, the ``ssm_scan_bwd`` kernel backward).

``decode_step`` takes ``kv_shard``, a ``torch.distributed`` group over
whose ranks the full-attention layers' caches split their positions
(``launch.specs.cache_blocks`` cuts a rank's share of a whole cache),
the counterpart of the reference's ``Ctx.kv_shard``: those layers decode
through ``attention.decode_attend_seqsharded``.  ``prefill`` and
``decode_step`` take ``plan`` (``parallel.Plan``, as ``loss_fn``): the
parameters are this rank's shards of a (data, model) mesh and the cache
its blocks by the reference's ``cache_pspecs``; the tensor- and
expert-parallel blocks, Mamba by channel and RWKV by head run over the
model group, every other leaf is gathered in its layer, and
``kv_shard`` is the model group (positions over "model"), the data group
(long_500k's layout) or None.  Where the plan's specs cut the vocabulary
over "model" (``Plan.vocab``), a rank computes on its blocks of
``embed`` and ``lm_head``: the lookup (``vocab_embed``), the head
(``vocab_logits``: ``prefill`` and ``decode_step`` return the rank's
block of the logits) and ``loss_fn``'s cross-entropy
(``_ce_chunk_vocab``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mamba, moe, parallel, rwkv
from repro_torch.models.common import ParamSpec as PS

@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # "full" | "swa" (attention flavour of the run)
    start: int
    end: int           # exclusive

    @property
    def size(self) -> int:
        return self.end - self.start


def segments(cfg: ModelConfig, n_layers: int | None = None
             ) -> list[Segment]:
    n = cfg.n_layers if n_layers is None else n_layers
    kinds = [cfg.layer_kind(i) for i in range(n)]
    segs, a = [], 0
    for i in range(1, n + 1):
        if i == n or kinds[i] != kinds[a]:
            segs.append(Segment(kinds[a], a, i))
            a = i
    return segs


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, L: int) -> dict:
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s = {
        "wq": PS((L, d, q), ("layers", "embed", "q_heads")),
        "wk": PS((L, d, kv), ("layers", "embed", "kv_fused")),
        "wv": PS((L, d, kv), ("layers", "embed", "kv_fused")),
        "wo": PS((L, q, d), ("layers", "q_heads", "embed_out")),
    }
    if cfg.qk_norm:
        s["q_gamma"] = PS((L, hd), ("layers", None), init="zeros")
        s["k_gamma"] = PS((L, hd), ("layers", None), init="zeros")
    return s


def _ffn_specs(cfg: ModelConfig, L: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "wu": PS((L, d, f), ("layers", "ff_in", "ff")),
        "wd": PS((L, f, d), ("layers", "ff", "embed_out")),
    }
    if cfg.mlp_gated:
        s["wg"] = PS((L, d, f), ("layers", "ff_in", "ff"))
    return s


def param_specs(cfg: ModelConfig) -> dict:
    d, v, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    specs: dict = {
        "embed": PS((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": PS((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PS((d, v), ("embed", "vocab"))
    if cfg.family == "ssm":
        specs["layers"] = rwkv.param_specs(cfg)
        return specs
    layers = {
        "ln1": PS((L, d), ("layers", "embed"), init="zeros"),
        "ln2": PS((L, d), ("layers", "embed"), init="zeros"),
        "attn": _attn_specs(cfg, L),
    }
    if cfg.family == "hybrid":
        layers["mamba"] = mamba.param_specs(cfg, d_inner=cfg.q_dim)
        layers["attn_gamma"] = PS((L, cfg.q_dim), ("layers", "q_heads"),
                                  init="zeros")
        layers["mamba_gamma"] = PS((L, cfg.q_dim), ("layers", "q_heads"),
                                   init="zeros")
    if cfg.n_experts:
        layers["moe"] = moe.param_specs(cfg)
    else:
        layers["ffn"] = _ffn_specs(cfg, L)
    specs["layers"] = layers
    if cfg.meta_tokens:
        specs["meta"] = PS((cfg.meta_tokens, d), (None, "embed"), scale=1.0)
    if cfg.enc_dec:
        Ld = cfg.n_dec_layers
        specs["enc_final_norm"] = PS((d,), ("embed",), init="zeros")
        specs["dec_pos"] = PS((cfg.decoder_len, d), (None, "embed"),
                              scale=1.0)
        specs["dec"] = {
            "ln1": PS((Ld, d), ("layers", "embed"), init="zeros"),
            "ln_x": PS((Ld, d), ("layers", "embed"), init="zeros"),
            "ln2": PS((Ld, d), ("layers", "embed"), init="zeros"),
            "attn": _attn_specs(cfg, Ld),
            "xattn": _attn_specs(cfg, Ld),
            "ffn": _ffn_specs(cfg, Ld),
        }
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _q_heads(cfg: ModelConfig, tp, every_head: bool = False):
    """(h0, h1, group): the q heads [h0, h1) this rank attends over the
    model group ``tp``, and the group its q projection is gathered over
    (None: its own columns are those heads).  By whole heads, the rank's
    heads.  Ragged (``parallel.ragged``): the heads that overlap its q
    columns [r·q/M, (r+1)·q/M) (a head cut between two ranks is attended
    on both), gathered unless they are its own whole heads; with
    ``every_head``, every head."""
    m, r = parallel.size(tp), parallel.rank(tp)
    if not parallel.ragged(cfg, m):
        n = cfg.n_heads // m
        return r * n, (r + 1) * n, None
    if every_head:
        return 0, cfg.n_heads, tp
    qc, hd = cfg.q_dim // m, cfg.head_dim
    return r * qc // hd, -(-(r + 1) * qc // hd), \
        tp if cfg.n_heads % m else None


def _proj(x, p, names: tuple, hd: int, group) -> list:
    """``x``'s projections onto the leaves ``names``, each (B, S, heads,
    hd): onto this rank's column blocks, or with ``group`` onto every
    rank's, the blocks gathered in one message ([a₀|b₀|a₁|b₁|…]) and put
    back in column order."""
    parts = [x @ p[n] for n in names]
    m = parallel.size(group)
    if m > 1:
        widths = [t.shape[-1] for t in parts]
        every = parallel.gather_acts(torch.cat(parts, dim=-1), group)
        parts = [t.flatten(-2) for t in every.unflatten(
            -1, (m, sum(widths))).split(widths, dim=-1)]
    b, s = x.shape[:2]
    return [t.reshape(b, s, -1, hd) for t in parts]


def _qkv(x, p, cfg: ModelConfig, positions, tp=None, *,
         every_head: bool = False, kv_x=None):
    """Projected q, k, v (B, S, heads, hd), the q/k norms and RoPE at
    ``positions`` (none if it is None: an enc_dec model has no RoPE)
    applied on whole heads, and h0, q's first head.  ``kv_x``: what k
    and v project from (cross-attention), else ``x``.  ``tp``: a model
    group over which ``wq``/``wk``/``wv`` hold this rank's column
    blocks: by whole heads, q, k and v hold the rank's heads; ragged, k
    and v are gathered whole and q holds ``_q_heads``' heads."""
    h0, h1, gq = _q_heads(cfg, tp, every_head)
    gkv = tp if parallel.ragged(cfg, parallel.size(tp)) else None
    hd = cfg.head_dim
    if kv_x is None and gq is gkv:
        q, k, v = _proj(x, p, ("wq", "wk", "wv"), hd, gq)
    else:
        (q,) = _proj(x, p, ("wq",), hd, gq)
        k, v = _proj(x if kv_x is None else kv_x, p, ("wk", "wv"), hd, gkv)
    if gq is not None:
        q = q[:, :, h0:h1]
    if cfg.qk_norm:
        q = common.rmsnorm(q, p["q_gamma"])
        k = common.rmsnorm(k, p["k_gamma"])
    if positions is not None:
        q = common.rope(q, positions, cfg.rope_theta)
        k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v, h0


def _kv_of(k, v, h0: int, nh: int, cfg: ModelConfig):
    """The K/V heads that q heads [h0, h0 + nh) read, in
    ``attention.attend``'s grouped layout: ``k`` / ``v`` as they are
    where they hold exactly those groups; the one KV head the q heads
    share, or their run of whole groups; else each q head's own KV head
    (a copy, one group a head)."""
    g = cfg.n_heads // cfg.n_kv_heads
    a, z = h0 // g, -(-(h0 + nh) // g)
    if k.shape[2] == z - a:
        return k, v
    if z - a == 1 or (h0 % g == 0 and nh % g == 0):
        return k[:, :, a:z], v[:, :, a:z]
    idx = torch.arange(h0, h0 + nh, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_out(out, p, cfg: ModelConfig, tp, h0: int):
    """The attention's output (B, S, heads, hd) of the q heads from
    ``h0`` on, through this rank's rows of ``wo`` (its q/M columns of the
    output: all of them by whole heads), summed over ``tp``."""
    b, s = out.shape[:2]
    out = out.reshape(b, s, -1)
    qc = cfg.q_dim // parallel.size(tp)
    if out.shape[-1] != qc:
        out = out.narrow(-1, parallel.rank(tp) * qc - h0 * cfg.head_dim, qc)
    return parallel.reduce_from(out @ p["wo"], tp)


def _tp_enter(x, p, tp):
    """A tensor-parallel attention's inputs: ``x`` and the replicated
    q/k norms through ``copy_to`` (each rank's heads give a part of
    their gradients).  -> (x, p)."""
    if parallel.size(tp) == 1:
        return x, p
    norms = {g: parallel.copy_to(p[g], tp) for g in ("q_gamma", "k_gamma")
             if g in p}
    return parallel.copy_to(x, tp), {**p, **norms}


def attn_train(x, p, cfg: ModelConfig, kind: str, *, causal: bool = True,
               tp=None):
    """Full-sequence attention (forward, loss and prefill compute);
    ``causal=False`` for Whisper's encoder.  ``tp``: a model group over
    which ``wq``/``wk``/``wv`` hold this rank's column blocks and ``wo``
    the same rows of q; the rank attends ``_q_heads``' heads and the
    ranks' outputs are summed by one ``reduce_from``.

    Returns (out, (k, v)) so prefill can write the cache: the rank's KV
    heads by whole heads, every KV head ragged."""
    s = x.shape[1]
    x, p = _tp_enter(x, p, tp)
    positions = None if cfg.enc_dec \
        else torch.arange(s, device=x.device)[None, :]
    q, k, v, h0 = _qkv(x, p, cfg, positions, tp)
    window = cfg.window if kind == "swa" else 0
    out = attention.attend(q, *_kv_of(k, v, h0, q.shape[2], cfg),
                           causal=causal, window=window,
                           chunk=attention.div_chunk(s, cfg.scan_chunk))
    return _attn_out(out, p, cfg, tp, h0), (k, v)


def _check_heads(cache_k, k) -> None:
    """A cache must hold the KV heads the attention gives: a rank's
    under whole-head tensor parallelism, else all of them (a ragged
    block gathers them whole, as ``cache_pspecs`` leaves them)."""
    if cache_k.shape[-2] != k.shape[-2]:
        raise ValueError(f"the cache holds {cache_k.shape[-2]} KV heads, "
                         f"the attention gives {k.shape[-2]}")


def attn_decode(x, p, cfg: ModelConfig, kind: str, cache, pos,
                kv_shard=None, tp=None):
    """One-token attention against the cache, written in place.
    ``pos`` (B,) int64; ``kv_shard`` a group over which a full-attention
    cache splits its positions (this rank's slice in ``cache``); ``tp``
    a model group over which the attention runs by head (the cache holds
    this rank's KV heads) or ragged: then every rank attends every head
    (the sharded merge over "model" needs the same heads on each) and
    keeps its columns of the output.  Returns (out, cache)."""
    x, p = _tp_enter(x, p, tp)
    q, k, v, h0 = _qkv(x, p, cfg, pos[:, None], tp, every_head=True)
    _check_heads(cache["k"], k)
    window = cfg.window if kind == "swa" else 0
    if kv_shard is not None and not window:
        out, kc, vc = attention.decode_attend_seqsharded(
            q, k, v, cache["k"], cache["v"], pos, group=kv_shard)
    else:
        kc, vc = attention.cache_update(cache["k"], cache["v"], k, v, pos,
                                        window=window)
        out = attention.decode_attend(q, kc, vc, pos, window=window)
    return _attn_out(out, p, cfg, tp, h0), {"k": kc, "v": vc}


def _zero_aux(device) -> moe.MoEAux:
    return moe.MoEAux(*(torch.zeros((), dtype=torch.float32, device=device)
                        for _ in range(3)))


def _add_aux(a: moe.MoEAux, b: moe.MoEAux) -> moe.MoEAux:
    return moe.MoEAux(*(x + y for x, y in zip(a, b)))


def ffn_block(x, p, cfg: ModelConfig, tp=None):
    """The dense FFN, or the routed experts of a MoE model.
    -> (out, MoEAux); a dense FFN's aux is zeros.  ``tp``: a model group
    over which ``wg``/``wu`` hold this rank's ``ff`` columns and ``wd``
    its rows (one ``reduce_from``), or a MoE's experts split
    (``moe.moe_ffn_ep``)."""
    act = common.activation(cfg.mlp_act)
    if cfg.n_experts:
        return moe.moe_ffn(x, p, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, act=act,
                           group=tp)
    x = parallel.copy_to(x, tp)
    if cfg.mlp_gated:
        h = act(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = act(x @ p["wu"])
    return parallel.reduce_from(h @ p["wd"], tp), _zero_aux(x.device)


def _mix(attn_out, m_out, p):
    return 0.5 * (common.rmsnorm(attn_out, p["attn_gamma"])
                  + common.rmsnorm(m_out, p["mamba_gamma"]))


def _ffn_residual(x, h, attn_out, p, cfg: ModelConfig, tp=None):
    """The FFN and the residual adds -> (x, MoEAux).  A parallel block's
    FFN reads the same normed ``h`` as attention and ``ln2`` is not
    applied, as in the reference.  ``tp``: the FFN's model group if it
    runs tensor- or expert-parallel."""
    pf = p["moe"] if cfg.n_experts else p["ffn"]
    if cfg.parallel_block:
        f_out, aux = ffn_block(h, pf, cfg, tp)
        return x + attn_out + f_out, aux
    x = x + attn_out
    f_out, aux = ffn_block(common.rmsnorm(x, p["ln2"]), pf, cfg, tp)
    return x + f_out, aux


# ---------------------------------------------------------------------------
# Decoder layers (train / prefill / decode)
# ---------------------------------------------------------------------------


def _tp(plan, block: tuple):
    return None if plan is None else plan.tp(block)


def layer_train(x, p, cfg: ModelConfig, kind: str, plan=None):
    """One decoder layer, full sequence. Returns (x, MoEAux, (k, v)).
    ``plan`` (``parallel.Plan``): ``p`` is this rank's slice of the
    layer, gathered but for the tensor-parallel blocks' leaves."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, kv = attn_train(h, p["attn"], cfg, kind,
                              tp=_tp(plan, ("layers", "attn")))
    if cfg.family == "hybrid":
        m_out, _ = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim,
                                   tp=_tp(plan, parallel.MAMBA_BLOCK))
        attn_out = _mix(attn_out, m_out, p)
    block = ("layers", "moe" if cfg.n_experts else "ffn")
    x, aux = _ffn_residual(x, h, attn_out, p, cfg, _tp(plan, block))
    return x, aux, kv


def _ffn_tp(plan, cfg: ModelConfig):
    return _tp(plan, ("layers", "moe" if cfg.n_experts else "ffn"))


def layer_decode(x, p, cfg: ModelConfig, kind: str, cache, pos,
                 kv_shard=None, plan=None):
    """One decoder layer, one token; writes the layer's cache in place.
    ``plan``: ``p`` is this rank's layer as ``Plan.take`` gives it and
    ``cache`` its blocks.  Returns (x, cache)."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, _ = attn_decode(h, p["attn"], cfg, kind, cache, pos,
                              kv_shard, _tp(plan, ("layers", "attn")))
    if cfg.family == "hybrid":
        mst = mamba.MambaState(h=cache["m_h"], conv=cache["m_conv"])
        m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim,
                                     state=mst,
                                     tp=_tp(plan, parallel.MAMBA_BLOCK))
        cache["m_h"].copy_(mst.h)
        cache["m_conv"].copy_(mst.conv)
        attn_out = _mix(attn_out, m_out, p)
    return _ffn_residual(x, h, attn_out, p, cfg, _ffn_tp(plan, cfg))[0], \
        cache


def layer_prefill(x, p, cfg: ModelConfig, kind: str, cache, plan=None):
    """Full-sequence compute + cache population (in place).  ``plan`` as
    ``layer_decode``'s.  Returns (x, cache)."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, (k, v) = attn_train(h, p["attn"], cfg, kind,
                                  tp=_tp(plan, ("layers", "attn")))
    _check_heads(cache["k"], k)
    s = x.shape[1]
    window = cfg.window if kind == "swa" else 0
    kd, vd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    if window and s >= window:
        r = s % window                 # ring slot of position s - window
        cache["k"].copy_(torch.roll(kd[:, -window:], r, dims=1))
        cache["v"].copy_(torch.roll(vd[:, -window:], r, dims=1))
    else:
        cache["k"][:, :s] = kd
        cache["v"][:, :s] = vd
    if cfg.family == "hybrid":
        m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim,
                                     tp=_tp(plan, parallel.MAMBA_BLOCK))
        cache["m_h"].copy_(mst.h)
        cache["m_conv"].copy_(mst.conv)
        attn_out = _mix(attn_out, m_out, p)
    return _ffn_residual(x, h, attn_out, p, cfg, _ffn_tp(plan, cfg))[0], \
        cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    """Layer i's slice of a stacked (L, ...) tree (views, no copies)."""
    return common.tree_map(lambda a: a[i], tree)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n per-layer slices of a stacked (L, ...) tree, views taken by
    one ``unbind`` a leaf: under autograd the layers' gradients then meet
    in one stack a leaf, not in one full-size add a layer."""
    per_leaf = common.tree_map(torch.unbind, tree)
    return [common.tree_map(lambda t: t[i], per_leaf) for i in range(n)]


def _remat(cfg: ModelConfig, mode: str) -> bool:
    """Whether "train" mode puts each layer under checkpointing."""
    return mode == "train" and torch.is_grad_enabled() \
        and cfg.remat != "none"


def _run(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _take(plan, p_l: dict, stack: str) -> dict:
    """One layer's parameters as the layer uses them: under a ``plan``,
    its sharded leaves gathered (inside the layer's checkpoint, so the
    backward's recompute gathers them again)."""
    return p_l if plan is None else plan.take(p_l, (stack,), stacked=True)


def _train_layer(x, p_l, cfg: ModelConfig, kind: str, plan=None):
    x, aux, _ = layer_train(x, _take(plan, p_l, "layers"), cfg, kind, plan)
    return (x, *aux)


def decoder_stack(params, x, cfg: ModelConfig, mode: str, *,
                  cache=None, pos=None, kv_shard=None, plan=None):
    """Run all decoder layers, a host loop over each segment's layers.
    ``mode`` is "train" (no cache), "prefill" or "decode" (the cache is
    written in place).  Returns (x, MoEAux summed over the layers in
    "train" mode, zeros otherwise, cache).

    In "train" mode under autograd, ``cfg.remat`` "full" and "dots" put
    each layer under ``torch.utils.checkpoint`` (only its input is kept;
    its activations are recomputed in the backward), "none" keeps them
    all.  "dots" saves nothing more than "full" here: the reference's
    policy of also keeping the matmul outputs has no counterpart.  The
    values are the same either way.  ``kv_shard`` ("decode" only): the
    group over which the full-attention caches split their positions.
    ``plan``: a ``parallel.Plan``, the stacks hold this rank's shards
    (and ``cache`` its blocks)."""
    if cfg.family == "ssm":
        return _rwkv_stack(params, x, cfg, mode, cache=cache, plan=plan)
    remat = _remat(cfg, mode)
    aux = _zero_aux(x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    for si, seg in enumerate(segments(cfg)):
        for i in common.identical(range(seg.start, seg.end), seg.kind):
            p_l = layers[i]
            if mode == "train":
                x, *a = _run(_train_layer, remat, x, p_l, cfg, seg.kind,
                             plan)
                aux = _add_aux(aux, moe.MoEAux(*a))
                continue
            c_l = _layer(cache[si], i - seg.start)
            p_l = _take(plan, p_l, "layers")
            if mode == "prefill":
                x, _ = layer_prefill(x, p_l, cfg, seg.kind, c_l, plan)
            else:
                x, _ = layer_decode(x, p_l, cfg, seg.kind, c_l, pos,
                                    kv_shard, plan)
    return x, aux, cache


def _rwkv_layer(x, p_l, cfg: ModelConfig, state=None, plan=None):
    return rwkv.rwkv_layer(x, p_l, head_dim=cfg.rwkv_head_dim,
                           chunk=min(64, cfg.scan_chunk), state=state,
                           tp=_tp(plan, parallel.RWKV_TIME),
                           ffn_tp=_tp(plan, parallel.RWKV_CHANNEL))


def _rwkv_train_layer(x, p_l, cfg: ModelConfig, plan=None):
    return _rwkv_layer(x, _take(plan, p_l, "layers"), cfg, plan=plan)[0]


def _rwkv_stack(params, x, cfg: ModelConfig, mode: str, *, cache=None,
                plan=None):
    """The RWKV6 blocks.  "train" starts every layer from the zero state
    (what the reference's zero cache gives); "prefill" and "decode" read
    each layer's state from ``cache`` and write the new one in place.
    Returns (x, zero MoEAux, cache)."""
    remat = _remat(cfg, mode)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, p_l in common.identical(enumerate(layers)):
        if mode == "train":
            x = _run(_rwkv_train_layer, remat, x, p_l, cfg, plan)
            continue
        c = cache[0]
        x, st = _rwkv_layer(x, _take(plan, p_l, "layers"), cfg,
                            rwkv.RwkvState(s=c["s"][i], x_tm=c["x_tm"][i],
                                           x_cm=c["x_cm"][i]), plan)
        c["s"][i].copy_(st.s)
        c["x_tm"][i].copy_(st.x_tm)
        c["x_cm"][i].copy_(st.x_cm)
    return x, _zero_aux(x.device), cache


# ---------------------------------------------------------------------------
# Whisper encoder-decoder
# ---------------------------------------------------------------------------


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) sinusoidal positions: sines, then cosines.  The frequencies'
    power is taken in float64 and rounded once, as XLA's float32 power
    rounds it (torch's float32 power is an ulp off at some exponents,
    which moved a sine at 1,500 x 1,024 by 3e-5)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    freq = torch.pow(10000.0, (2 * i / d).to(torch.float64)).to(torch.float32)
    ang = pos / freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _encoder_layer(x, p_l, cfg: ModelConfig, plan=None):
    p_l = _take(plan, p_l, "layers")
    h = common.rmsnorm(x, p_l["ln1"])
    out, _ = attn_train(h, p_l["attn"], cfg, "full", causal=False,
                        tp=_tp(plan, ("layers", "attn")))
    x = x + out
    f_out, _ = ffn_block(common.rmsnorm(x, p_l["ln2"]), p_l["ffn"], cfg,
                         _tp(plan, ("layers", "ffn")))
    return x + f_out


def encoder_stack(params, frames: torch.Tensor, cfg: ModelConfig,
                  plan=None):
    """Whisper's encoder over frame embeddings (B, F, d): sinusoidal
    positions, then ``n_layers`` non-causal pre-norm layers (under
    checkpointing as the decoder stack's).  -> (B, F, d), final-normed."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)[None]
    remat = _remat(cfg, "train")
    for p_l in common.identical(_unstack(params["layers"], cfg.n_layers)):
        x = _run(_encoder_layer, remat, x, p_l, cfg, plan)
    return common.rmsnorm(x, params["enc_final_norm"])


def _decoder_layer(x, p_l, enc_out, cfg: ModelConfig, c_l=None, plan=None):
    """One decoder layer over the whole token sequence: causal self-
    attention, cross-attention to ``enc_out``, the FFN.  With ``c_l``
    (prefill) the self K/V and the cross K/V are written into it."""
    p_l = _take(plan, p_l, "dec")
    h = common.rmsnorm(x, p_l["ln1"])
    out, (k, v) = attn_train(h, p_l["attn"], cfg, "full",
                             tp=_tp(plan, ("dec", "attn")))
    x = x + out
    h = common.rmsnorm(x, p_l["ln_x"])
    sq = h.shape[1]
    tp = _tp(plan, ("dec", "xattn"))
    h, px = _tp_enter(h, p_l["xattn"], tp)
    q, xk, xv, h0 = _qkv(h, px, cfg, None, tp,
                         kv_x=parallel.copy_to(enc_out, tp))
    out = attention.attend(q, *_kv_of(xk, xv, h0, q.shape[2], cfg),
                           causal=False,
                           chunk=attention.div_chunk(sq, cfg.scan_chunk))
    x = x + _attn_out(out, px, cfg, tp, h0)
    f_out, _ = ffn_block(common.rmsnorm(x, p_l["ln2"]), p_l["ffn"], cfg,
                         _tp(plan, ("dec", "ffn")))
    if c_l is not None:
        _check_heads(c_l["k"], k)
        c_l["k"][:, :sq] = k.to(c_l["k"].dtype)
        c_l["v"][:, :sq] = v.to(c_l["v"].dtype)
        c_l["xk"].copy_(xk)
        c_l["xv"].copy_(xv)
    return x + f_out


def _decoder_layer_decode(x, p_l, cfg: ModelConfig, c_l, pos: int,
                          plan=None):
    """One decoder layer, one token at ``pos``; its self K/V written into
    the cache.  The cross-attention reads every frame of ``xk`` / ``xv``
    (the reference's reads only whole chunks of 1,024).  ``plan``: the
    blocks run as ``attn_decode``'s, the cache holds this rank's heads
    where they run by whole heads."""
    p_l = _take(plan, p_l, "dec")
    h = common.rmsnorm(x, p_l["ln1"])
    tp = _tp(plan, ("dec", "attn"))
    h, pa = _tp_enter(h, p_l["attn"], tp)
    q, k, v, h0 = _qkv(h, pa, cfg, None, tp, every_head=True)
    _check_heads(c_l["k"], k)
    kc, vc = attention.cache_update(c_l["k"], c_l["v"], k, v, pos)
    x = x + _attn_out(attention.decode_attend(q, kc, vc, pos), pa, cfg, tp,
                      h0)
    h = common.rmsnorm(x, p_l["ln_x"])
    tp = _tp(plan, ("dec", "xattn"))
    h, px = _tp_enter(h, p_l["xattn"], tp)
    h0, _, gq = _q_heads(cfg, tp, every_head=True)
    (q,) = _proj(h, px, ("wq",), cfg.head_dim, gq)
    out = attention.decode_attend(q, c_l["xk"], c_l["xv"],
                                  c_l["xk"].shape[1] - 1)
    x = x + _attn_out(out, px, cfg, tp, h0)
    f_out, _ = ffn_block(common.rmsnorm(x, p_l["ln2"]), p_l["ffn"], cfg,
                         _tp(plan, ("dec", "ffn")))
    return x + f_out


def whisper_decoder(params, tokens: torch.Tensor, enc_out, cfg: ModelConfig,
                    mode: str, *, cache=None, pos: int | None = None,
                    plan=None):
    """Whisper's decoder: self- and cross-attention.

    "train" / "prefill": tokens (B, T) against ``enc_out`` (B, F, d);
    "prefill" fills the cache's self K/V at [0, T) and its cross K/V
    (which must span F frames).  "decode": tokens (B, 1) at ``pos``
    against the cache, written in place.  -> (x final-normed, cache).
    Under a ``plan`` that cuts the vocabulary, ``params["embed"]`` is
    this rank's block (``vocab_embed``)."""
    x = _lookup(params, tokens, _vocab(plan))
    if mode == "decode":
        x = x + params["dec_pos"][pos][None, None].to(x.dtype)
    else:
        x = x + params["dec_pos"][None, :x.shape[1]].to(x.dtype)
    if mode == "prefill" and cache[0]["xk"].shape[2] != enc_out.shape[1]:
        raise ValueError(f"the cache holds {cache[0]['xk'].shape[2]} frames,"
                         f" the encoder gave {enc_out.shape[1]}")
    remat = _remat(cfg, mode)
    layers = _unstack(params["dec"], cfg.n_dec_layers)
    for i, p_l in common.identical(enumerate(layers)):
        if mode == "train":
            x = _run(_decoder_layer, remat, x, p_l, enc_out, cfg, None,
                     plan)
        elif mode == "prefill":
            x = _decoder_layer(x, p_l, enc_out, cfg, _layer(cache[0], i),
                               plan)
        else:
            x = _decoder_layer_decode(x, p_l, cfg, _layer(cache[0], i), pos,
                                      plan)
    return common.rmsnorm(x, params["final_norm"]), cache


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def _on_device(params: dict, tokens, device) -> tuple[torch.device,
                                                       torch.Tensor]:
    """Resolve ``device`` (raises without a card when it is CUDA), check
    the parameters lie there, move the tokens there."""
    dev = resolve_device(device)
    where = params["embed"].device
    if where != dev:
        raise ValueError(f"parameters are on {where}, expected {dev}")
    return dev, torch.as_tensor(tokens, device=dev).to(torch.int64)


def _patches(batch: dict, cfg: ModelConfig, dev: torch.device):
    """A vlm batch's (B, P, d) patch embeddings on ``dev``, else None."""
    if cfg.family != "vlm" or batch.get("patches") is None:
        return None
    return torch.as_tensor(batch["patches"], device=dev)


def _prefix(cfg: ModelConfig, patches) -> int:
    """Positions before the first token: meta tokens and patches."""
    return cfg.meta_tokens + (0 if patches is None else patches.shape[1])


def _vocab(plan):
    """The group that cuts the vocabulary under ``plan``, else None."""
    return None if plan is None else plan.vocab


def vocab_embed(block: torch.Tensor, tokens: torch.Tensor, group
                ) -> torch.Tensor:
    """The rows of ``tokens`` from this rank's block of the embedding
    (rows [r·n, (r+1)·n) of rank r of ``group``): the rows of the ids
    outside the block are zeros, and the sum over ``group`` adds exactly
    one non-zero row an id, so it is bitwise the whole lookup.  The
    backward gives the block its rows of the whole gradient."""
    n = block.shape[0]
    local = tokens - parallel.rank(group) * n
    inside = (local >= 0) & (local < n)
    rows = block[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, 0.0)
    return parallel.reduce_from(rows, group)


def _lookup(params, tokens: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return params["embed"][tokens]
    return vocab_embed(params["embed"], tokens, group)


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                  group=None):
    x = _lookup(params, tokens, group)
    if cfg.emb_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig,
                 patches: torch.Tensor | None = None, group=None):
    """Token embedding behind the vlm patch prefix and the meta-token
    prefix. -> (B, S_total, d).  ``group``: ``params["embed"]`` is this
    rank's vocabulary block over it (``vocab_embed``)."""
    x = _embed_tokens(params, tokens, cfg, group)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    if cfg.meta_tokens:
        meta = params["meta"][None].to(x.dtype).expand(
            x.shape[0], cfg.meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
    return x


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_logits(params, x, cfg: ModelConfig):
    logits = x.to(torch.float32) @ _head(params, cfg).to(torch.float32)
    logits = common.softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:           # drop padded columns
        logits = logits[..., :cfg.vocab]
    return logits


def _pad_mask(cfg: ModelConfig, lo: int, n: int, device):
    """0 for the columns [lo, lo + n) of the vocabulary, -1e30 for those
    of its padding (by their global index); None without padding."""
    if cfg.vocab_padded == cfg.vocab:
        return None
    cols = torch.arange(lo, lo + n, device=device)
    return torch.where(cols < cfg.vocab, 0.0, -1e30).to(torch.float32)


def vocab_logits(x, head: torch.Tensor, cfg: ModelConfig, group
                 ) -> torch.Tensor:
    """This rank's block of the logits, (..., n): ``head`` is its block
    of the head's columns over ``group`` (columns [r·n, (r+1)·n) of rank
    r), softcapped, the padded vocabulary's columns at -1e30.  The
    backward sums the gradient of ``x`` over ``group``."""
    n = head.shape[-1]
    logits = parallel.copy_to(x, group).to(torch.float32) \
        @ head.to(torch.float32)
    logits = common.softcap(logits, cfg.logit_softcap)
    mask = _pad_mask(cfg, parallel.rank(group) * n, n, logits.device)
    return logits if mask is None else logits + mask


def _logits(params, x, cfg: ModelConfig, plan):
    """The whole logits (padding dropped), or under a plan that cuts the
    vocabulary this rank's block of them (``vocab_logits``)."""
    group = _vocab(plan)
    if group is None:
        return lm_logits(params, x, cfg)
    return vocab_logits(x, _head(params, cfg), cfg, group)


def _encode(params, batch: dict, cfg: ModelConfig, device, plan=None):
    """An enc_dec batch's encoder output and decoder tokens on the device."""
    dev, tokens = _on_device(params, batch["dec_tokens"], device)
    frames = torch.as_tensor(batch["frames"], device=dev)
    return encoder_stack(params, frames, cfg, plan), tokens


def _hidden(params, batch: dict, cfg: ModelConfig, device, plan=None):
    """The final-normed hidden states of the tokens (prefixes cut),
    (B, S, d), the tokens on the device and the MoEAux summed over the
    layers.  An enc_dec batch holds "frames" and "dec_tokens".  Under a
    ``plan`` the unstacked leaves are whole already, save the
    vocabulary blocks over "model"."""
    if cfg.enc_dec:
        enc, tokens = _encode(params, batch, cfg, device, plan)
        x, _ = whisper_decoder(params, tokens, enc, cfg, "train", plan=plan)
        return x, tokens, _zero_aux(x.device)
    dev, tokens = _on_device(params, batch["tokens"], device)
    patches = _patches(batch, cfg, dev)
    x = embed_inputs(params, tokens, cfg, patches, _vocab(plan))
    x, aux, _ = decoder_stack(params, x, cfg, "train", plan=plan)
    x = common.rmsnorm(x, params["final_norm"])
    prefix = _prefix(cfg, patches)
    return (x[:, prefix:] if prefix else x), tokens, aux


@torch.no_grad()
def forward(params, batch: dict, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda"):
    """Teacher-forcing forward: batch {"tokens": (B, S)} (a vlm batch may
    add "patches" (B, P, d); an enc_dec batch is {"frames": (B, F, d),
    "dec_tokens": (B, T)}) -> logits (B, S, V) of the tokens."""
    x, _, _ = _hidden(params, batch, cfg, device)
    return lm_logits(params, x, cfg)


def _ce_chunk(xs, ls, head, pad_mask, cap: float):
    """Summed next-token cross-entropy of one chunk of positions; label
    < 0 is masked.  (B, C, d) x (d, Vp) logits, held for this chunk only."""
    logits = common.softcap(xs.to(torch.float32) @ head.to(torch.float32),
                            cap)
    if pad_mask is not None:
        logits = logits + pad_mask
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(ls, min=0)[..., None])[..., 0]
    return torch.sum((lse - gold) * (ls >= 0).to(torch.float32))


def _ce_chunk_vocab(xs, ls, head, cfg: ModelConfig, group):
    """``_ce_chunk`` over the vocabulary's blocks: ``head`` is this
    rank's (d, n) block over ``group``.  The max over the ranks (an
    all-reduce MAX, no gradient), the sum of exp(logit - max) and the
    gold logit (from the one rank whose block holds the label) are each
    summed over ``group`` by ``reduce_from``, so every rank holds the
    chunk's loss and its block's gradient."""
    logits = vocab_logits(xs, head, cfg, group)
    n = logits.shape[-1]
    top = parallel.all_reduce(logits.detach().amax(dim=-1), group,
                              dist.ReduceOp.MAX)
    total = parallel.reduce_from(
        torch.sum(torch.exp(logits - top[..., None]), dim=-1), group)
    lse = torch.log(total) + top
    local = ls - parallel.rank(group) * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1,
                        torch.where(inside, local, 0)[..., None])[..., 0]
    gold = parallel.reduce_from(torch.where(inside, gold, 0.0), group)
    return torch.sum((lse - gold) * (ls >= 0).to(torch.float32))


def loss_fn(params, batch: dict, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda", plan=None):
    """Next-token cross-entropy with chunked logits: (loss, metrics).

    Labels are ``batch["labels"]`` or the tokens shifted left with -1
    last; a label < 0 is masked.  The logits are computed in chunks of
    positions (the largest divisor of S up to 512, as in the reference)
    and, under autograd, recomputed chunk by chunk in the backward, so no
    (B, S, V) tensor is ever held.  The padded vocabulary's columns are
    masked at -1e30.  A MoE model's loss adds 0.01·lb/L + 1e-4·z/L of
    the load-balance and z-loss terms summed over its L layers; its
    metrics carry their sums ``moe_lb`` and ``moe_drop`` (zeros for the
    other families).  An enc_dec model's loss is over its
    ``dec_tokens``.  Differentiable: the caller decides whether autograd
    records it.  ``plan`` (a ``parallel.Plan``): ``params`` is this
    rank's shards; the norms and prefixes are gathered here once, each
    layer's leaves in the layer, and where "model" cuts the vocabulary
    the lookup and the cross-entropy run over its blocks
    (``vocab_embed``, ``_ce_chunk_vocab``)."""
    if plan is not None:
        params = plan.take_top(params)
    x, tokens, aux = _hidden(params, batch, cfg, device, plan)
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                           dim=1)
    else:
        labels = torch.as_tensor(labels, device=x.device).to(torch.int64)
    head, group = _head(params, cfg), _vocab(plan)
    if group is None:
        chunk_fn = _ce_chunk
        extra = (_pad_mask(cfg, 0, cfg.vocab_padded, x.device),
                 cfg.logit_softcap)
    else:
        chunk_fn, extra = _ce_chunk_vocab, (cfg, group)
    s = x.shape[1]
    chunk = attention.div_chunk(s, 512)
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        xs, ls = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if grad:
            part = checkpoint(chunk_fn, xs, ls, head, *extra,
                              use_reentrant=False)
        else:
            part = chunk_fn(xs, ls, head, *extra)
        tot = tot + part
        cnt = cnt + torch.sum((ls >= 0).to(torch.float32))
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce
    if cfg.n_experts:
        loss = loss + 0.01 * aux.load_balance / cfg.n_layers \
            + 1e-4 * aux.router_z / cfg.n_layers
    return loss, {"ce": ce, "loss": loss, "tokens": cnt,
                  "moe_lb": aux.load_balance, "moe_drop": aux.dropped_frac}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = "cuda") -> list:
    """Per-segment cache (zeros) for ``max_len`` positions after the meta
    prefix (a vlm prompt's patches count among them); shapes depend on
    the segment kinds.  An ssm model's RWKV states ``s`` are f32 whatever
    ``dtype``; an enc_dec model's ``max_len`` is its frame count (the
    cross K/V), its self K/V spans ``decoder_len``."""
    dev = resolve_device(device)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    if cfg.enc_dec:
        Ld, kvh, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.head_dim
        return [dict(k=zeros(Ld, batch, cfg.decoder_len, kvh, hd),
                     v=zeros(Ld, batch, cfg.decoder_len, kvh, hd),
                     xk=zeros(Ld, batch, max_len, kvh, hd),
                     xv=zeros(Ld, batch, max_len, kvh, hd))]
    if cfg.family == "ssm":
        L, n = cfg.n_layers, cfg.rwkv_head_dim
        return [dict(s=zeros(L, batch, cfg.d_model // n, n, n,
                             dt=torch.float32),
                     x_tm=zeros(L, batch, cfg.d_model),
                     x_cm=zeros(L, batch, cfg.d_model))]
    total = max_len + cfg.meta_tokens
    out = []
    for seg in segments(cfg):
        s_kv = min(cfg.window, total) if seg.kind == "swa" else total
        kv_shape = (seg.size, batch, s_kv, cfg.n_kv_heads, cfg.head_dim)
        c = dict(k=torch.zeros(kv_shape, dtype=dtype, device=dev),
                 v=torch.zeros(kv_shape, dtype=dtype, device=dev))
        if cfg.family == "hybrid":
            c.update(
                m_h=torch.zeros((seg.size, batch, cfg.q_dim, cfg.ssm_state),
                                dtype=torch.float32, device=dev),
                m_conv=torch.zeros((seg.size, batch, cfg.ssm_conv - 1,
                                    cfg.q_dim), dtype=dtype, device=dev))
        out.append(c)
    return out


@torch.no_grad()
def prefill(params, batch: dict, cache: list, cfg: ModelConfig, *,
            plan=None, device: str | torch.device | None = "cuda"):
    """Process the prompt (a vlm batch's patches first; an enc_dec batch's
    frames through the encoder, then its "dec_tokens"); returns
    (last-position logits (B, 1, V), the cache, filled in place).
    ``plan``: ``params`` are this rank's shards, ``batch`` its rows and
    ``cache`` its blocks by the reference's prefill ``cache_pspecs``;
    the norms are gathered here, each layer's leaves in the layer; where
    "model" cuts the vocabulary the logits are this rank's block
    (``vocab_logits``: (B, 1, Vp / M), padding at -1e30)."""
    if plan is not None:
        params = plan.take_top(params)
    if cfg.enc_dec:
        enc, tokens = _encode(params, batch, cfg, device, plan)
        x, cache = whisper_decoder(params, tokens, enc, cfg, "prefill",
                                   cache=cache, plan=plan)
        return _logits(params, x[:, -1:], cfg, plan), cache
    dev, tokens = _on_device(params, batch["tokens"], device)
    x = embed_inputs(params, tokens, cfg, _patches(batch, cfg, dev),
                     _vocab(plan))
    x, _, cache = decoder_stack(params, x, cfg, "prefill", cache=cache,
                                plan=plan)
    x = common.rmsnorm(x, params["final_norm"])
    return _logits(params, x[:, -1:], cfg, plan), cache


@torch.no_grad()
def decode_step(params, tokens, pos: int, cache: list, cfg: ModelConfig, *,
                kv_shard=None, plan=None,
                device: str | torch.device | None = "cuda"):
    """One token step. tokens (B, 1); ``pos`` = its absolute position in
    the prompt + generated stream, a vlm prompt's patches included (the
    meta prefix is added here; an enc_dec model's is its position among
    the decoder's tokens).  ``kv_shard``: a ``torch.distributed`` group
    over whose ranks the full-attention caches split their positions
    (every rank of it calls this with its slice; an enc_dec or ssm model
    has no such cache and refuses it).  ``plan``: as ``prefill``'s, the
    cache laid out by the reference's decode ``cache_pspecs`` (its
    full-attention positions over ``kv_shard``'s axes), the logits this
    rank's vocabulary block where "model" cuts it.

    Returns (logits (B, 1, V), the cache, updated in place)."""
    if kv_shard is not None and (cfg.enc_dec or cfg.family == "ssm"):
        raise ValueError(f"{cfg.name}: no full-attention decoder cache to "
                         "shard")
    if plan is not None:
        params = plan.take_top(params)
    dev, tokens = _on_device(params, tokens, device)
    if cfg.enc_dec:
        x, cache = whisper_decoder(params, tokens, None, cfg, "decode",
                                   cache=cache, pos=int(pos), plan=plan)
        return _logits(params, x, cfg, plan), cache
    x = _embed_tokens(params, tokens, cfg, _vocab(plan))
    eff_pos = pos + cfg.meta_tokens
    posv = torch.full((tokens.shape[0],), eff_pos, dtype=torch.int64,
                      device=dev)
    x, _, cache = decoder_stack(params, x, cfg, "decode", cache=cache,
                                pos=posv, kv_shard=kv_shard, plan=plan)
    x = common.rmsnorm(x, params["final_norm"])
    return _logits(params, x, cfg, plan), cache
