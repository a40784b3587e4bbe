"""The LM stack, hybrid family (Hymba): ``forward`` / ``prefill`` /
``decode_step`` over stacked per-layer parameters.

The PyTorch counterpart of ``repro.models.transformer`` for the branches
Hymba takes: a hybrid layer runs attention and a Mamba mixer side by side
on the same normed input and averages their normed outputs, then a gated
dense FFN.  Heterogeneous layer patterns (Hymba's explicit global layers
among SWA ones) are cut into *segments*, runs of one attention kind;
parameters stay stacked over all layers with the reference's names, and
``decoder_stack`` is a host loop over each segment's layers where the
reference scans them.

Caches are the reference's list of per-segment dicts: full-attention
segments carry (run, B, S, KVH, hd) K/V, SWA segments ring buffers of
width ``window``, and every hybrid segment the Mamba states ``m_h``
(run, B, D, N) and ``m_conv`` (run, B, K-1, D).  ``prefill`` and
``decode_step`` write the cache in place and return it.

Entry points take ``device=`` (the card by default) and raise if the
parameters do not lie there.  Other families raise NotImplementedError
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mamba
from repro_torch.models.common import ParamSpec as PS

LATER = ("ROADMAP.md Queue 1, item 18: the port runs the hybrid family "
         "(Hymba) with a dense FFN so far")


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.family != "hybrid" or cfg.n_experts or cfg.enc_dec
            or cfg.parallel_block):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family): {LATER}")


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # "full" | "swa" (attention flavour of the run)
    start: int
    end: int           # exclusive

    @property
    def size(self) -> int:
        return self.end - self.start


def segments(cfg: ModelConfig) -> list[Segment]:
    n = cfg.n_layers
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
    _check_family(cfg)
    d, v, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    specs: dict = {
        "embed": PS((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": PS((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PS((d, v), ("embed", "vocab"))
    specs["layers"] = {
        "ln1": PS((L, d), ("layers", "embed"), init="zeros"),
        "ln2": PS((L, d), ("layers", "embed"), init="zeros"),
        "attn": _attn_specs(cfg, L),
        "mamba": mamba.param_specs(cfg, d_inner=cfg.q_dim),
        "attn_gamma": PS((L, cfg.q_dim), ("layers", "q_heads"), init="zeros"),
        "mamba_gamma": PS((L, cfg.q_dim), ("layers", "q_heads"),
                          init="zeros"),
        "ffn": _ffn_specs(cfg, L),
    }
    if cfg.meta_tokens:
        specs["meta"] = PS((cfg.meta_tokens, d), (None, "embed"), scale=1.0)
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = common.rmsnorm(q, p["q_gamma"])
        k = common.rmsnorm(k, p["k_gamma"])
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(x, p, cfg: ModelConfig, kind: str):
    """Full-sequence attention (forward / prefill compute).

    Returns (out, (k, v)) so prefill can write the cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    window = cfg.window if kind == "swa" else 0
    out = attention.attend(q, k, v, causal=True, window=window,
                           chunk=attention.div_chunk(s, cfg.scan_chunk))
    return out.reshape(b, s, cfg.q_dim) @ p["wo"], (k, v)


def attn_decode(x, p, cfg: ModelConfig, kind: str, cache, pos):
    """One-token attention against the cache, written in place.
    ``pos`` (B,) int64.  Returns (out, cache)."""
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg, pos[:, None])
    window = cfg.window if kind == "swa" else 0
    kc, vc = attention.cache_update(cache["k"], cache["v"], k, v, pos,
                                    window=window)
    out = attention.decode_attend(q, kc, vc, pos, window=window)
    return out.reshape(b, 1, cfg.q_dim) @ p["wo"], {"k": kc, "v": vc}


def ffn_block(x, p, cfg: ModelConfig):
    act = common.activation(cfg.mlp_act)
    if cfg.mlp_gated:
        h = act(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = act(x @ p["wu"])
    return h @ p["wd"]


def _mix(attn_out, m_out, p):
    return 0.5 * (common.rmsnorm(attn_out, p["attn_gamma"])
                  + common.rmsnorm(m_out, p["mamba_gamma"]))


def _ffn_residual(x, attn_out, p, cfg: ModelConfig):
    x = x + attn_out
    return x + ffn_block(common.rmsnorm(x, p["ln2"]), p["ffn"], cfg)


# ---------------------------------------------------------------------------
# Decoder layers (train / prefill / decode)
# ---------------------------------------------------------------------------


def layer_train(x, p, cfg: ModelConfig, kind: str):
    """One decoder layer, full sequence. Returns (x, (k, v))."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, kv = attn_train(h, p["attn"], cfg, kind)
    m_out, _ = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim)
    return _ffn_residual(x, _mix(attn_out, m_out, p), p, cfg), kv


def layer_decode(x, p, cfg: ModelConfig, kind: str, cache, pos):
    """One decoder layer, one token; writes the layer's cache in place.
    Returns (x, cache)."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, _ = attn_decode(h, p["attn"], cfg, kind, cache, pos)
    mst = mamba.MambaState(h=cache["m_h"], conv=cache["m_conv"])
    m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim, state=mst)
    cache["m_h"].copy_(mst.h)
    cache["m_conv"].copy_(mst.conv)
    return _ffn_residual(x, _mix(attn_out, m_out, p), p, cfg), cache


def layer_prefill(x, p, cfg: ModelConfig, kind: str, cache):
    """Full-sequence compute + cache population (in place).
    Returns (x, cache)."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, (k, v) = attn_train(h, p["attn"], cfg, kind)
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
    m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim)
    cache["m_h"].copy_(mst.h)
    cache["m_conv"].copy_(mst.conv)
    return _ffn_residual(x, _mix(attn_out, m_out, p), p, cfg), cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    """Layer i's slice of a stacked (L, ...) tree (views, no copies)."""
    return common.tree_map(lambda a: a[i], tree)


def decoder_stack(params, x, cfg: ModelConfig, mode: str, *,
                  cache=None, pos=None):
    """Run all decoder layers, a host loop over each segment's layers.
    ``mode`` is "train" (no cache), "prefill" or "decode" (the cache is
    written in place).  Returns (x, cache)."""
    for si, seg in enumerate(segments(cfg)):
        for i in range(seg.start, seg.end):
            p_l = _layer(params["layers"], i)
            if mode == "train":
                x, _ = layer_train(x, p_l, cfg, seg.kind)
                continue
            c_l = _layer(cache[si], i - seg.start)
            if mode == "prefill":
                x, _ = layer_prefill(x, p_l, cfg, seg.kind, c_l)
            else:
                x, _ = layer_decode(x, p_l, cfg, seg.kind, c_l, pos)
    return x, cache


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


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.emb_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Token embedding with the meta-token prefix. -> (B, S_total, d)."""
    x = _embed_tokens(params, tokens, cfg)
    if cfg.meta_tokens:
        meta = params["meta"][None].to(x.dtype).expand(
            x.shape[0], cfg.meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
    return x


def lm_logits(params, x, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.to(torch.float32) @ head.to(torch.float32)
    logits = common.softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:           # drop padded columns
        logits = logits[..., :cfg.vocab]
    return logits


@torch.no_grad()
def forward(params, batch: dict, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda"):
    """Teacher-forcing forward: batch {"tokens": (B, S)} -> logits (B, S, V)."""
    _check_family(cfg)
    _, tokens = _on_device(params, batch["tokens"], device)
    x = embed_inputs(params, tokens, cfg)
    x, _ = decoder_stack(params, x, cfg, "train")
    x = common.rmsnorm(x, params["final_norm"])
    if cfg.meta_tokens:
        x = x[:, cfg.meta_tokens:]
    return lm_logits(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = "cuda") -> list:
    """Per-segment cache (zeros) for ``max_len`` tokens after the meta
    prefix; shapes depend on the segment kinds."""
    _check_family(cfg)
    dev = resolve_device(device)
    total = max_len + cfg.meta_tokens
    out = []
    for seg in segments(cfg):
        s_kv = min(cfg.window, total) if seg.kind == "swa" else total
        kv_shape = (seg.size, batch, s_kv, cfg.n_kv_heads, cfg.head_dim)
        out.append(dict(
            k=torch.zeros(kv_shape, dtype=dtype, device=dev),
            v=torch.zeros(kv_shape, dtype=dtype, device=dev),
            m_h=torch.zeros((seg.size, batch, cfg.q_dim, cfg.ssm_state),
                            dtype=torch.float32, device=dev),
            m_conv=torch.zeros((seg.size, batch, cfg.ssm_conv - 1,
                                cfg.q_dim), dtype=dtype, device=dev)))
    return out


@torch.no_grad()
def prefill(params, batch: dict, cache: list, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda"):
    """Process the prompt; returns (last-position logits (B, 1, V), the
    cache, filled in place)."""
    _check_family(cfg)
    _, tokens = _on_device(params, batch["tokens"], device)
    x = embed_inputs(params, tokens, cfg)
    x, cache = decoder_stack(params, x, cfg, "prefill", cache=cache)
    x = common.rmsnorm(x, params["final_norm"])
    return lm_logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, pos: int, cache: list, cfg: ModelConfig, *,
                device: str | torch.device | None = "cuda"):
    """One token step. tokens (B, 1); ``pos`` = its absolute position in
    the prompt + generated stream (the meta prefix is added here).

    Returns (logits (B, 1, V), the cache, updated in place)."""
    _check_family(cfg)
    dev, tokens = _on_device(params, tokens, device)
    x = _embed_tokens(params, tokens, cfg)
    eff_pos = pos + cfg.meta_tokens
    posv = torch.full((tokens.shape[0],), eff_pos, dtype=torch.int64,
                      device=dev)
    x, cache = decoder_stack(params, x, cfg, "decode", cache=cache, pos=posv)
    x = common.rmsnorm(x, params["final_norm"])
    return lm_logits(params, x, cfg), cache
