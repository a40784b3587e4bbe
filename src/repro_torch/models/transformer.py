"""The LM stack of the dense, vlm and hybrid families: ``forward`` /
``prefill`` / ``decode_step`` and the training loss ``loss_fn`` over
stacked per-layer parameters.

The PyTorch counterpart of ``repro.models.transformer`` for the branches
these families take.  A dense layer is pre-norm attention then a dense
FFN (gated or not), or with ``parallel_block`` both on the same normed
input added to one residual; a hybrid layer (Hymba) runs attention and a
Mamba mixer side by side and averages their normed outputs; a vlm model
is a dense one with a patch-embedding prefix.  Heterogeneous layer
patterns (gemma3's 5:1 local:global, Hymba's explicit global layers) are
cut into *segments*, runs of one attention kind; parameters stay stacked
over all layers with the reference's names, and ``decoder_stack`` is a
host loop over each segment's layers where the reference scans them.

Caches are the reference's list of per-segment dicts: full-attention
segments carry (run, B, S, KVH, hd) K/V, SWA segments ring buffers of
width ``window``, and hybrid segments also the Mamba states ``m_h``
(run, B, D, N) and ``m_conv`` (run, B, K-1, D).  ``prefill`` and
``decode_step`` write the cache in place and return it.

Entry points take ``device=`` (the card by default) and raise if the
parameters do not lie there.  The MoE, RWKV and Whisper families raise
NotImplementedError naming their ROADMAP item, and so does training a
hybrid model.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mamba
from repro_torch.models.common import ParamSpec as PS

SERVED = ("dense", "vlm", "hybrid")
TRAINED = ("dense", "vlm")


def _check_family(cfg: ModelConfig, *, train: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the
    port does not run yet."""
    where = f"{cfg.name} ({cfg.family} family)"
    if cfg.n_experts or cfg.family in ("moe", "ssm"):
        raise NotImplementedError(
            f"{where}: MoE and RWKV wait for ROADMAP.md Queue 1, item 18c")
    if cfg.enc_dec or cfg.family not in SERVED:
        raise NotImplementedError(
            f"{where}: Whisper waits for ROADMAP.md Queue 1, item 18d")
    if train and cfg.family not in TRAINED:
        raise NotImplementedError(
            f"{where}: training a hybrid model needs a backward of the "
            "ssm_scan kernel, ROADMAP.md Queue 1, item 20")


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
    _check_family(cfg)
    d, v, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    specs: dict = {
        "embed": PS((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": PS((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PS((d, v), ("embed", "vocab"))
    layers = {
        "ln1": PS((L, d), ("layers", "embed"), init="zeros"),
        "ln2": PS((L, d), ("layers", "embed"), init="zeros"),
        "attn": _attn_specs(cfg, L),
        "ffn": _ffn_specs(cfg, L),
    }
    if cfg.family == "hybrid":
        layers["mamba"] = mamba.param_specs(cfg, d_inner=cfg.q_dim)
        layers["attn_gamma"] = PS((L, cfg.q_dim), ("layers", "q_heads"),
                                  init="zeros")
        layers["mamba_gamma"] = PS((L, cfg.q_dim), ("layers", "q_heads"),
                                   init="zeros")
    specs["layers"] = layers
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
    """Full-sequence attention (forward, loss and prefill compute).

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


def _ffn_residual(x, h, attn_out, p, cfg: ModelConfig):
    """The FFN and the residual adds.  A parallel block's FFN reads the
    same normed ``h`` as attention and ``ln2`` is not applied, as in the
    reference."""
    if cfg.parallel_block:
        return x + attn_out + ffn_block(h, p["ffn"], cfg)
    x = x + attn_out
    return x + ffn_block(common.rmsnorm(x, p["ln2"]), p["ffn"], cfg)


# ---------------------------------------------------------------------------
# Decoder layers (train / prefill / decode)
# ---------------------------------------------------------------------------


def layer_train(x, p, cfg: ModelConfig, kind: str):
    """One decoder layer, full sequence. Returns (x, (k, v))."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, kv = attn_train(h, p["attn"], cfg, kind)
    if cfg.family == "hybrid":
        m_out, _ = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim)
        attn_out = _mix(attn_out, m_out, p)
    return _ffn_residual(x, h, attn_out, p, cfg), kv


def layer_decode(x, p, cfg: ModelConfig, kind: str, cache, pos):
    """One decoder layer, one token; writes the layer's cache in place.
    Returns (x, cache)."""
    h = common.rmsnorm(x, p["ln1"])
    attn_out, _ = attn_decode(h, p["attn"], cfg, kind, cache, pos)
    if cfg.family == "hybrid":
        mst = mamba.MambaState(h=cache["m_h"], conv=cache["m_conv"])
        m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim,
                                     state=mst)
        cache["m_h"].copy_(mst.h)
        cache["m_conv"].copy_(mst.conv)
        attn_out = _mix(attn_out, m_out, p)
    return _ffn_residual(x, h, attn_out, p, cfg), cache


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
    if cfg.family == "hybrid":
        m_out, mst = mamba.mamba_mix(h, p["mamba"], d_inner=cfg.q_dim)
        cache["m_h"].copy_(mst.h)
        cache["m_conv"].copy_(mst.conv)
        attn_out = _mix(attn_out, m_out, p)
    return _ffn_residual(x, h, attn_out, p, cfg), cache


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


def _train_layer(x, p_l, cfg: ModelConfig, kind: str):
    return layer_train(x, p_l, cfg, kind)[0]


def decoder_stack(params, x, cfg: ModelConfig, mode: str, *,
                  cache=None, pos=None):
    """Run all decoder layers, a host loop over each segment's layers.
    ``mode`` is "train" (no cache), "prefill" or "decode" (the cache is
    written in place).  Returns (x, cache).

    In "train" mode under autograd, ``cfg.remat`` "full" and "dots" put
    each layer under ``torch.utils.checkpoint`` (only its input is kept;
    its activations are recomputed in the backward), "none" keeps them
    all.  "dots" saves nothing more than "full" here: the reference's
    policy of also keeping the matmul outputs has no counterpart.  The
    values are the same either way."""
    remat = mode == "train" and torch.is_grad_enabled() \
        and cfg.remat != "none"
    layers = _unstack(params["layers"], cfg.n_layers)
    for si, seg in enumerate(segments(cfg)):
        for i in range(seg.start, seg.end):
            p_l = layers[i]
            if mode == "train":
                if remat:
                    x = checkpoint(_train_layer, x, p_l, cfg, seg.kind,
                                   use_reentrant=False)
                else:
                    x = _train_layer(x, p_l, cfg, seg.kind)
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


def _patches(batch: dict, cfg: ModelConfig, dev: torch.device):
    """A vlm batch's (B, P, d) patch embeddings on ``dev``, else None."""
    if cfg.family != "vlm" or batch.get("patches") is None:
        return None
    return torch.as_tensor(batch["patches"], device=dev)


def _prefix(cfg: ModelConfig, patches) -> int:
    """Positions before the first token: meta tokens and patches."""
    return cfg.meta_tokens + (0 if patches is None else patches.shape[1])


def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.emb_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig,
                 patches: torch.Tensor | None = None):
    """Token embedding behind the vlm patch prefix and the meta-token
    prefix. -> (B, S_total, d)."""
    x = _embed_tokens(params, tokens, cfg)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
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


def _hidden(params, batch: dict, cfg: ModelConfig, device):
    """The final-normed hidden states of the tokens (prefixes cut),
    (B, S, d), and the tokens on the device."""
    dev, tokens = _on_device(params, batch["tokens"], device)
    patches = _patches(batch, cfg, dev)
    x = embed_inputs(params, tokens, cfg, patches)
    x, _ = decoder_stack(params, x, cfg, "train")
    x = common.rmsnorm(x, params["final_norm"])
    prefix = _prefix(cfg, patches)
    return (x[:, prefix:] if prefix else x), tokens


@torch.no_grad()
def forward(params, batch: dict, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda"):
    """Teacher-forcing forward: batch {"tokens": (B, S)} (a vlm batch may
    add "patches" (B, P, d)) -> logits (B, S, V) of the tokens."""
    _check_family(cfg)
    x, _ = _hidden(params, batch, cfg, device)
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


def loss_fn(params, batch: dict, cfg: ModelConfig, *,
            device: str | torch.device | None = "cuda"):
    """Next-token cross-entropy with chunked logits: (loss, metrics).

    Labels are ``batch["labels"]`` or the tokens shifted left with -1
    last; a label < 0 is masked.  The logits are computed in chunks of
    positions (the largest divisor of S up to 512, as in the reference)
    and, under autograd, recomputed chunk by chunk in the backward, so no
    (B, S, V) tensor is ever held.  The padded vocabulary's columns are
    masked at -1e30.  Differentiable: the caller decides whether autograd
    records it.  A hybrid model's loss is refused only under autograd:
    its forward runs, its backward does not exist yet."""
    _check_family(cfg, train=torch.is_grad_enabled())
    x, tokens = _hidden(params, batch, cfg, device)
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                           dim=1)
    else:
        labels = torch.as_tensor(labels, device=x.device).to(torch.int64)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    s = x.shape[1]
    chunk = attention.div_chunk(s, 512)
    pad_mask = None
    if cfg.vocab_padded != cfg.vocab:
        pad_mask = torch.where(
            torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab,
            0.0, -1e30).to(torch.float32)
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        xs, ls = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if grad:
            part = checkpoint(_ce_chunk, xs, ls, head, pad_mask,
                              cfg.logit_softcap, use_reentrant=False)
        else:
            part = _ce_chunk(xs, ls, head, pad_mask, cfg.logit_softcap)
        tot = tot + part
        cnt = cnt + torch.sum((ls >= 0).to(torch.float32))
    ce = tot / torch.clamp(cnt, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    # the MoE load-balance and drop terms come with item 18c
    return ce, {"ce": ce, "loss": ce, "tokens": cnt, "moe_lb": zero,
                "moe_drop": zero}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = "cuda") -> list:
    """Per-segment cache (zeros) for ``max_len`` positions after the meta
    prefix (a vlm prompt's patches count among them); shapes depend on
    the segment kinds."""
    _check_family(cfg)
    dev = resolve_device(device)
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
            device: str | torch.device | None = "cuda"):
    """Process the prompt (a vlm batch's patches first); returns
    (last-position logits (B, 1, V), the cache, filled in place)."""
    _check_family(cfg)
    dev, tokens = _on_device(params, batch["tokens"], device)
    x = embed_inputs(params, tokens, cfg, _patches(batch, cfg, dev))
    x, cache = decoder_stack(params, x, cfg, "prefill", cache=cache)
    x = common.rmsnorm(x, params["final_norm"])
    return lm_logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params, tokens, pos: int, cache: list, cfg: ModelConfig, *,
                device: str | torch.device | None = "cuda"):
    """One token step. tokens (B, 1); ``pos`` = its absolute position in
    the prompt + generated stream, a vlm prompt's patches included (the
    meta prefix is added here).

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
