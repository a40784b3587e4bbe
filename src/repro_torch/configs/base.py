"""Model and shape configuration for the LM wing of the port.

The port's own copy of ``repro.configs.base``: the ``ModelConfig``
dataclass with the same fields and defaults, the shape cells, the
registry of the ten architectures (``get_config``, ``list_archs``) and
the analytic counts (``count_params``, ``active_params``).  Every
architecture resolves; which families the model code runs is decided in
``repro_torch.models.transformer``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # attention flavour
    attn_kind: str = "full"       # full | swa | local_global
    window: int = 0               # SWA window (swa / local layers)
    global_every: int = 0         # local_global: every k-th layer is global
    global_layers: tuple[int, ...] = ()   # explicit global positions (hybrid)
    parallel_block: bool = False  # attn & FFN share the residual
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mlp_act: str = "silu"         # silu | squared_relu | gelu
    mlp_gated: bool = True        # False: 2-matrix MLP
    mlp_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    emb_scale: bool = False       # sqrt(d) embedding scaling

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / RWKV / hybrid
    ssm_state: int = 0            # mamba state size (hymba)
    ssm_conv: int = 4             # depthwise conv width
    rwkv_head_dim: int = 64
    meta_tokens: int = 0          # hymba learnable prefix

    # encoder-decoder
    enc_dec: bool = False
    n_dec_layers: int = 0
    decoder_len: int = 448

    # modality frontend stub
    frontend: str = "none"        # none | audio_stub | vision_stub
    n_patches: int = 0            # vlm: image patch prefix length

    # distribution / memory policy
    fsdp: bool = False            # the reference's mesh sharding (item 18e)
    remat: str = "full"           # full | dots | none (train/step.py)
    microbatch: int = 1           # grad-accumulation steps per train step
    optimizer: str = "adamw"      # adamw | adafactor
    param_dtype: str = "bfloat16"
    scan_chunk: int = 512         # attention/recurrence chunk length

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # parameters are padded to a multiple of this many vocab rows; padded
    # logit columns are sliced off.  0 disables.
    pad_vocab_to: int = 128

    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab_to:
            return self.vocab
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-context decode cell?"""
        if self.family in ("ssm", "hybrid"):
            return True
        # a bounded window (the global layers' caches shard the sequence)
        return self.attn_kind in ("swa", "local_global")

    def runs_shape(self, shape: str) -> bool:
        if shape == "long_500k":
            return self.sub_quadratic
        return shape in SHAPES

    def layer_kind(self, i: int) -> str:
        """'full' or 'swa' for attention layer i (local_global patterning)."""
        if self.attn_kind == "swa":
            return "swa"
        if self.attn_kind == "local_global":
            if self.global_layers:
                return "full" if i in self.global_layers else "swa"
            return "full" if (i + 1) % self.global_every == 0 else "swa"
        return "full"

    @property
    def global_positions(self) -> tuple[int, ...]:
        return tuple(i for i in range(self.n_layers)
                     if self.layer_kind(i) == "full")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    cfg = full()
    _REGISTRY[cfg.name] = full
    _SMOKE[cfg.name] = smoke


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the architectures)
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def count_params(cfg: ModelConfig) -> int:
    """Total parameter count (analytic, as the reference counts it: the
    unpadded vocab, no norms, meta tokens or per-channel vectors)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    if cfg.family == "ssm":                      # rwkv6
        per_layer += 4 * d * d + d * cfg.rwkv_head_dim
        per_layer += 2 * d * f
    else:
        qkv = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        per_layer += qkv
        if cfg.family == "hybrid":
            d_in = cfg.q_dim
            per_layer += d * 2 * d_in + d_in * d                 # in/out proj
            per_layer += d_in * (2 * cfg.ssm_state + 1) + d_in * cfg.ssm_conv
        nf = 3 if cfg.mlp_gated else 2
        if cfg.n_experts:
            per_layer += d * cfg.n_experts
            per_layer += cfg.n_experts * nf * d * f
        else:
            per_layer += nf * d * f
    n = emb + L * per_layer
    if cfg.enc_dec:
        dec = cfg.n_dec_layers * (2 * (d * cfg.q_dim + 2 * d * cfg.kv_dim
                                       + cfg.q_dim * d) + 3 * d * f)
        n += dec
    return n


def active_params(cfg: ModelConfig) -> int:
    """Active parameters a token (MoE: top_k of n_experts), for 6·N·D."""
    if not cfg.n_experts:
        return count_params(cfg)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    nf = 3 if cfg.mlp_gated else 2
    inactive = L * (cfg.n_experts - cfg.top_k) * nf * d * f
    return count_params(cfg) - inactive
