"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144.
Every 6th layer is global full attention; local layers SWA window 1024.
QK-norm, sqrt(d) embedding scaling.  [hf:google/gemma-3-*; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab=262144,
        attn_kind="local_global", global_every=6, window=1024,
        qk_norm=True, emb_scale=True, tie_embeddings=True,
        rope_theta=1_000_000.0,
        fsdp=True, remat="full", microbatch=8, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        attn_kind="local_global", global_every=3, window=32,
        qk_norm=True, emb_scale=True, tie_embeddings=True,
        remat="none", scan_chunk=16)


register(full, smoke)
