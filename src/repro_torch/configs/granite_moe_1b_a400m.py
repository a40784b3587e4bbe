"""granite-moe-1b-a400m [moe] — IBM Granite 3.0 1B-A400M base.

24L d_model=1024 16H (GQA kv=8, head_dim=64) d_ff=512 (expert) vocab=49155,
MoE 32 experts top-8, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The port resolves and counts this config; its MoE model code waits for
ROADMAP.md Queue 1, item 18c (``param_specs`` and the entry points raise).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155,
        n_experts=32, top_k=8, capacity_factor=1.25,
        tie_embeddings=True, rope_theta=10_000.0,
        remat="dots", microbatch=2, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=259,
        n_experts=8, top_k=4, capacity_factor=1.25,
        tie_embeddings=True,
        remat="none", scan_chunk=32)


register(full, smoke)
