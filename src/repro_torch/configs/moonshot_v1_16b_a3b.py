"""moonshot-v1-16b-a3b [moe] — Kimi/Moonlight-style 16B-total / 3B-active.

48L d_model=2048 16H (kv=16, head_dim=128 via q_dim=2048) d_ff=1408 (expert)
vocab=163840, MoE 64 experts top-6.  [hf:moonshotai/Moonlight-16B-A3B; hf]

The port resolves and counts this config; its MoE model code waits for
ROADMAP.md Queue 1, item 18c (``param_specs`` and the entry points raise).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840,
        n_experts=64, top_k=6, capacity_factor=1.25,
        rope_theta=50_000.0,
        remat="dots", microbatch=8, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=512,
        n_experts=8, top_k=2, capacity_factor=1.25,
        remat="none", scan_chunk=32)


register(full, smoke)
