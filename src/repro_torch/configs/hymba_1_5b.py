"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer.

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16, 128 meta tokens, SWA everywhere except 3 global layers
(first / middle / last).  [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001,
        attn_kind="local_global", global_layers=(0, 15, 31), window=1024,
        ssm_state=16, ssm_conv=4, meta_tokens=128,
        rope_theta=10_000.0,
        remat="dots", microbatch=1, scan_chunk=256)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=257,
        attn_kind="local_global", global_layers=(0, 3), window=32,
        ssm_state=8, ssm_conv=4, meta_tokens=8,
        remat="none", scan_chunk=16)


register(full, smoke)
