"""h2o-danube-1.8b [dense] — llama/mistral-mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8, head_dim=80) d_ff=6912 vocab=32000, SWA 4096.
[arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
        d_ff=6912, vocab=32000,
        attn_kind="swa", window=4096,
        rope_theta=10_000.0,
        remat="dots", microbatch=1, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        attn_kind="swa", window=32,
        remat="none", scan_chunk=16)


register(full, smoke)
