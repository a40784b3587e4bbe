"""rwkv6-7b [ssm] — RWKV-6 "Finch": attention-free, data-dependent decay.

32L d_model=4096 (64 heads x 64 head_dim) d_ff=14336 vocab=65536.
[arXiv:2404.05892; hf]

The port resolves and counts this config; its RWKV model code waits for
ROADMAP.md Queue 1, item 18c (``param_specs`` and the entry points raise).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=14336, vocab=65536,
        rwkv_head_dim=64,
        remat="dots", microbatch=1, scan_chunk=64)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=128, vocab=512,
        rwkv_head_dim=16,
        remat="none", scan_chunk=16)


register(full, smoke)
