"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072,
        rope_theta=1_000_000.0,
        frontend="vision_stub", n_patches=1024,
        remat="full", microbatch=4, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        rope_theta=1_000_000.0,
        frontend="vision_stub", n_patches=8,
        remat="none", scan_chunk=32)


register(full, smoke)
