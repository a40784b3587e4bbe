"""nemotron-4-340b [dense] — NVIDIA Nemotron-4 340B.

96L d_model=18432 96H (GQA kv=8, head_dim=192) d_ff=73728 vocab=256000.
Ungated 2-matrix squared-ReLU MLP, as in the original (param count lands at
~341B, matching the advertised 340B).  [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256000,
        mlp_act="squared_relu", mlp_gated=False,
        rope_theta=10_000.0,
        fsdp=True, optimizer="adafactor", param_dtype="bfloat16",
        remat="full", microbatch=8, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        mlp_act="squared_relu", mlp_gated=False,
        remat="none", scan_chunk=32)


register(full, smoke)
