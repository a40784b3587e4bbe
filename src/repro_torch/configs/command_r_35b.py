"""command-r-35b [dense] — Cohere Command-R v01.

40L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22528 vocab=256000.
Parallel attention+FFN residual block, no biases, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab=256000,
        parallel_block=True, tie_embeddings=True,
        rope_theta=8_000_000.0,
        fsdp=True, remat="full", microbatch=8, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        parallel_block=True, tie_embeddings=True,
        remat="none", scan_chunk=32)


register(full, smoke)
