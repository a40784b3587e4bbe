"""whisper-medium [audio] — encoder-decoder with stub conv frontend.

24L (enc) + 24L (dec) d_model=1024 16H (kv=16 = MHA, head_dim=64) d_ff=4096
vocab=51865.  ``input_specs()`` supplies precomputed frame embeddings
(B, seq_len, d) — the conv1d/mel frontend is the assignment-mandated stub.
seq_len applies to the ENCODER; the decoder is fixed at 448 positions.
[arXiv:2212.04356; unverified]

The port resolves and counts this config; its Whisper model code waits for
ROADMAP.md Queue 1, item 18d (``param_specs`` and the entry points raise).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=51865,
        mlp_act="gelu", enc_dec=True, n_dec_layers=24, decoder_len=448,
        frontend="audio_stub",
        remat="dots", microbatch=1, scan_chunk=512)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=259,
        mlp_act="gelu", enc_dec=True, n_dec_layers=2, decoder_len=16,
        frontend="audio_stub",
        remat="none", scan_chunk=16)


register(full, smoke)
