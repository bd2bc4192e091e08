"""Whisper-small — encoder-decoder audio [arXiv:2212.04356].

12 encoder + 12 decoder layers at d_model=768, 12 heads (MHA: kv=12).
The conv frontend is a STUB per the assignment: input_specs provides
precomputed frame embeddings (B, 1500, d_model) — the output length of
whisper's 2x conv stem on 30 s of audio. Decoder = causal self-attention
+ cross-attention to the encoder states. Full attention => long_500k is
skipped (and whisper's source context is 30 s anyway); decode shapes run
against the decoder self-attn cache.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                    # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    d_head=64,
    causal=True,
    enc_dec=True,
    n_enc_layers=12,
    frontend="audio",
    frontend_len=1500,
    tie_embeddings=True,
    mlp_kind="gelu",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256, n_enc_layers=2,
        frontend_len=32)
