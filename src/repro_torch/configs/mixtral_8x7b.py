"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

SWA (window 4096) bounds the decode KV cache, making the 500k-context
decode cell sub-quadratic in memory — eligible for long_500k.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    d_head=128,
    n_experts=8,
    top_k=2,
    window=4096,
    rope_theta=1_000_000.0,
    sub_quadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=96, vocab=256, n_experts=4, top_k=2,
        window=32)
