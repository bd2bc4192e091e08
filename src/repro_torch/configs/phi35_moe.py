"""Phi-3.5-MoE 42B (6.6B active) — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    d_head=128,
    n_experts=16,
    top_k=2,
    rope_theta=10_000.0,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="phi35-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=96, vocab=256, n_experts=4, top_k=2)
