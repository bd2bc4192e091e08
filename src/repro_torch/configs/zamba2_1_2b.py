"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

38 blocks: Mamba2 backbone with a single global shared attention+FFN
block (weights shared across its occurrences — counted once in params
and in the paper's D_ISL handoff payload) interleaved every 6th block.
Hybrid SSM => sub-quadratic, eligible for long_500k.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=36,                    # 6 units of (5 mamba2 + 1 shared attn)
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    d_head=64,
    ssm_state=64,
    pattern=("mamba2",) * 5 + ("shared_attn",),
    rope_theta=10_000.0,
    sub_quadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256, ssm_state=16,
        pattern=("mamba2", "shared_attn"))
