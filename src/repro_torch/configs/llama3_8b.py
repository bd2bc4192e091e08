"""Llama-3-8B — dense GQA, 128k vocab [arXiv:2407.21783]."""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    d_head=128,
    rope_theta=500_000.0,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=160, vocab=256)
