"""Granite-3.0-2B base — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    d_head=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=128)
