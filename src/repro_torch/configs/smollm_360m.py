"""SmolLM-360M — llama-architecture small [hf:HuggingFaceTB/SmolLM-360M].

Assigned spec: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    d_head=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", n_layers=2, d_model=96, n_heads=3,
        n_kv_heads=1, d_head=32, d_ff=256, vocab=512)
