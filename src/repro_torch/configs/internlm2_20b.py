"""InternLM2-20B — dense GQA [arXiv:2403.17297]."""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    d_head=128,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="internlm2-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=256, vocab=256)
