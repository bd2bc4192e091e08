"""Qwen2-VL-7B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191].

Per the assignment spec the modality frontend (ViT) is a STUB: input_specs
provides precomputed patch embeddings of length ``frontend_len`` which the
model splices in front of the token embeddings. M-RoPE (temporal/height/
width split of the rotary dims) is implemented for the backbone.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    d_head=128,
    rope_theta=1_000_000.0,
    mrope=True,
    frontend="vision",
    frontend_len=256,               # one 512x512 image ~ 256 merged patches
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, frontend_len=8)
