"""The assigned input-shape cells and meta-tensor stand-ins for the dry
run (the port of ``repro/configs/shapes.py``).

LM transformer shapes are (seq_len x global_batch); ``decode_*`` /
``long_*`` run one decode step (one new token against a cache of
seq_len) rather than a train step; ``long_500k`` only applies to
sub-quadratic archs (xlstm / zamba2 SSM state, mixtral SWA), as
:func:`applicable` says. :func:`input_specs` returns meta tensors (no
storage) with the reference's names, shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention (SSM/hybrid/SWA archs)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if applicable(cfg, shape):
        return None
    return (f"{cfg.name} is pure full-attention: a 512k-token decode KV cache "
            f"is outside the regime this arch targets (sub-quadratic archs "
            f"xlstm/zamba2/mixtral run this cell; see DESIGN.md §4)")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                act_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input (no storage).

    train:   {tokens, labels}                       (B, S) int32
    prefill: {tokens}                               (B, S) int32
    decode:  {tokens}                               (B, 1) int32, and
             {positions} (B,) int32; the cache is the step builder's.
    Frontends (vlm/audio) add stub embeddings (``frontend_embed``,
    ``enc_frames``) in ``act_dtype``.
    """
    B, S = shape.global_batch, shape.seq_len
    tok = lambda s: torch.empty(s, dtype=torch.int32, device="meta")
    emb = lambda s: torch.empty(s, dtype=act_dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = tok((B, S))
        specs["labels"] = tok((B, S))
    elif shape.kind == "prefill":
        specs["tokens"] = tok((B, S))
    else:  # decode: one new token, a cache of length S from the step builder
        specs["tokens"] = tok((B, 1))
        specs["positions"] = tok((B,))

    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["frontend_embed"] = emb((B, cfg.frontend_len, cfg.d_model))
    if cfg.frontend == "audio":
        # the encoder always sees the (stub) frame embeddings, even at decode
        specs["enc_frames"] = emb((B, cfg.frontend_len, cfg.d_model))
    return specs


def cell_list(arch_names: List[str]) -> List[tuple]:
    """All runnable (arch, shape) dry-run cells, in a stable order."""
    from repro_torch import configs
    cells = []
    for a in arch_names:
        cfg = configs.get(a)
        for s in SHAPES.values():
            if applicable(cfg, s):
                cells.append((a, s.name))
    return cells
