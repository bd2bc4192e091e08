"""The delta-checkpoint codec: what crosses the ISL (the port of
``repro/isl/codec.py``).

A plane never ships its full checkpoint: it ships the delta since the
checkpoint it last pushed (its ``anchor``), compressed by one of the
:mod:`repro_torch.train.compression` schemes, with error feedback carried
in the exchange state: compression error accumulates in a residual and
rides into the next push instead of being lost.

The codec meters every payload exactly with the compressors' own
``payload_bits``, so the bits the fleet charges to batteries and to the
problem-(13) D_ISL term are the wire's.

* :func:`encode_delta`: ``(params, anchor, residual) -> (delta_hat,
  new_residual)`` for one plane; with ``scheme="int8"`` each leaf is one
  launch of kernel B1 on the card.
* :func:`delta_payload_bits` (shapes only, exact) and
  :func:`codec_label` (for tables).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.train.compression import (SCHEMES, ErrorFeedbackState,
                                           compress, payload_bits, tree_map)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """How a checkpoint delta is compressed for the wire: ``"none"``
    (dense f32), ``"topk"`` (the top-``ratio`` magnitudes and their
    positions) or ``"int8"`` (per-row int8 and f32 scales), all with
    error feedback."""

    scheme: str = "none"
    topk_ratio: float = 0.01
    value_bits: int = 32

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown codec scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(f"topk_ratio must be in (0, 1], "
                             f"got {self.topk_ratio}")


def codec_label(codec: CodecConfig) -> str:
    """A short tag for tables (``topk1pc``, ``int8``, ``none``)."""
    if codec.scheme == "topk":
        pct = codec.topk_ratio * 100.0
        tag = f"{pct:g}".replace(".", "p")
        return f"topk{tag}pc"
    return codec.scheme


def delta_payload_bits(params_tree, codec: CodecConfig) -> float:
    """Exact wire bits of one compressed delta push of ``params_tree``
    (shapes only). Fixed per codec, since shapes do not change in a run,
    so the planner prices the exchange before the run and the meter
    records the same number per contact."""
    return float(payload_bits(params_tree, codec.scheme,
                              topk_ratio=codec.topk_ratio,
                              value_bits=codec.value_bits))


def residual_init(params_tree):
    """A zero error-feedback residual shaped like ``params_tree`` (f32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params_tree)


def encode_delta(params_tree, anchor_tree, residual_tree,
                 codec: CodecConfig) -> Tuple[Any, Any]:
    """One plane's delta push: ``(delta_hat, new_residual)``.

    ``delta_hat`` is what the receiver reconstructs (dense, with the
    sparsification or quantization applied), ``new_residual`` the error
    to carry. Reads nothing back from the device. With
    ``scheme="none"`` the delta is exact and the residual passes through
    as it was (all zero).
    """
    delta = tree_map(lambda p, a: p.float() - a, params_tree, anchor_tree)
    kept, ef, _ = compress(delta, ErrorFeedbackState(residual_tree),
                           scheme=codec.scheme,
                           topk_ratio=codec.topk_ratio)
    return kept, ef.residual
