"""Gradient and delta compression with exact payload-bit metering (the port
of ``repro/train/compression.py``).

Two schemes, both with error feedback, so compression error accumulates
locally instead of biasing the update (Stich et al., memory-compensated
SGD):

* top-k sparsification: keep the k largest-|g| entries of each tensor
  (k = max(1, int(ratio * numel))); the residual feeds the next call.
* int8 rows: the symmetric per-row quantizer of the SL boundary (kernel
  B1, :mod:`repro_torch.kernels.split_quant`), applied to each tensor.
  A tensor of rank >= 2 is quantized as ``reshape(-1, shape[-1])`` rows
  (conv leaves are HWIO, so a row runs along the output channels), a
  1-D or 0-D tensor as one row. On a CUDA tensor each leaf is one
  launch of the fused quantize-dequantize entry; on a CPU tensor it is
  the kernel's plain version. Both give the same bits.

In the paper's constellation these compress the ISL checkpoint-delta
payload (:mod:`repro_torch.isl.codec`).

Every scheme meters its wire payload exactly, from shapes alone:

* top-k: ``k * (value_bits + index_bits)`` per tensor, where
  ``index_bits = ceil(log2(numel))`` (the position of each survivor);
* int8: ``numel * 8 + scale_rows * 32`` per tensor (one f32 scale per
  quantized row);
* none: ``numel * value_bits`` (the dense f32 tensor).

:func:`payload_bits` takes tensors (meta tensors too) or anything with a
``shape``, and both compressors report the same number as
``compress_payload_bits`` in their metrics dict.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.train_state import _leaves, _rebuild
from repro_torch.kernels import split_quant

#: wire width of one kept value (the f32 payload of both schemes)
VALUE_BITS = 32
#: wire width of one int8 row scale (f32)
SCALE_BITS = 32

SCHEMES = ("none", "topk", "int8")


class ErrorFeedbackState(NamedTuple):
    residual: Any            # a tree shaped like the grads, f32


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, tuples,
    lists and NamedTuples of tensors), in ``jax.tree`` leaf order."""
    cols = zip(*[_leaves(t) for t in trees])
    return _rebuild(trees[0], iter([fn(*c) for c in cols]))


def ef_init(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


# ------------------------------------------------------- bit accounting

def _numel(leaf) -> int:
    return math.prod(int(d) for d in leaf.shape)


def index_bits(numel: int) -> int:
    """Bits to address one entry of a ``numel``-element tensor."""
    return max(1, math.ceil(math.log2(numel))) if numel > 1 else 1


def topk_payload_bits(tree, ratio: float, value_bits: int = VALUE_BITS
                      ) -> int:
    """Exact top-k wire bits: ``k * (value_bits + index_bits)`` per
    tensor, summed over the tree (shapes only)."""
    total = 0
    for leaf in _leaves(tree):
        n = _numel(leaf)
        k = max(1, int(n * ratio))
        total += k * (value_bits + index_bits(n))
    return total


def int8_payload_bits(tree, scale_bits: int = SCALE_BITS) -> int:
    """Exact int8-rows wire bits: ``numel * 8 + scale_rows * 32`` per
    tensor (tensors of rank < 2 are one row, as :func:`_int8_one`)."""
    total = 0
    for leaf in _leaves(tree):
        shape = tuple(leaf.shape)
        n = _numel(leaf)
        rows = (n // int(shape[-1])) if (len(shape) >= 2 and n) else 1
        total += n * 8 + rows * scale_bits
    return total


def payload_bits(tree, scheme: str = "none", *, topk_ratio: float = 0.01,
                 value_bits: int = VALUE_BITS) -> int:
    """Exact wire bits of one compressed tree under ``scheme``."""
    if scheme == "none":
        return sum(_numel(leaf) * value_bits for leaf in _leaves(tree))
    if scheme == "topk":
        return topk_payload_bits(tree, topk_ratio, value_bits)
    if scheme == "int8":
        return int8_payload_bits(tree)
    raise ValueError(scheme)


def _norms(kept, resid):
    kept_norm = torch.sqrt(sum(torch.sum(torch.square(x))
                               for x in _leaves(kept)))
    res_norm = torch.sqrt(sum(torch.sum(torch.square(x))
                              for x in _leaves(resid)))
    return kept_norm, res_norm


def _bits(n: int, like) -> torch.Tensor:
    """``n`` as an f32 tensor on ``like``'s device (a fill, not a copy)."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


# ------------------------------------------------------------- schemes

def _topk_one(g, ratio: float):
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    idx = torch.topk(flat.abs(), k).indices
    kept = torch.zeros_like(flat).index_copy(0, idx, flat[idx])
    return kept.reshape(g.shape)


def topk_compress(grads, ef: ErrorFeedbackState, *, ratio: float = 0.01
                  ) -> Tuple[Any, ErrorFeedbackState, dict]:
    """Returns (compressed_grads, new_ef, metrics)."""
    acc = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
    kept = tree_map(lambda a: _topk_one(a, ratio), acc)
    resid = tree_map(lambda a, kk: a - kk, acc, kept)
    kept_norm, res_norm = _norms(kept, resid)
    return kept, ErrorFeedbackState(resid), {
        "compress_kept_norm": kept_norm,
        "compress_residual_norm": res_norm,
        "compress_payload_bits": _bits(topk_payload_bits(grads, ratio),
                                       kept_norm)}


def _int8_one(g):
    """One leaf through B1: quantize-dequantize of its rows, f32, in the
    leaf's shape (one kernel launch on the card)."""
    x = g.float()
    x2 = x.reshape(1, -1) if x.dim() < 2 else x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = split_quant.quantize_dequantize_plain(x2)
    else:
        y = split_quant.quantize_dequantize(x2)
    return y.reshape(g.shape)


def int8_compress(grads, ef: ErrorFeedbackState
                  ) -> Tuple[Any, ErrorFeedbackState, dict]:
    """Returns (compressed_grads, new_ef, metrics), with the metrics of
    :func:`topk_compress` (kept and residual norms, exact payload bits)."""
    acc = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
    deq = tree_map(_int8_one, acc)
    resid = tree_map(lambda a, d: a - d, acc, deq)
    kept_norm, res_norm = _norms(deq, resid)
    return deq, ErrorFeedbackState(resid), {
        "compress_kept_norm": kept_norm,
        "compress_residual_norm": res_norm,
        "compress_payload_bits": _bits(int8_payload_bits(grads),
                                       kept_norm)}


def compress(grads, ef, *, scheme: str = "none", topk_ratio: float = 0.01):
    if scheme == "none":
        return grads, ef, {}
    if scheme == "topk":
        return topk_compress(grads, ef, ratio=topk_ratio)
    if scheme == "int8":
        return int8_compress(grads, ef)
    raise ValueError(scheme)
