"""Parameter specs, seeded init and the converter to and from the JAX
reference's parameter trees.

A model defines a nested dict of :class:`ParamSpec` (``abstract_params``);
:func:`init_params` materializes it from a ``torch.Generator``. The init
rules are the reference's (``repro/models/param.py``): ``normal`` draws
N(0, 1) x 1/sqrt(fan_in), ``embed`` N(0, 1) x 0.02, ``ones`` and
``zeros`` are constants. The draws differ from ``jax.random``'s, so tests
that compare the two packages convert the reference's weights with
:func:`from_jax_params` instead of seeding both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"                     # normal|zeros|ones|embed
    scale: Optional[float] = None            # None => 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32


def map_tree(f: Callable[[Any], Any], tree):
    """Apply ``f`` to every leaf of a tree of dicts and tuples: dict keys
    in sorted order, tuple items in order (the order ``jax.tree``
    flattens them in)."""
    if isinstance(tree, dict):
        return {k: map_tree(f, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(map_tree(f, t) for t in tree)
    return f(tree)


def init_params(tree, generator: torch.Generator):
    """Materialize a ParamSpec tree on ``generator.device``, leaves drawn
    in sorted-key order from the one generator."""
    device = generator.device

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        if spec.init == "embed":
            scale = spec.scale if spec.scale is not None else 0.02
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(spec.dtype)

    return map_tree(make, tree)


def from_jax_params(tree, device="cpu"):
    """The reference's parameter tree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) as the port's tree of tensors.
    The two packages share the tree layout, so this is a leafwise copy."""
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def to_jax_params(tree):
    """Inverse of :func:`from_jax_params`: numpy leaves on the host."""
    return map_tree(lambda t: t.detach().cpu().numpy(), tree)
