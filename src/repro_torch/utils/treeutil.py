"""Helpers over the port's parameter and cache trees: nested dicts and
tuples of tensors, dicts walked in sorted-key order and tuples in order
(the order ``jax.tree`` flattens them in, so names and leaf order match
the reference's). A tuple item's name is its index."""
from __future__ import annotations

from typing import List, Tuple

import torch


def tree_flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted_name, leaf) pairs of a tree, in ``jax.tree`` order."""
    if isinstance(tree, (dict, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        out = []
        for k in keys:
            out += tree_flatten_with_names(tree[k], f"{prefix}.{k}" if prefix
                                           else str(k))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_bytes(tree) -> int:
    """Bytes held by the tree's tensors (the ISL handoff payload)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, tuple):
        return tuple(_build(t, it) for t in node)
    return next(it)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in the order of
    :func:`tree_leaves`). A module-level builder, not a recursive
    closure: a closure that calls itself is a reference cycle, which
    would keep ``leaves`` (a step's gradients) alive until the cyclic
    GC runs."""
    return _build(like, iter(leaves))
