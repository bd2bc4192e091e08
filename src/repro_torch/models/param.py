"""Parameter specs, seeded init, the logical-to-mesh sharding rules and
the converter to and from the JAX reference's parameter trees.

A model defines a nested dict of :class:`ParamSpec` (``abstract_params``);
:func:`init_params` materializes it from a ``torch.Generator``. The init
rules are the reference's (``repro/models/param.py``): ``normal`` draws
N(0, 1) x 1/sqrt(fan_in), ``embed`` N(0, 1) x 0.02, ``ones`` and
``zeros`` are constants. The draws differ from ``jax.random``'s, so tests
that compare the two packages convert the reference's weights with
:func:`from_jax_params` instead of seeding both.

Sharding. Each spec names a logical axis per dim (``axes``, the
reference's names: batch seq embed mlp heads kv_heads head_dim vocab
experts layers conv_k inner state unit frontend); :class:`ShardingRules`
maps them to mesh axes. A spec here is a tuple with one entry per dim:
None (replicated), a mesh axis name, or a tuple of names: the contents
of the reference's ``PartitionSpec``. :func:`partition_specs` is the
reference's. The port's train step holds each parameter by the same
rules resolved over whole blocks (``ParamSpec.view``,
:func:`repro_torch.models.parallel.placement`), so a shard never cuts
an attention head or pairs one rank's gate with another's up
projection. :func:`local_shard` cuts a rank's piece of a full tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A parameter's shape, logical axis per dim, init and dtype.

    ``view`` (the port's own field) says, per dim, how a shard cuts it:
    None cuts the dim into equal contiguous pieces; ``(groups, blocks,
    size)`` views the dim as ``groups`` x ``blocks`` x ``size`` and gives
    each shard ``blocks / n`` whole blocks of every group. Attention's
    projections cut ``(1, heads, head_dim)``; SwiGLU's ``wi``, whose
    last dim holds the gate's ``f`` columns then the up projection's,
    cuts ``(2, f, 1)``."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal|zeros|ones|embed
    scale: Optional[float] = None            # None => 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32
    view: Optional[Tuple[Optional[Tuple[int, int, int]], ...]] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        if self.view is not None:
            assert len(self.view) == len(self.shape), (self.shape, self.view)
            for n, v in zip(self.shape, self.view):
                assert v is None or math.prod(v) == n, (self.shape, self.view)

    @property
    def blocks(self) -> Tuple[int, ...]:
        """Per dim, the count of pieces a shard may not cut."""
        if self.view is None:
            return self.shape
        return tuple(n if v is None else v[1]
                     for n, v in zip(self.shape, self.view))


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


# --------------------------------------------------------------------------
# Logical -> mesh sharding rules.
# --------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, of a plain ``{name: size}``,
    or of an object with the reference's ``axis_names`` and
    ``devices.shape`` (a JAX mesh, or its tests' fake one)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis names: every field and default
    of the reference's. Values may be a mesh-axis name, a tuple of names,
    or None (replicate). ``resolve`` drops axes that are absent from the
    mesh, so one rule set serves both the (data, model) and (pod, data,
    model) meshes."""

    batch: Any = ("pod", "data")
    seq: Any = None                  # sequence sharding (activations only)
    embed: Any = None
    mlp: Any = "model"
    heads: Any = "model"
    kv_heads: Any = "model"
    head_dim: Any = None
    vocab: Any = "model"
    experts: Any = None              # expert-parallel axis
    inner: Any = "model"             # mamba/mlstm inner channels
    state: Any = None
    layers: Any = None
    unit: Any = None
    conv_k: Any = None
    frontend: Any = None
    zero: Any = "data"               # optimizer-state (ZeRO) sharding axis

    def lookup(self, logical: Optional[str]) -> Any:
        if logical is None:
            return None
        return getattr(self, logical)

    def resolve(self, axes: Sequence[Optional[str]], mesh,
                shape: Optional[Sequence[int]] = None) -> Tuple:
        """The spec of a tuple of logical axes against a mesh (a
        ``DeviceMesh`` or ``{name: size}``). With ``shape``, axes whose
        mesh extent does not divide the dim are dropped (15 heads on a
        16-way model axis, Granite's 49,155-row vocab): the dim stays
        replicated. A mesh axis serves at most one dim, first come first
        served."""
        sizes = mesh_axes(mesh)
        used = set()
        out = []
        for i, ax in enumerate(axes):
            phys = self.lookup(ax)
            if phys is None:
                out.append(None)
                continue
            if isinstance(phys, str):
                phys = (phys,)
            keep = tuple(p for p in phys if p in sizes and p not in used)
            if shape is not None and keep:
                if shape[i] % math.prod(sizes[p] for p in keep) != 0:
                    keep = ()
            used.update(keep)
            if len(keep) == 0:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(keep)
        return tuple(out)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def partition_specs(tree, rules: ShardingRules, mesh):
    """The reference's specs: each leaf's axes resolved on its shape. The
    leaves are tuples, so walk the ParamSpec tree, not this one, with
    ``map_tree`` (which descends into tuples)."""
    return map_tree(lambda s: rules.resolve(s.axes, mesh, s.shape), tree)


def spec_names(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _piece(entry, coords: Dict[str, Tuple[int, int]]) -> Tuple[int, int]:
    """(index, count) of this rank's piece of a dim whose entry is
    ``entry``, the first named axis the major one."""
    idx, count = 0, 1
    for name in spec_names(entry):
        i, n = coords[name]
        idx, count = idx * n + i, count * n
    return idx, count


def local_shard(t: torch.Tensor, spec, coords: Dict[str, Tuple[int, int]],
                view=None) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` under ``spec``, a new
    contiguous tensor. ``coords`` maps each mesh axis to (this rank's
    index, the axis size); ``view`` is the leaf's ``ParamSpec.view``."""
    for d, entry in enumerate(spec):
        idx, count = _piece(entry, coords)
        if count == 1:
            continue
        v = None if view is None else view[d]
        if v is None:
            n = t.shape[d] // count
            t = t.narrow(d, idx * n, n)
        else:
            groups, blocks, size = v
            n = blocks // count
            t = t.unflatten(d, (groups, blocks, size)).narrow(
                d + 1, idx * n, n).flatten(d, d + 2)
    return t.clone(memory_format=torch.contiguous_format)
