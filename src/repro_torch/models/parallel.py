"""Tensor and data parallelism over a ``(data, model)`` mesh of
``torch.distributed`` ranks: what the reference leaves to pjit.

The reference places parameters by :class:`~repro_torch.models.param.
ShardingRules` and lets XLA insert the collectives. Here each rank holds
the shard its placement spec gives (:func:`placement`), the layers call
the collectives of Megatron-style tensor parallelism themselves, and the
train step reduces the gradients over ``data``:

* :func:`copy_to_model` (identity forward, all-reduce backward) where a
  replicated activation enters column-split weights, and
  :func:`reduce_from_model` (all-reduce forward, identity backward)
  where row-split weights leave them: attention over the rank's heads,
  the dense MLP over its slice of ``d_ff``;
* a vocab-parallel embedding lookup and cross-entropy (global max and
  sum of exp by all-reduce, the label's logit by a masked gather and an
  all-reduce) when ``vocab`` is sharded;
* the loss's sum and token count all-reduced over ``data``, so its mean
  is over the global batch; the gradients all-reduced over ``data``, or
  reduce-scattered where ZeRO owns a slice of the optimizer state;
* :func:`global_norm`, which counts every element once.

A dim whose mesh extent does not divide its blocks replicates (SmolLM-
360M's 15 heads on 2 ranks, Granite's 49,155-row vocab): those layers
run whole on every model rank with no collective. So do all layers on a
model axis of one rank, which cuts nothing; and a data axis of one
cuts no optimizer state (ZeRO's slice would be the whole shard, reached
through copies). A ``(1, 1)`` mesh runs the sharded step all the same,
with groups of one: the loss and the gradients summed over ``data``, the
global norm over the world. Every collective goes through
:func:`_collective`, which counts it in :data:`COLLECTIVES`.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.param import (local_shard, map_tree, mesh_axes,
                                      spec_names)
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten

# calls of each collective since the caller last cleared it
COLLECTIVES: collections.Counter = collections.Counter()


def _collective(kind: str, fn, *args, **kw):
    COLLECTIVES[kind] += 1
    fn(*args, **kw)


def coords(mesh) -> Dict[str, Tuple[int, int]]:
    """{axis: (this rank's index, the axis size)}."""
    return {name: (mesh.get_local_rank(name), size)
            for name, size in mesh_axes(mesh).items()}


def all_reduce(t: torch.Tensor, mesh, axis: Optional[str] = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``axis`` (every rank if None)."""
    _collective("all_reduce", dist.all_reduce, t, op=op,
                group=None if axis is None else mesh.get_group(axis))
    return t


def _contig(t):
    return t.clone(memory_format=torch.contiguous_format)


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over an axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_contig(g), ctx.mesh, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward over an axis, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(_contig(x), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x, mesh):
    """A replicated activation entering column-split weights: each model
    rank's gradient of it is partial, so the backward sums them."""
    return _Copy.apply(x, mesh, "model")


def reduce_from_model(x, mesh):
    """The partial outputs of row-split weights, summed over ``model``."""
    return _Reduce.apply(x, mesh, "model")


def reduce_from_data(x, mesh):
    """A data rank's partial sum (the loss's), summed over ``data``; each
    rank's backward is that of its own part."""
    return _Reduce.apply(x, mesh, "data")


# --------------------------------------------------------------------------
# What a layer holds.
# --------------------------------------------------------------------------

def model_split(ctx, axis: str, blocks: int) -> Optional[Tuple[int, int]]:
    """(this rank's index, the model axis size) when the logical ``axis``
    of ``blocks`` whole blocks is cut over ``model`` under ``ctx.rules``;
    None when it replicates, when the model axis has one rank (it cuts
    nothing, so the layer runs whole and needs no collective), or when
    there is no mesh."""
    if ctx.mesh is None or mesh_axes(ctx.mesh).get("model", 1) == 1:
        return None
    entry = ctx.rules.resolve((axis,), ctx.mesh, (blocks,))[0]
    if entry is None:
        return None
    if entry != "model":
        raise NotImplementedError(f"{axis!r} on mesh axes {entry!r}: the "
                                  f"port shards layers over 'model' only")
    return ctx.mesh.get_local_rank("model"), mesh_axes(ctx.mesh)["model"]


def local_heads(ctx, H: int, KV: int):
    """None when attention runs whole on this rank; else (local q heads,
    local KV heads, the KV heads to take from replicated ``wk``/``wv``,
    or None when they hold this rank's KV heads already). Rank ``r``
    holds q heads ``[r H/m, (r+1) H/m)``; q head ``h`` reads KV head
    ``h // (H / KV)``. Where ``kv_heads`` replicate (KV % m != 0) the
    rank takes the KV heads its q heads read: one when its heads lie in
    one group, else one per q head (B2 then runs as MHA)."""
    q = model_split(ctx, "heads", H)
    kv = model_split(ctx, "kv_heads", KV)
    if q is None:
        if kv is not None:
            raise NotImplementedError("kv_heads sharded while heads "
                                      "replicate")
        return None
    r, m = q
    hl = H // m
    if kv is not None:
        return hl, KV // m, None
    g, first = H // KV, r * hl
    if hl % g == 0:
        sel = list(range(first // g, first // g + hl // g))
    elif g % hl == 0:
        sel = [first // g]
    else:
        sel = [h // g for h in range(first, first + hl)]
    return hl, len(sel), sel


def take_kv_heads(w, sel, dh: int, mesh):
    """The columns of KV heads ``sel`` of a replicated ``wk``/``wv`` (d,
    KV*dh). Each model rank uses a part of the weight, so its gradient
    is summed over ``model``, and every rank then holds the whole one.
    Slices, not an index tensor: no host-to-card copy a call."""
    w = copy_to_model(w, mesh)
    return torch.cat([w[:, h * dh:(h + 1) * dh] for h in sel], dim=1)


# --------------------------------------------------------------------------
# Vocab parallelism.
# --------------------------------------------------------------------------

def embed_lookup(table, tokens, mesh, split):
    """Rows ``tokens`` of the vocab-sharded embedding: this rank's rows
    ``[r n, (r+1) n)`` looked up, the others zero, summed over
    ``model``."""
    r, _ = split
    n = table.shape[0]
    local = tokens - r * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0), mesh)


class _VocabLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of vocab-sharded logits: the global max
    and the sum of exp by all-reduce, in ``torch.logsumexp``'s order of
    operations, with its backward ``g * exp(x - lse)``."""

    @staticmethod
    def forward(ctx, x, mesh):
        mx = all_reduce(x.amax(-1), mesh, "model", dist.ReduceOp.MAX)
        mx.masked_fill_(mx.abs() == float("inf"), 0)
        s = all_reduce((x - mx[..., None]).exp().sum(-1), mesh, "model")
        lse = s.log_().add_(mx)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None


class _VocabPick(torch.autograd.Function):
    """The logit of each label from vocab-sharded logits: the rank that
    holds the label's column gathers it, the others give zero, summed
    over ``model``; the backward scatters into this rank's columns."""

    @staticmethod
    def forward(ctx, x, labels, lo, mesh):
        n = x.shape[-1]
        local = labels - lo
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        ll = torch.where(inside, x.gather(-1, idx)[..., 0], 0.0)
        ctx.save_for_backward(idx, inside)
        ctx.shape = x.shape
        return all_reduce(ll, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        gx = g.new_zeros(ctx.shape).scatter_add_(
            -1, idx, torch.where(inside, g, 0.0)[..., None])
        return gx, None, None, None


def vocab_logsumexp(logits, mesh):
    return _VocabLogSumExp.apply(logits, mesh)


def vocab_pick(logits, labels, split, mesh):
    """``logits.gather(-1, labels)`` over the whole vocab, from this
    rank's columns ``[r n, (r+1) n)``."""
    return _VocabPick.apply(logits, labels, split[0] * logits.shape[-1], mesh)


# --------------------------------------------------------------------------
# Placement, gradient reduction and the checkpoint's gather.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where one parameter lives: its placement spec (entries None or
    ``"model"``), its ``ParamSpec.view``, the spec of its optimizer state
    (``zspec``: the placement with the ZeRO axis added), and the dim that
    state is cut over ``data``, or None where it is held whole (no ZeRO
    axis, or a data axis of one rank)."""

    spec: Tuple
    view: Optional[Tuple]
    zspec: Tuple
    zdim: Optional[int]

    @property
    def model_sharded(self) -> bool:
        return "model" in self.spec


def placement(abstract, rules, mesh):
    """A tree of :class:`Leaf` shaped like the ParamSpec tree. The
    placement spec is the leaf's axes resolved on its whole blocks
    (``ParamSpec.blocks``): it differs from the reference's
    ``partition_specs`` only where that cuts a block (SmolLM-360M's 960
    query columns split in two cut its 15 heads, which a head-parallel
    step cannot run, so they replicate). The ZeRO spec is
    :func:`repro_torch.train.optimizer.zero_axis_for`'s, taken on it; its
    dim is cut only where the data axis has more than one rank."""
    from repro_torch.train.optimizer import zero_axis_for
    data = mesh_axes(mesh).get("data", 1)

    def leaf(s):
        base = rules.resolve(s.axes, mesh, s.blocks)
        if any(e not in (None, "model") for e in base):
            raise NotImplementedError(f"placement {base} of {s.axes}: the "
                                      f"port shards parameters over 'model'")
        zspec = zero_axis_for(s, rules, mesh, base=base)
        zdims = [d for d, (a, b) in enumerate(zip(base, zspec)) if a != b]
        if zdims and spec_names(zspec[zdims[0]]) != ("data",):
            raise NotImplementedError(f"ZeRO over {zspec[zdims[0]]}: the "
                                      f"port cuts optimizer state over "
                                      f"'data'")
        return Leaf(base, s.view, zspec,
                    zdims[0] if zdims and data > 1 else None)

    return map_tree(leaf, abstract)


def shard_tree(full, place, mesh, zero: bool = False):
    """Each leaf of ``full`` cut to this rank's piece: its placement, and
    with ``zero`` also its ZeRO slice over ``data``."""
    c = coords(mesh)

    def cut(t, leaf):
        t = local_shard(t, leaf.spec, c, leaf.view)
        if zero and leaf.zdim is not None:
            t = zero_slice(t, leaf.zdim, mesh).clone(
                memory_format=torch.contiguous_format)
        return t

    return tree_unflatten(full, [cut(t, l) for t, l in
                                 zip(tree_leaves(full), tree_leaves(place))])


def zero_slice(t, zdim: int, mesh):
    """This data rank's slice of ``t`` along ``zdim`` (a view)."""
    r, n = coords(mesh)["data"]
    k = t.shape[zdim] // n
    return t.narrow(zdim, r * k, k)


def reduce_grads(grads, place, mesh):
    """Each gradient summed over ``data``: all-reduced where its state
    replicates over ``data``, reduce-scattered to this rank's slice
    where ZeRO owns one."""
    out = []
    for g, leaf in zip(tree_leaves(grads), tree_leaves(place)):
        if leaf.zdim is None:
            out.append(all_reduce(g, mesh, "data"))
            continue
        src = g.movedim(leaf.zdim, 0).contiguous()
        dst = src.new_empty((src.shape[0] // mesh_axes(mesh)["data"],)
                            + src.shape[1:])
        _collective("reduce_scatter", dist.reduce_scatter_tensor, dst, src,
                    group=mesh.get_group("data"))
        # in the parameter's memory order: a norm sums in memory order
        out.append(dst.movedim(0, leaf.zdim).contiguous())
    return tree_unflatten(grads, out)


def _all_gather(t, dim: int, mesh, axis: str):
    """The pieces of ``t`` on every rank of ``axis``, concatenated in rank
    order along ``dim``."""
    src = t.movedim(dim, 0).contiguous()
    dst = src.new_empty((src.shape[0] * mesh_axes(mesh)[axis],)
                        + src.shape[1:])
    _collective("all_gather", dist.all_gather_into_tensor, dst, src,
                group=mesh.get_group(axis))
    return dst.movedim(0, dim)


def gather_zero_slices(params, place, mesh):
    """Each data rank's updated slice of every ZeRO-cut parameter copied
    into the whole local parameter on every data rank."""
    for p, leaf in zip(tree_leaves(params), tree_leaves(place)):
        if leaf.zdim is not None:
            p.copy_(_all_gather(zero_slice(p, leaf.zdim, mesh), leaf.zdim,
                                mesh, "data"))


def gather_full(t, leaf: Leaf, mesh, zero: bool = False):
    """The whole tensor from every rank's piece (the inverse of
    :func:`shard_tree`), on every rank."""
    if zero and leaf.zdim is not None:
        t = _all_gather(t, leaf.zdim, mesh, "data")
    for d, entry in enumerate(leaf.spec):
        if entry != "model" or mesh_axes(mesh)["model"] == 1:
            continue
        v = None if leaf.view is None else leaf.view[d]
        if v is None:
            t = _all_gather(t, d, mesh, "model")
        else:                  # each rank's blocks of every group, in order
            groups, _, size = v
            t = _all_gather(t.unflatten(d, (groups, -1, size)), d + 1, mesh,
                            "model").flatten(d, d + 2)
    return t


def global_norm(grads, place, mesh):
    """The l2 norm of the whole gradient from each rank's pieces, every
    element counted once: a piece counts on every rank where it is cut
    (over ``model`` by its spec, over ``data`` by ZeRO), and on rank 0
    of the axis where it replicates. Per-leaf norms, squared, summed
    over the world and square-rooted, then the norm of those, so one
    rank gives ``optimizer.global_norm``'s value."""
    c = coords(mesh)
    counted = [float((l.model_sharded or c["model"][0] == 0)
                     and (l.zdim is not None or c["data"][0] == 0))
               for l in tree_leaves(place)]    # host scalars: no copy a step
    norms = torch._foreach_norm([g.float() for g in tree_leaves(grads)])
    sq = torch._foreach_mul(torch._foreach_mul(norms, norms), counted)
    return torch.linalg.vector_norm(all_reduce(torch.stack(sq), mesh).sqrt())


def check_supported(cfg, mesh, compression: str = "none"):
    """Raise NotImplementedError for what this port does not run on a
    mesh of more than one rank: MoE (its Switch aux and dispatch capacity
    depend on the whole batch), gradient compression, and on a model
    axis above 1 every block kind but ``attn``, Whisper's encoder and the
    vision prefix."""
    sizes = mesh_axes(mesh)
    world = 1
    for n in sizes.values():
        world *= n
    if world == 1:
        return
    kinds = set(cfg.pattern_unit())
    if "moe" in kinds:
        raise NotImplementedError(f"{cfg.name}: MoE on a mesh of {world} "
                                  f"ranks (the aux and the capacity need "
                                  f"the whole batch)")
    if compression != "none":
        raise NotImplementedError(f"--compression {compression} on a mesh "
                                  f"of {world} ranks")
    if sizes.get("model", 1) == 1:
        return
    other = sorted(kinds - {"attn"})
    if other:
        raise NotImplementedError(f"{cfg.name}: block kinds {other} on a "
                                  f"model axis of {sizes['model']}")
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: Whisper's encoder on a "
                                  f"model axis of {sizes['model']}")
    if cfg.frontend == "vision":
        raise NotImplementedError(f"{cfg.name}: the vision prefix on a "
                                  f"model axis of {sizes['model']}")
