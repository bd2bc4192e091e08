"""Optimizers from scratch: SGD-momentum and AdamW (the port of
``repro/train/optimizer.py``).

Two layers, as in the reference:

* raw functions (``sgd_init``/``sgd_update``, ``adamw_init``/
  ``adamw_update``) — the reference's arithmetic;
* the :class:`Optimizer` protocol — a uniform ``(init, update)`` pair
  the SL pass engine and the constellation scheduler program against,
  so SGD and AdamW (with its warmup+cosine lr schedule) are
  interchangeable through ``ConstellationConfig.optimizer``.

Parameters and optimizer states are nested dicts of tensors. Where the
reference returns new arrays, ``update`` here writes the new values
into the given parameter and state tensors in place (one
``torch._foreach_*`` call per operation over all leaves) and returns
them; callers that need the old values copy them first
(:meth:`repro_torch.core.train_state.SLTrainState.apply_updates`). The
step counters and the learning rate stay on the parameters' device, so
an update never waits for the device.

On a ``(data, model)`` mesh, :func:`zero_adamw_update` holds mu and nu
as :func:`adamw_state_specs` says (ZeRO over ``data``, the reference's
``zero_axis_for``) and gives the same arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models.param import (ParamSpec, ShardingRules, map_tree,
                                      mesh_axes, spec_names)
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay (standard LM schedule)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _zeros_like_tree(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _step0(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(grads):
    leaves = [g.float() for g in tree_leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm`` as f32
    leaves in a new tree, the global norm before clipping)."""
    gn = global_norm(grads)
    scaled = torch._foreach_mul([g.float() for g in tree_leaves(grads)],
                                _clip_scale(gn, max_norm))
    return tree_unflatten(grads, scaled), gn


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    return AdamWState(step=_step0(params), mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Updates ``params`` and ``state`` in place; returns
    (params, new_state, metrics)."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step, lr = _adamw_apply(cfg, tree_leaves(grads), state, tree_leaves(params))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gn, "lr": lr}


def _adamw_apply(cfg: AdamWConfig, g, state: AdamWState, p):
    """AdamW's arithmetic on the leaves ``g`` (clipped f32 gradients) and
    ``p`` (the parameters, or the slices of them this rank updates), and
    on ``state``'s mu and nu, in place; returns (step, lr)."""
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    m, v = tree_leaves(state.mu), tree_leaves(state.nu)

    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                             cfg.eps)
    delta = torch._foreach_add(
        torch._foreach_div(torch._foreach_div(m, bc1), den),
        torch._foreach_mul([t.float() for t in p], cfg.weight_decay))
    # in place, computed in f32 and stored in the parameter's dtype
    torch._foreach_sub_(p, torch._foreach_mul(delta, lr))
    return step, lr


def zero_adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                      place, mesh):
    """AdamW on a ``(data, model)`` mesh, with mu and nu held as their ZeRO
    spec says (:func:`adamw_state_specs`).

    ``grads`` are reduced over ``data`` already
    (:func:`repro_torch.models.parallel.reduce_grads`): this rank's slice
    of each ZeRO-cut leaf, the whole local gradient of the others. The
    clip takes the global norm of the whole gradient
    (:func:`repro_torch.models.parallel.global_norm`); each data rank
    updates its slice of each parameter in place and the slices are
    all-gathered over ``data``. The arithmetic is :func:`adamw_update`'s.
    Returns (params, new_state, metrics)."""
    from repro_torch.models import parallel as par

    gn = par.global_norm(grads, place, mesh)
    g = torch._foreach_mul([t.float() for t in tree_leaves(grads)],
                           _clip_scale(gn, cfg.grad_clip))
    p = [t if l.zdim is None else par.zero_slice(t, l.zdim, mesh)
         for t, l in zip(tree_leaves(params), tree_leaves(place))]
    step, lr = _adamw_apply(cfg, g, state, p)
    par.gather_zero_slices(params, place, mesh)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gn, "lr": lr}


# --------------------------------------------------------------------------
# SGD with momentum (used by the SL constellation scheduler; the paper's
# "online learning" loop uses plain first-order updates).
# --------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd_init(params) -> SGDState:
    return SGDState(_step0(params), _zeros_like_tree(params))


def sgd_update(grads, state: SGDState, params, *, lr=1e-2, beta=0.9,
               grad_clip=1.0):
    """Updates ``params`` and ``state`` in place; returns
    (params, new_state, metrics)."""
    grads, gn = clip_by_global_norm(grads, grad_clip)
    mom = tree_leaves(state.momentum)
    torch._foreach_mul_(mom, beta)
    torch._foreach_add_(mom, tree_leaves(grads))
    torch._foreach_sub_(tree_leaves(params), torch._foreach_mul(mom, lr))
    return params, SGDState(state.step + 1, state.momentum), {"grad_norm": gn}


# --------------------------------------------------------------------------
# The Optimizer protocol: a uniform (init, update) pair.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Pluggable optimizer: ``init(params) -> state`` plus
    ``update(grads, state, params) -> (params, new_state, metrics)``,
    which updates ``params`` and the tensors of ``state`` in place.
    All hyperparameters (lr, schedules, clipping) are closed over at
    construction."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any, Dict[str, Any]]]


def sgd(lr: float = 1e-2, beta: float = 0.9,
        grad_clip: float = 1.0) -> Optimizer:
    """SGD-momentum as an :class:`Optimizer` (the paper's online loop)."""

    def update(grads, state, params):
        return sgd_update(grads, state, params, lr=lr, beta=beta,
                          grad_clip=grad_clip)

    return Optimizer("sgd", sgd_init, update)


def adamw(cfg: Optional[AdamWConfig] = None, **overrides) -> Optimizer:
    """AdamW (incl. the warmup+cosine lr schedule) as an Optimizer.

    ``overrides`` patch individual :class:`AdamWConfig` fields, e.g.
    ``adamw(lr=3e-4, warmup_steps=50)``.
    """
    cfg = dataclasses.replace(cfg or AdamWConfig(), **overrides)

    def update(grads, state, params):
        return adamw_update(cfg, grads, state, params)

    return Optimizer("adamw", adamw_init, update)


_OPTIMIZER_FACTORIES: Dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd,
    "adamw": adamw,
}


def resolve_optimizer(spec: Union[str, Optimizer, None],
                      **defaults) -> Optimizer:
    """Turn ``"sgd"`` / ``"adamw"`` / an Optimizer instance into one.

    ``defaults`` (e.g. ``lr=...``, ``grad_clip=...``) feed the factory
    when ``spec`` is a name; an explicit Optimizer instance wins as-is.
    """
    if spec is None:
        spec = "sgd"
    if isinstance(spec, Optimizer):
        return spec
    try:
        factory = _OPTIMIZER_FACTORIES[spec]
    except KeyError:
        raise ValueError(
            f"unknown optimizer {spec!r}; expected one of "
            f"{sorted(_OPTIMIZER_FACTORIES)} or an Optimizer instance")
    return factory(**defaults)


# --------------------------------------------------------------------------
# ZeRO sharding of optimizer state (the reference's, spec for spec).
# --------------------------------------------------------------------------

def zero_axis_for(spec: ParamSpec, rules: ShardingRules, mesh,
                  base: Optional[Tuple] = None) -> Tuple:
    """The spec of the optimizer-state copy of ``spec``: the parameter's
    spec (``base``; the reference's resolve by default) with ``rules.zero``
    added on the largest dim that spec leaves unpartitioned and the
    axis divides. Where none qualifies, or the zero axis is in use, the
    state is held like the parameter (partitioning tiny norms costs more
    in collectives than it saves)."""
    if base is None:
        base = rules.resolve(spec.axes, mesh, spec.shape)
    sizes = mesh_axes(mesh)
    zaxis = rules.zero
    if isinstance(zaxis, str):
        zaxis = (zaxis,)
    zaxis = tuple(a for a in (zaxis or ()) if a in sizes)
    if not zaxis:
        return base
    taken = set()
    for e in base:
        taken.update(spec_names(e))
    if set(zaxis) & taken:
        return base
    extent = math.prod(sizes[a] for a in zaxis)
    order = sorted(range(len(spec.shape)), key=lambda i: -spec.shape[i])
    for i in order:
        if (base[i] is None and spec.shape[i] % extent == 0
                and spec.shape[i] >= extent):
            parts = list(base)
            parts[i] = zaxis[0] if len(zaxis) == 1 else zaxis
            return tuple(parts)
    return base


def zero_partition_specs(abstract_tree, rules: ShardingRules, mesh):
    """The spec tree of optimizer state (mu, nu). Its leaves are tuples:
    walk the ParamSpec tree, not this one, with ``map_tree``."""
    return map_tree(lambda s: zero_axis_for(s, rules, mesh), abstract_tree)


def adamw_state_specs(abstract_tree, rules: ShardingRules, mesh):
    zspec = zero_partition_specs(abstract_tree, rules, mesh)
    return AdamWState(step=(), mu=zspec, nu=zspec)
