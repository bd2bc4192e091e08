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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models.param import map_tree
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
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    scaled = torch._foreach_mul([g.float() for g in tree_leaves(grads)],
                                scale)
    return tree_unflatten(grads, scaled), gn


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
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    g, m, v = tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
    p = tree_leaves(params)

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
