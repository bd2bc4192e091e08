"""`SLTrainState`: the one-object train state of the split-learning loop
(the port of ``repro/core/train_state.py``).

It bundles the two segment parameter trees, both optimizer states and a
step counter, with explicit semantics:

* ``create(params_a, params_b, optimizer)`` — a fresh state with
  optimizer state initialized for both segments;
* ``apply_updates(grads_a, grads_b, optimizer, where=None)`` — one
  optimizer step on both segments (+1 on the step counter), masked by
  a host bool or by a 0-d bool tensor decided on the device;
* ``replace(**kw)`` — a live copy with some fields replaced;
* consumption tracking. The reference donates the state's buffers to a
  fused pass; here ``apply_updates`` writes the new values into the
  state's tensors in place, so the state it was called on no longer
  holds what it held. It is marked *consumed*, and every later
  ``apply_updates``/``replace``/step/pass on it raises ``ValueError``
  instead of silently training from values that moved under it. Chain
  the returned state forward.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils.treeutil import tree_leaves


@dataclasses.dataclass
class SLTrainState:
    """Split-learning train state: both segments + optimizer + step."""

    params_a: Any                      # satellite segment weights
    params_b: Any                      # ground segment weights
    opt_a: Any                         # optimizer state for segment A
    opt_b: Any                         # optimizer state for segment B
    step: Any = 0                      # scalar int32 step counter (tensor)

    _consumed: bool = dataclasses.field(default=False, init=False,
                                        repr=False, compare=False)
    # one flat buffer per dtype whose views are the leaves (see packed())
    _flat: Any = dataclasses.field(default=None, init=False, repr=False,
                                   compare=False)

    # ------------------------------------------------------ construction
    @classmethod
    def create(cls, params_a, params_b, optimizer) -> "SLTrainState":
        """Fresh state with ``optimizer.init`` run on both segments."""
        dev = tree_leaves(params_a)[0].device
        return cls(params_a=params_a, params_b=params_b,
                   opt_a=optimizer.init(params_a),
                   opt_b=optimizer.init(params_b),
                   step=torch.zeros((), dtype=torch.int32, device=dev))

    # --------------------------------------------------------- semantics
    @property
    def consumed(self) -> bool:
        return self._consumed

    def _require_live(self, op: str) -> None:
        if self._consumed:
            raise ValueError(
                f"SLTrainState.{op}: this state was consumed (its tensors "
                "were updated in place by a step or a pass); use the state "
                "returned by that call instead")

    def mark_consumed(self) -> None:
        """Engine hook: flag this state after an engine took it over."""
        self._consumed = True

    def replace(self, **kw) -> "SLTrainState":
        """Functional update; the returned state is live."""
        self._require_live("replace")
        return dataclasses.replace(self, **kw)

    def _fields(self):
        return [self.params_a, self.params_b, self.opt_a, self.opt_b,
                self.step]

    def packed(self) -> "SLTrainState":
        """A live copy whose leaves are views of one flat buffer per dtype
        (so a select over every leaf is one ``torch.where``); marks this
        state consumed."""
        self._require_live("packed")
        fields = self._fields()
        leaves = _leaves(fields)
        groups, out, flat = {}, list(leaves), {}
        for i, t in enumerate(leaves):
            groups.setdefault(t.dtype, []).append(i)
        for dt, idx in groups.items():
            flat[dt] = torch.cat([leaves[i].reshape(-1) for i in idx])
            parts = flat[dt].split([leaves[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view(leaves[i].shape)
        new = SLTrainState(*_rebuild(fields, iter(out)))
        new._flat = flat
        self._consumed = True
        return new

    def apply_updates(self, grads_a, grads_b, optimizer,
                      where=None) -> "SLTrainState":
        """One optimizer step on both segments, in place; returns the
        live state and marks this one consumed.

        ``where`` masks the update. A Python ``False`` returns this state
        as it is, live, with params, optimizer state AND step counter
        untouched. A 0-d bool tensor (the device engine's masked steps,
        decided on the device) never reads the host: the state is
        :meth:`packed` (once; later states keep the buffers), the flat
        buffers are copied, the update runs, and ``torch.where`` selects
        between the updated buffers and the copies, so a masked step
        leaves every bit of params, optimizer state (momentum, Adam
        moments, their step) and step counter as it was. A select, not a
        multiply: a multiply by a 0/1 mask would not restore the
        momentum's decay or a NaN. Leaves the optimizer replaces instead
        of writing in place (the step counters) are selected one by one;
        the optimizers here write every other leaf in place.
        """
        self._require_live("apply_updates")
        if where is not None and not isinstance(where, torch.Tensor):
            if not where:
                return self
            where = None
        if where is not None and self._flat is None:
            return self.packed().apply_updates(grads_a, grads_b, optimizer,
                                               where)
        old = _leaves(self._fields())
        snap = None if where is None else \
            {dt: f.clone() for dt, f in self._flat.items()}
        pa, oa, _ = optimizer.update(grads_a, self.opt_a, self.params_a)
        pb, ob, _ = optimizer.update(grads_b, self.opt_b, self.params_b)
        self._consumed = True
        new = [pa, pb, oa, ob, self.step + 1]
        if where is not None:
            for dt, f in self._flat.items():
                torch.where(where, f, snap[dt], out=f)
            new = _rebuild(new, iter([
                n if n is o else torch.where(where, n, o)
                for o, n in zip(old, _leaves(new))]))
        state = SLTrainState(*new)
        state._flat = self._flat
        return state


def _leaves(tree):
    """Tensor leaves of dicts, tuples and NamedTuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(like, it):
    """A tree shaped like ``like`` (NamedTuple types kept) from ``it``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, list):
        return [_rebuild(t, it) for t in like]
    if isinstance(like, tuple):
        items = [_rebuild(t, it) for t in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else tuple(items)
    return next(it)
