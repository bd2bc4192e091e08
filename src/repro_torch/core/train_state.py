"""`SLTrainState`: the one-object train state of the split-learning loop
(the port of ``repro/core/train_state.py``).

It bundles the two segment parameter trees, both optimizer states and a
step counter, with explicit semantics:

* ``create(params_a, params_b, optimizer)`` — a fresh state with
  optimizer state initialized for both segments;
* ``apply_updates(grads_a, grads_b, optimizer, where=None)`` — one
  optimizer step on both segments (+1 on the step counter);
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

    def replace(self, **kw) -> "SLTrainState":
        """Functional update; the returned state is live."""
        self._require_live("replace")
        return dataclasses.replace(self, **kw)

    def apply_updates(self, grads_a, grads_b, optimizer,
                      where=None) -> "SLTrainState":
        """One optimizer step on both segments, in place; returns the
        live state and marks this one consumed.

        ``where=False`` masks the update: this state is returned as it
        is, live, with params, optimizer state AND step counter
        untouched (the reference's masked scan steps; the port's pass
        engine runs only valid steps, so its mask is a host bool).
        """
        self._require_live("apply_updates")
        if where is not None and not where:
            return self
        pa, oa, _ = optimizer.update(grads_a, self.opt_a, self.params_a)
        pb, ob, _ = optimizer.update(grads_b, self.opt_b, self.params_b)
        self._consumed = True
        return SLTrainState(params_a=pa, params_b=pb, opt_a=oa, opt_b=ob,
                            step=self.step + 1)
