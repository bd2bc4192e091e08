"""Revolution-level mission planning: batch problem (13) over the ring.

The paper's protocol is *cyclical* — every satellite in the ring trains
exactly once per revolution.  The :class:`RevolutionPlanner` exploits
the cycle structure: the N upcoming passes of one revolution are N
instances of (13) differing only in their per-satellite budgets and
boundary payloads, so ONE ``solve_with_shedding_batch`` call
(vectorized dual bisection + vectorized kept-fraction shedding,
core/resource_opt) pre-plans the whole revolution.

The plan is cached and reused across revolutions; it is invalidated
only when the inputs actually change:

* **membership change** — a satellite joins, leaves, or fails, so the
  ring (and with it d_ISL, the pass order, and possibly per-sat
  budgets) shifts;
* **boundary-shape change** — the measured boundary payload or the
  segment-A handoff size changes (different batch shape, different cut,
  quantization toggled), which alters the (13) coefficients.

Steady-state constellations therefore pay ZERO per-pass solves: the
planner's ``solve_calls`` counter shows one batched solve per plan
epoch, however many passes consume it.

The port's copy of ``repro/core/mission.py::RevolutionPlanner``; the
reference's on-device revolution sweeps come with the device engines.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional, Sequence, Tuple, Union

from repro_torch.core import resource_opt
from repro_torch.core.energy import PassBudget, SplitCosts


def _costs_key(c: SplitCosts) -> Tuple[float, float, float, float]:
    """Numeric identity of a cost instance (name changes don't replan)."""
    return (c.w1_flops, c.w2_flops, c.dtx_bits, c.d_isl_bits)


def _budget_key(b: PassBudget) -> Hashable:
    # PassBudget and all its components are frozen dataclasses, hence
    # hashable by value — the object itself is the cache key.
    return b


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One satellite's pre-solved allocation for its pass this revolution."""

    sat_id: int
    slot: int                                # position in the revolution
    shed: resource_opt.SheddingReport        # allocation (+ kept fraction)

    @property
    def allocation(self):
        return self.shed.report.allocation


class RevolutionPlanner:
    """Pre-solves problem (13) for a whole ring revolution at once.

    Usage (the constellation scheduler's flow)::

        planner = RevolutionPlanner()
        entry = planner.entry_for(sat_id, ring_ids, budget, costs)
        alloc = entry.allocation          # this pass's (f, p) allocation

    ``entry_for`` is cheap when the plan is warm; on a cold or
    invalidated cache it issues exactly one
    :func:`~repro_torch.core.resource_opt.solve_with_shedding_batch` call for
    every satellite in ``ring_ids`` (per-satellite budgets/costs as
    batch instances) and stores the entries.  ``solve_calls`` counts
    batched solves, ``invalidations`` counts cache drops — both are
    observable for tests and benchmarks.

    ``backend`` is handed to the batched solve (see
    :func:`~repro_torch.core.resource_opt.solve_batch`).
    """

    def __init__(self, backend: Optional[str] = None) -> None:
        self.backend = backend
        self.solve_calls = 0
        self.invalidations = 0
        self._key: Optional[Hashable] = None
        self._entries: Dict[int, PlanEntry] = {}

    # ----------------------------------------------------------- planning
    @staticmethod
    def _instances(ring: Sequence[int], budgets, costs):
        """Broadcast (budgets, costs) over the ring; returns the
        per-satellite instance lists and their canonical cache key."""
        blist, clist = resource_opt._broadcast_instances(budgets, costs)
        if len(blist) == 1:
            blist = blist * len(ring)
            clist = clist * len(ring)
        if len(blist) != len(ring):
            raise ValueError(f"{len(blist)} instances for {len(ring)} "
                             "satellites")
        key = (tuple(ring),
               tuple(_budget_key(b) for b in blist),
               tuple(_costs_key(c) for c in clist))
        return blist, clist, key

    def plan_revolution(self, ring_ids: Sequence[int],
                        budgets: Union[PassBudget, Sequence[PassBudget]],
                        costs: Union[SplitCosts, Sequence[SplitCosts]],
                        ) -> Dict[int, PlanEntry]:
        """Solve (13) for every satellite of the revolution in one batch.

        ``budgets``/``costs`` are broadcast against ``ring_ids`` the way
        :func:`solve_batch` broadcasts (a single object serves all
        satellites; a sequence gives each its own instance).  The cache
        key is updated to these instances, so a subsequent
        :meth:`entry_for` with matching inputs reuses this plan.
        """
        ring = list(ring_ids)
        if not ring:
            raise ValueError("cannot plan an empty ring")
        blist, clist, key = self._instances(ring, budgets, costs)
        shed = resource_opt.solve_with_shedding_batch(blist, clist,
                                                      backend=self.backend)
        self.solve_calls += 1
        self._entries = {sid: PlanEntry(sid, slot, shed.at(slot))
                         for slot, sid in enumerate(ring)}
        self._key = key
        return self._entries

    def entry_for(self, sat_id: int, ring_ids: Sequence[int],
                  budgets: Union[PassBudget, Sequence[PassBudget]],
                  costs: Union[SplitCosts, Sequence[SplitCosts]],
                  ) -> PlanEntry:
        """This pass's pre-solved entry; replans only on invalidation.

        ``budgets``/``costs`` may be a single object (broadcast ring-
        wide) or one instance per satellite of ``ring_ids``.  The cache
        key is (ring membership, per-satellite budget and cost
        signatures): joins/leaves/failures change the membership tuple,
        a batch-shape or handoff-size change alters a cost signature —
        anything else reuses the cached revolution plan.
        """
        _, _, key = self._instances(list(ring_ids), budgets, costs)
        if key != self._key:
            if self._key is not None:
                self.invalidations += 1
            self.plan_revolution(ring_ids, budgets, costs)
        entry = self._entries.get(sat_id)
        if entry is None:
            raise KeyError(f"satellite {sat_id} is not in the planned ring "
                           f"{sorted(self._entries)}")
        return entry

    # ---------------------------------------------------------- inspection
    @property
    def planned(self) -> bool:
        return self._key is not None

    def invalidate(self) -> None:
        """Drop the cached plan (next entry_for replans)."""
        if self._key is not None:
            self.invalidations += 1
        self._key = None
        self._entries = {}
