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

The port of ``repro/core/mission.py``: the :class:`RevolutionPlanner`
and the revolution sweeps on the device (:func:`sweep_revolutions`,
whose grid cells feed :class:`~repro_torch.sim.device_sim.
DeviceConstellationSim` through :meth:`RevolutionSweep.revolution_plan`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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

    ``backend`` and ``device`` are handed to the batched solve (see
    :func:`~repro_torch.core.resource_opt.solve_batch`).
    """

    def __init__(self, backend: Optional[str] = None, device=None) -> None:
        self.backend = backend
        self.device = device
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
        shed = resource_opt.solve_with_shedding_batch(
            blist, clist, backend=self.backend, device=self.device)
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


# --------------------------------------------------------------------------
# Revolution sweeps on the device: (ring size × cut point × item budget).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RevolutionSweep:
    """A planned (ring size × cut × budget) grid, resident on the device.

    Every tensor is float64 of shape (R, C, B): ring sizes × cut points ×
    item budgets. Nothing here has been read back to the host; call
    :meth:`to_host` once at the end.
    """

    ring_sizes: np.ndarray              # (R,) host metadata
    cut_names: Tuple[str, ...]          # (C,) host metadata
    n_items: np.ndarray                 # (B,) host metadata
    d_isl_bits: np.ndarray              # (C,) host metadata (handoff bits)
    e_pass: Any                         # (R,C,B) eq. (11) per pass [J]
    t_pass: Any                         # (R,C,B) eq. (12) per pass [s]
    kept_fraction: Any                  # (R,C,B) shedding outcome
    n_items_kept: Any                   # (R,C,B)
    feasible: Any                       # (R,C,B) bool (post-shedding)
    kkt_residual: Any                   # (R,C,B)
    phase_times: Any                    # (R,C,B,4) canonical phase order
    phase_energy: Any                   # (R,C,B,4) [J] same order
    e_isl: Any                          # (R,C,B) constant E_ISL term [J]
    e_revolution: Any                   # (R,C,B) ring size × e_pass
    best_cut: Any                       # (R,B) argmin-energy cut; -1 if
                                        # no cut is feasible in that cell

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.ring_sizes), len(self.cut_names),
                len(self.n_items))

    def steps_for(self, batch_size: int) -> torch.Tensor:
        """SL steps per grid cell, as a device int32 tensor."""
        steps = torch.ceil(self.n_items_kept / float(batch_size))
        return torch.clamp(steps, min=1.0).to(torch.int32)

    def revolution_plan(self, batch_size: int, *, ring: int = 0,
                        cut: Optional[int] = None, budget: int = 0,
                        max_steps_per_pass: Optional[int] = None):
        """One planned grid cell as a whole-revolution execution plan.

        Broadcasts cell ``(ring, cut, budget)`` over its ring's N slots
        into a :class:`~repro_torch.sim.device_sim.DevicePassPlan`
        (float32/int32 device tensors) that
        :class:`~repro_torch.sim.device_sim.DeviceConstellationSim`
        executes without re-solving. ``cut=None`` picks the cell's
        minimum-energy feasible cut (one host read). Every slot gets the
        same allocation; per-satellite plans come from
        :func:`repro_torch.sim.device_sim.plan_ring_passes`.
        """
        from repro_torch.core.resource_opt_torch import ArraySolveReport
        from repro_torch.sim.device_sim import plan_from_report

        n = int(self.ring_sizes[ring])
        if cut is None:
            cut = int(self.best_cut[ring, budget])
            if cut < 0:
                raise ValueError(
                    f"no feasible cut in sweep cell (ring={ring}, "
                    f"budget={budget}); pass cut= explicitly to plan an "
                    "infeasible allocation anyway")
        sel = (ring, cut, budget)
        bcast = lambda a: torch.broadcast_to(a[sel], (n,))   # noqa: E731
        pt = torch.broadcast_to(self.phase_times[sel], (n, 4))
        rep = ArraySolveReport(
            phase_times=pt,
            phase_energy=torch.broadcast_to(self.phase_energy[sel], (n, 4)),
            lam=torch.zeros_like(bcast(self.e_pass)),
            kkt_residual=bcast(self.kkt_residual),
            feasible=bcast(self.feasible), e_isl=bcast(self.e_isl),
            t_fixed=bcast(self.t_pass) - pt.sum(-1))
        return plan_from_report(
            rep, bcast(self.kept_fraction),
            torch.full((n,), float(self.n_items[budget]),
                       dtype=torch.float64, device=self.e_pass.device),
            float(self.d_isl_bits[cut]), batch_size, max_steps_per_pass)

    def fleet_plan(self, batch_size: int, n_planes: int, *, ring: int = 0,
                   cut: Optional[int] = None, budget: int = 0,
                   max_steps_per_pass: Optional[int] = None):
        """One planned grid cell as a P-plane fleet plan: the ``(N,)``
        plan of :meth:`revolution_plan` broadcast to the ``(P, N)``
        layout of :class:`repro_torch.fleet.FleetEngine`, so a swept grid
        drives a whole constellation without re-solving. Per-satellite
        fleet plans come from
        :func:`repro_torch.sim.device_sim.plan_ring_passes` with
        ``n_sats=(P, M)``."""
        plan = self.revolution_plan(batch_size, ring=ring, cut=cut,
                                    budget=budget,
                                    max_steps_per_pass=max_steps_per_pass)
        return type(plan)(*[torch.broadcast_to(a, (int(n_planes),)
                                               + tuple(a.shape))
                            for a in plan])

    def to_host(self) -> Dict[str, np.ndarray]:
        """One explicit device-to-host copy of every result tensor."""
        out = {"ring_sizes": self.ring_sizes, "n_items": self.n_items,
               "d_isl_bits": self.d_isl_bits}
        for f in ("e_pass", "t_pass", "kept_fraction", "n_items_kept",
                  "feasible", "kkt_residual", "phase_times",
                  "phase_energy", "e_isl", "e_revolution", "best_cut"):
            out[f] = getattr(self, f).cpu().numpy()
        return out


def sweep_revolutions(ring_sizes: Sequence[int],
                      costs: Sequence[SplitCosts],
                      n_items: Sequence[float],
                      *,
                      budget: Optional[PassBudget] = None,
                      dtx_bits=None,
                      min_fraction: float = 0.05,
                      tol: float = 1e-10,
                      max_iters: int = 80,
                      device="cuda") -> RevolutionSweep:
    """Plan a whole scenario grid on ``device`` (the card unless the
    caller asks for the CPU): coefficient grid, closed-form shedding and
    the float64 solve, with no host read.

    The grid is (ring size × cut point × item budget): ``ring_sizes``
    enter problem (13) through the ISL hop distance (eq. 5), ``costs``
    carry the candidate cuts and ``n_items`` the per-pass item budgets.
    ``budget`` is the scenario template (its ``n_items`` and the plane's
    ``n_sats`` are overridden by the grid axes); ``dtx_bits`` optionally
    replaces the cuts' boundary payloads with measured ones.
    """
    from repro_torch.core import resource_opt_torch as rot

    budget = PassBudget() if budget is None else budget
    costs = list(costs)
    ring = np.asarray(list(ring_sizes), dtype=np.int64)
    items = np.asarray(list(n_items), dtype=np.float64)
    if ring.size == 0 or not costs or items.size == 0:
        raise ValueError("sweep_revolutions needs non-empty ring_sizes, "
                         "costs and n_items axes")
    if np.any(ring < 1):
        raise ValueError("ring sizes must be >= 1 satellite")

    w1 = [c.w1_flops for c in costs]
    w2 = [c.w2_flops for c in costs]
    disl = [c.d_isl_bits for c in costs]
    dtx = [c.dtx_bits for c in costs] if dtx_bits is None else dtx_bits

    sc = rot.grid_scalars(budget.plane, budget.link, budget.isl,
                          budget.sat_device, budget.gs_device, device=device)
    rep, frac = rot.sweep_grid(sc, ring, w1, w2, dtx, disl, items,
                               min_fraction=min_fraction, tol=tol,
                               max_iters=max_iters)
    dev = sc.device
    e_pass = rep.e_total
    n_kept = frac * torch.as_tensor(items, device=dev)[None, None, :]
    e_rev = torch.as_tensor(ring, dtype=torch.float64,
                            device=dev)[:, None, None] * e_pass
    # -1 where even max shedding leaves every cut infeasible (an argmin
    # over all-inf would silently report cut 0)
    best_cut = torch.where(
        rep.feasible.any(dim=1),
        torch.argmin(torch.where(rep.feasible, e_pass, torch.inf), dim=1),
        -1).to(torch.int32)
    return RevolutionSweep(
        ring_sizes=ring, cut_names=tuple(c.name for c in costs),
        n_items=items, d_isl_bits=np.asarray(disl, dtype=np.float64),
        e_pass=e_pass, t_pass=rep.t_total, kept_fraction=frac,
        n_items_kept=n_kept, feasible=rep.feasible,
        kkt_residual=rep.kkt_residual, phase_times=rep.phase_times,
        phase_energy=rep.phase_energy, e_isl=rep.e_isl,
        e_revolution=e_rev, best_cut=best_cut)
