"""The orbital-ring scheduler: cyclical SL training across N satellites
(the port of ``repro/core/constellation.py``, host engine).

Implements the paper's time-window protocol end to end, planned at
*revolution* granularity:

  revolution r: the ring's N upcoming passes are pre-solved as ONE
    batched problem-(13) instance set (core/mission.RevolutionPlanner
    -> resource_opt.solve_with_shedding_batch). The plan is cached; it
    is invalidated only by a membership change (join/leave/failure) or
    a boundary-shape change, so a steady-state revolution costs zero
    solves.

  pass k: satellite s = ring[k mod N] is visible for T_pass seconds.
    1. resource allocation: consume this pass's pre-solved planner
       entry; shedding is already folded in. The boundary payload is
       measured shape-only (sl_step.boundary_bits), no probe step.
    2. run the allocated SL train steps (core/sl_step.make_sl_pass) on
       the satellite's local non-IID shard; the SLTrainState (both
       segments + optimizer states + step counter) is updated in place
       on the sim's device (the card unless the caller asks for the
       CPU). With ``quantize_boundary`` every step runs the int8
       boundary quantizer twice (z down, dz up).
    3. account energy per eq. (11) with the *measured* boundary payloads.
    4. hand segment A to the next satellite over the ISL — an
       integrity-checked checkpoint (ckpt.save_handoff), so the handoff
       doubles as the fault-tolerance point.

Fault / policy model:
  * per-satellite battery with solar recharge; below reserve => skip
    pass (ground trains nothing; segment forwarded unchanged);
  * random satellite failure (``fail_prob``, drawn from
    ``np.random.default_rng(seed)`` as the reference draws it, so
    failures land on the same passes) => the ring skips it; the
    successor restores the last handoff checkpoint;
  * elastic membership: join/leave events re-size the ring between
    passes and invalidate the cached revolution plan;
  * recharge is membership-aware and eclipse-gated: a satellite
    collects solar recharge exactly for the passes it was a ring member
    of, and 0 J on an eclipsed pass.

``run(engine="device")`` — the reference's device-resident engines
(``repro.sim.device_sim``, ``repro.fleet``) — is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import ckpt, resolve_device
from repro_torch.core.energy import (PassBudget, SplitCosts, clamp_battery,
                                     solar_recharge_j)
from repro_torch.core.mission import RevolutionPlanner
from repro_torch.core.sl_step import (SplitAdapter, make_boundary_meter,
                                      make_sl_pass)
from repro_torch.core.train_state import SLTrainState
from repro_torch.fleet.events import leave_ids
from repro_torch.train.optimizer import Optimizer, resolve_optimizer
from repro_torch.utils.treeutil import tree_bytes


@dataclasses.dataclass
class SatelliteState:
    sat_id: int
    battery_j: float
    alive: bool = True
    passes_served: int = 0
    energy_spent_j: float = 0.0
    joined_pass: int = 0              # first pass this sat was a ring member


@dataclasses.dataclass
class PassRecord:
    pass_idx: int
    sat_id: int
    action: str                       # trained | skipped_energy | failed | shed
    loss: Optional[float] = None
    kept_fraction: float = 1.0
    e_total_j: float = 0.0
    e_proc_j: float = 0.0
    e_comm_j: float = 0.0
    e_isl_j: float = 0.0
    t_total_s: float = 0.0
    d_isl_bits: float = 0.0
    n_items: float = 0.0
    battery_j: float = 0.0            # serving sat's battery at pass end
                                      # (post-drain, post-recharge)


@dataclasses.dataclass
class ConstellationConfig:
    n_passes: int = 25
    lr: float = 1e-2
    # "sgd" | "adamw" | an Optimizer instance (train/optimizer.py); a
    # name is resolved with lr=cfg.lr
    optimizer: Union[str, Optimizer] = "sgd"
    quantize_boundary: bool = False
    battery_j: float = 5_000.0
    recharge_w: float = 20.0             # solar recharge between passes
    reserve_j: float = 100.0             # skip threshold
    fail_prob: float = 0.0
    # battery charge (as a fraction of battery_j) a joining satellite
    # arrives with
    join_battery_frac: float = 1.0
    seed: int = 0
    handoff_dir: Optional[str] = None    # persist handoffs (fault tolerance)
    join_events: Dict[int, int] = dataclasses.field(default_factory=dict)
    # pass -> satellite id(s) leaving at that pass: a single int or a
    # sequence of ids (multi-leave churn), resolved ``sid % len(sats)``
    leave_events: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # orbital shadow windows gating solar recharge: any object with a
    # ``sunlit(pass_idx, plane)`` method; None = permanent sunlight
    eclipse: Optional[Any] = None
    # Simulation-cost ceiling on steps per pass: the allocation itself
    # is uncapped (problem 13 decides the item budget); this bounds how
    # many of those steps the simulator executes. None = run them all,
    # in pass_chunk_steps-sized pieces (host batches stay bounded).
    max_steps_per_pass: Optional[int] = 128
    pass_chunk_steps: int = 256          # batches materialized at once
    # problem-(13) solver backend for the revolution planner: None,
    # "auto" or "numpy" ("jax" raises: not ported)
    solver_backend: Optional[str] = None


class ConstellationSim:
    """Round-robin online SL over the orbital ring, training a real model.

    ``data_for_sat(sat_id, batch_idx) -> batch`` (a dict of NumPy arrays
    or tensors) MUST be pure: the scheduler *peeks* each ring member's
    upcoming batch once to meter its boundary payload for the revolution
    plan. ``ImageryShards.batch_at`` satisfies this.

    The items per pass come from ``budget.n_items`` (Table I: 400) and
    the batch shape from the data; the reference's config fields
    ``items_per_pass`` and ``batch_size``, which nothing reads, are not
    ported.

    ``device`` is where the model trains: ``"cuda"`` by default (raises
    without a card); pass ``"cpu"`` to run the plain path. The initial
    weights are drawn from ``torch.Generator(device).manual_seed(seed)``;
    to start from other weights, assign ``sim.state`` after construction.
    """

    def __init__(self, adapter: SplitAdapter, budget: PassBudget,
                 data_for_sat: Callable[[int, int], Dict],
                 cfg: Optional[ConstellationConfig] = None,
                 device="cuda"):
        # default built per-instance: a shared ConstellationConfig() default
        # would alias its mutable join_events/leave_events dicts across sims
        cfg = ConstellationConfig() if cfg is None else cfg
        self.device = resolve_device(device)
        self.adapter = adapter
        self.budget = budget
        self.cfg = cfg
        self.data_for_sat = data_for_sat
        self.rng = np.random.default_rng(cfg.seed)

        self.optimizer = resolve_optimizer(cfg.optimizer, lr=cfg.lr)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        pa, pb = adapter.init(gen)
        self.state = SLTrainState.create(pa, pb, self.optimizer)
        self.sl_pass = make_sl_pass(adapter,
                                    quantize_boundary=cfg.quantize_boundary,
                                    optimizer=self.optimizer)
        self.planner = RevolutionPlanner(backend=cfg.solver_backend)

        n = budget.plane.n_sats
        self.sats: List[SatelliteState] = [
            SatelliteState(i, cfg.battery_j) for i in range(n)]
        self.records: List[PassRecord] = []
        self._batch_idx = 0
        self._boundary_bits = make_boundary_meter(
            adapter, quantize_boundary=cfg.quantize_boundary)
        # last measured costs per satellite: the planner batch carries one
        # instance per ring member
        self._sat_costs: Dict[int, SplitCosts] = {}

    # ------------------------------------------------------------- internals
    def _ring(self) -> List[SatelliteState]:
        return [s for s in self.sats if s.alive]

    def _measured_costs(self, dtx_bits_per_item: float) -> SplitCosts:
        base = self.adapter.costs()
        d_isl = 8.0 * tree_bytes(self.state.params_a)  # measured handoff bytes
        return dataclasses.replace(base, dtx_bits=dtx_bits_per_item,
                                   d_isl_bits=d_isl)

    def _costs_for(self, sat_id: int) -> SplitCosts:
        """This satellite's measured costs; first use peeks its shard."""
        costs = self._sat_costs.get(sat_id)
        if costs is None:
            batch = self.data_for_sat(sat_id, self._batch_idx)
            n = next(iter(batch.values())).shape[0]
            costs = self._measured_costs(self._boundary_bits(batch) / n)
            self._sat_costs[sat_id] = costs
        return costs

    def _solve_pass(self, sat_id: int, costs: SplitCosts):
        """This pass's allocation, consumed from the revolution plan."""
        self._sat_costs[sat_id] = costs
        ring_ids = tuple(s.sat_id for s in self._ring())
        ring_costs = [self._costs_for(s) for s in ring_ids]
        return self.planner.entry_for(sat_id, ring_ids, self.budget,
                                      ring_costs).shed

    # ------------------------------------------------------------------ run
    def run(self, engine: str = "host") -> List[PassRecord]:
        """Run the configured passes on the host scheduler.

        ``engine="device"`` (the reference's device-resident engines)
        raises ``NotImplementedError``: those engines are the next slice
        of the port (ROADMAP queue A).
        """
        if engine == "device":
            raise NotImplementedError(
                "engine='device' is not ported yet (the device-resident "
                "engines, sim/ and fleet/, are next in ROADMAP queue A); "
                "use engine='host'")
        if engine != "host":
            raise ValueError(f"unknown engine {engine!r}; expected "
                             "'host' or 'device'")
        cfg = self.cfg
        for k in range(cfg.n_passes):
            # elastic membership
            if k in cfg.join_events:
                for _ in range(cfg.join_events[k]):
                    self.sats.append(SatelliteState(
                        len(self.sats),
                        clamp_battery(cfg.battery_j
                                      * cfg.join_battery_frac,
                                      cfg.battery_j),
                        joined_pass=k))
            if k in cfg.leave_events:
                for sid in leave_ids(cfg.leave_events[k]):
                    self.sats[sid % len(self.sats)].alive = False

            # the ring that serves pass k — recharge accounting below is
            # against THIS snapshot
            ring = self._ring()
            sat = ring[k % len(ring)]
            rec = self._run_pass(k, sat)
            self.records.append(rec)
            # solar recharge between passes, for this pass's members only
            # (a sat that failed mid-pass is dead: no recharge either;
            # an eclipsed pass harvests exactly 0 J)
            sunlit = cfg.eclipse is None or bool(cfg.eclipse.sunlit(k, 0))
            gain = solar_recharge_j(cfg.recharge_w,
                                    self.budget.plane.pass_duration_s,
                                    sunlit)
            for s in ring:
                if s.alive:
                    s.battery_j = clamp_battery(s.battery_j + gain,
                                                cfg.battery_j)
            rec.battery_j = sat.battery_j
        return self.records

    def _run_pass(self, k: int, sat: SatelliteState) -> PassRecord:
        cfg = self.cfg

        # random failure: the ring continues; handoff checkpoint survives
        if self.rng.random() < cfg.fail_prob:
            sat.alive = False
            if cfg.handoff_dir is not None:
                try:
                    restored, _, _ = ckpt.restore_handoff(
                        cfg.handoff_dir, self.state.params_a)
                    self.state = self.state.replace(params_a=restored)
                except FileNotFoundError:
                    pass        # failed before the first handoff: keep init
            return PassRecord(k, sat.sat_id, "failed")

        # energy policy: skip the pass, forward the segment unchanged
        if sat.battery_j < cfg.reserve_j:
            self._handoff(k)
            return PassRecord(k, sat.sat_id, "skipped_energy",
                              d_isl_bits=8.0 * tree_bytes(
                                  self.state.params_a))

        # measure the true boundary payload shape-only (no probe step)
        batch = self.data_for_sat(sat.sat_id, self._batch_idx)
        n_in_batch = next(iter(batch.values())).shape[0]
        dtx_per_item = self._boundary_bits(batch) / n_in_batch

        costs = self._measured_costs(dtx_per_item)
        shed = self._solve_pass(sat.sat_id, costs)
        alloc = shed.report.allocation
        n_items = shed.n_items_kept
        n_steps = max(1, int(round(n_items / n_in_batch)))
        if cfg.max_steps_per_pass is not None:
            n_steps = min(n_steps, cfg.max_steps_per_pass)

        # the pass in chunks, so host batches stay bounded even for
        # uncapped shedding-scale passes
        loss_parts = []
        start = 0
        while start < n_steps:
            m = min(max(cfg.pass_chunk_steps, 1), n_steps - start)
            batches = [batch if start + j == 0 else
                       self.data_for_sat(sat.sat_id,
                                         self._batch_idx + start + j)
                       for j in range(m)]
            res = self.sl_pass(self.state, batches)
            self.state = res.state
            loss_parts.append(res.losses)
            start += m
        losses = torch.cat(loss_parts).double().cpu().numpy()
        self._batch_idx += n_steps

        e = alloc.e_total
        # the one battery policy: charge floors at 0 — an overdrawn pass
        # leaves the battery empty, the energy *accounting* still records
        # the full eq.-(11) cost
        sat.battery_j = clamp_battery(
            sat.battery_j - (alloc.e_proc_sat + alloc.e_comm_down
                             + alloc.e_isl), cfg.battery_j)
        sat.energy_spent_j += e
        sat.passes_served += 1
        self._handoff(k)

        return PassRecord(
            k, sat.sat_id,
            "shed" if shed.kept_fraction < 1.0 else "trained",
            loss=float(np.mean(losses)), kept_fraction=shed.kept_fraction,
            e_total_j=e,
            e_proc_j=alloc.e_proc_sat + alloc.e_proc_gs,
            e_comm_j=alloc.e_comm_down + alloc.e_comm_up,
            e_isl_j=alloc.e_isl, t_total_s=alloc.t_total,
            d_isl_bits=costs.d_isl_bits, n_items=n_items)

    def _handoff(self, k: int):
        """Ship segment A to the successor (checkpoint == ISL payload)."""
        if self.cfg.handoff_dir is not None:
            ckpt.save_handoff(self.cfg.handoff_dir, k, self.state.params_a,
                              meta={"pass": k})

    def as_device_sim(self, n_revolutions: Optional[int] = None):
        """The reference's bridge to its device engine: not ported yet."""
        raise NotImplementedError(
            "as_device_sim: the device-resident engines (sim/, fleet/) are "
            "next in ROADMAP queue A")

    # ------------------------------------------------------------- reporting
    def summary(self) -> Dict[str, Any]:
        recs = self.records
        trained = [r for r in recs if r.action in ("trained", "shed")]
        return {
            "passes": len(recs),
            "trained": len(trained),
            "skipped": sum(r.action == "skipped_energy" for r in recs),
            "failed": sum(r.action == "failed" for r in recs),
            "faulted": sum(r.action == "faulted" for r in recs),
            "loss_first": trained[0].loss if trained else None,
            "loss_last": trained[-1].loss if trained else None,
            "E_total_J": sum(r.e_total_j for r in recs),
            "E_comm_J": sum(r.e_comm_j for r in recs),
            "E_proc_J": sum(r.e_proc_j for r in recs),
            "E_isl_J": sum(r.e_isl_j for r in recs),
        }
