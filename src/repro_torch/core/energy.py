"""Per-pass energy / latency assembly — paper eqs. (11)-(12).

A :class:`PassBudget` bundles everything that is *fixed* during one
satellite pass (split plan, link distances, device specs); the decision
variables of problem (13) enter as the four per-phase *times*
``(t_proc_sat, t_comm_down, t_proc_gs, t_comm_up)`` in the convex
time-domain reformulation (DESIGN.md §3), or equivalently as the raw
``(f_leo, f_gs, p_leo, p_gs)`` of the paper.

Phase naming follows Fig. 1/2 of the paper with the first split on the
satellite:

  sat-forward  (E_proc at LEO, W1)          ── downlink activations D_tx
  gs-forward+backward (E_proc at GS, W2)    ── uplink boundary grads D_tx
  sat-backward (folded into W1 by the FLOPs accounting of splitting.py)
  ISL handoff of segment-A weights D_ISL    (fixed-rate link, eq. 10)

The paper's eq. (11) has exactly one E_proc and one E_comm per side plus
E_ISL; we keep that structure: ``W1`` already contains forward+backward
work of segment A and ``D_tx`` is transmitted twice (activations down,
gradients up), matching the paper's symmetric-payload assumption
("with the same size assumed for the gradients in the uplink").
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.compute_model import DeviceComputeSpec, PAPER_DEVICE
from repro_torch.core.linkbudget import ISLConfig, LinkConfig, PAPER_GS_LINK, PAPER_ISL
from repro_torch.core.orbits import OrbitalPlane, PAPER_PLANE


def clamp_battery(battery, capacity_j):
    """THE battery clamp: charge lives in ``[0, capacity_j]``.

    The single battery policy of the port: scalar floats (the host
    scheduler, :mod:`repro_torch.core.constellation`) return a plain
    float, tensors are clamped with ``torch.clamp``. A pass whose
    allocation would overdraw the battery leaves it empty, not negative
    (the energy *accounting* still records the full eq.-(11) cost);
    solar recharge never exceeds capacity.
    """
    if isinstance(battery, (float, int)):
        return min(max(float(battery), 0.0), float(capacity_j))
    import torch

    return torch.clamp(battery, 0.0, capacity_j)


def solar_recharge_j(recharge_w: float, duration_s: float,
                     sunlit: bool = True) -> float:
    """Energy harvested between passes: panel power × pass duration,
    exactly 0 J while the plane is in eclipse.

    It adds either the full ``recharge_w * duration_s`` or a literal
    0.0 before clamping, so an eclipse window never perturbs the battery
    by a rounding step. Which passes are eclipsed is decided by the
    caller (``ConstellationConfig.eclipse``).
    """
    return float(recharge_w) * float(duration_s) * (1.0 if sunlit else 0.0)


@dataclasses.dataclass(frozen=True)
class SplitCosts:
    """The four orbit-aware cost terms of a split plan at one cut point.

    ``w1_flops``/``w2_flops`` are *per item* (fvcore convention, eq. 6);
    ``dtx_bits`` is the boundary payload per item in ONE direction
    (the paper assumes the gradient payload equals the activation
    payload); ``d_isl_bits`` is the segment-A parameter payload shipped
    once per pass over the ISL.
    """

    w1_flops: float          # satellite segment, fwd+bwd FLOPs per item
    w2_flops: float          # ground segment, fwd+bwd FLOPs per item
    dtx_bits: float          # boundary activation bits per item (one way)
    d_isl_bits: float        # segment-A weights in bits (per pass)
    name: str = "split"

    def scaled_boundary(self, factor: float) -> "SplitCosts":
        """Boundary compression (e.g. int8 => factor 0.25) — beyond-paper."""
        return dataclasses.replace(self, dtx_bits=self.dtx_bits * factor,
                                   name=f"{self.name}+q{factor:g}")


@dataclasses.dataclass(frozen=True)
class PassBudget:
    """Everything fixed during one satellite pass (problem 13 constants)."""

    plane: OrbitalPlane = PAPER_PLANE
    link: LinkConfig = PAPER_GS_LINK
    isl: ISLConfig = PAPER_ISL
    sat_device: DeviceComputeSpec = PAPER_DEVICE
    gs_device: DeviceComputeSpec = PAPER_DEVICE
    n_items: float = 400.0            # images processed per pass (Table I)

    @property
    def mean_distance_m(self) -> float:
        return self.plane.mean_slant_range_m()

    @property
    def t_prop_s(self) -> float:
        """One-way GS<->LEO propagation delay at mean distance."""
        return self.plane.mean_prop_delay_s

    def fixed_overhead_s(self, costs: SplitCosts) -> float:
        """Time not controlled by (f, p): 2×propagation + ISL transfer.

        eq. (12): T_prop appears twice (activations down, gradients up);
        the ISL handoff runs at a fixed rate so it is a constant too.
        """
        return 2.0 * self.t_prop_s + self.isl.time_s(costs.d_isl_bits) \
            + self.plane.isl_prop_delay_s

    def time_budget_s(self, costs: SplitCosts) -> float:
        """T_budget = T_pass − fixed overhead, available to the 4 phases."""
        return self.plane.pass_duration_s - self.fixed_overhead_s(costs)

    def isl_energy_j(self, costs: SplitCosts) -> float:
        return self.isl.energy_j(costs.d_isl_bits)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A solution of problem (13): per-phase times + implied (f, p)."""

    t_proc_sat: float
    t_comm_down: float       # boundary activations, LEO -> GS
    t_proc_gs: float
    t_comm_up: float         # boundary gradients,   GS -> LEO
    f_sat_hz: float
    f_gs_hz: float
    p_down_w: float
    p_up_w: float
    e_proc_sat: float
    e_comm_down: float
    e_proc_gs: float
    e_comm_up: float
    e_isl: float
    t_fixed: float
    feasible: bool = True

    @property
    def e_total(self) -> float:
        """eq. (11)."""
        return (self.e_proc_sat + self.e_comm_down + self.e_proc_gs
                + self.e_comm_up + self.e_isl)

    @property
    def t_total(self) -> float:
        """eq. (12)."""
        return (self.t_proc_sat + self.t_comm_down + self.t_proc_gs
                + self.t_comm_up + self.t_fixed)

    def summary(self) -> dict:
        return {
            "feasible": self.feasible,
            "E_total_J": self.e_total,
            "T_total_s": self.t_total,
            "E_proc_J": self.e_proc_sat + self.e_proc_gs,
            "E_comm_J": self.e_comm_down + self.e_comm_up + self.e_isl,
            "f_sat_MHz": self.f_sat_hz / 1e6,
            "f_gs_MHz": self.f_gs_hz / 1e6,
            "p_down_W": self.p_down_w,
            "p_up_W": self.p_up_w,
        }


def evaluate_raw(budget: PassBudget, costs: SplitCosts,
                 f_sat_hz: float, f_gs_hz: float,
                 p_down_w: float, p_up_w: float) -> Allocation:
    """Evaluate eqs. (11)-(12) for raw decision variables (paper form).

    Each D_tx payload is ``n_items * dtx_bits`` (the whole batch crosses
    the boundary once per pass in each direction).
    """
    n = budget.n_items
    d = budget.mean_distance_m
    down_bits = n * costs.dtx_bits
    up_bits = n * costs.dtx_bits

    t_ps = budget.sat_device.proc_time_s(costs.w1_flops, f_sat_hz, n)
    t_pg = budget.gs_device.proc_time_s(costs.w2_flops, f_gs_hz, n)
    t_cd = budget.link.comm_time_s(down_bits, p_down_w, d) if down_bits else 0.0
    t_cu = budget.link.comm_time_s(up_bits, p_up_w, d) if up_bits else 0.0

    return Allocation(
        t_proc_sat=t_ps, t_comm_down=t_cd, t_proc_gs=t_pg, t_comm_up=t_cu,
        f_sat_hz=f_sat_hz, f_gs_hz=f_gs_hz, p_down_w=p_down_w, p_up_w=p_up_w,
        e_proc_sat=budget.sat_device.proc_energy_j(costs.w1_flops, f_sat_hz, n),
        e_comm_down=budget.link.comm_energy_j(down_bits, p_down_w, d) if down_bits else 0.0,
        e_proc_gs=budget.gs_device.proc_energy_j(costs.w2_flops, f_gs_hz, n),
        e_comm_up=budget.link.comm_energy_j(up_bits, p_up_w, d) if up_bits else 0.0,
        e_isl=budget.isl_energy_j(costs),
        t_fixed=budget.fixed_overhead_s(costs),
        feasible=True,
    )


def allocation_from_times(budget: PassBudget, costs: SplitCosts,
                          t_proc_sat: float, t_comm_down: float,
                          t_proc_gs: float, t_comm_up: float,
                          feasible: bool = True) -> Allocation:
    """Build an Allocation from the time-domain variables (solver output)."""
    n = budget.n_items
    d = budget.mean_distance_m
    down_bits = n * costs.dtx_bits
    up_bits = n * costs.dtx_bits

    def _f(dev: DeviceComputeSpec, w: float, t: float) -> float:
        return dev.freq_for_time(w, t, n) if w > 0 else 0.0

    def _p(bits: float, t: float) -> float:
        return budget.link.power_for_time(bits, t, d) if bits > 0 else 0.0

    f_sat = _f(budget.sat_device, costs.w1_flops, t_proc_sat)
    f_gs = _f(budget.gs_device, costs.w2_flops, t_proc_gs)
    p_down = _p(down_bits, t_comm_down)
    p_up = _p(up_bits, t_comm_up)

    return Allocation(
        t_proc_sat=t_proc_sat if costs.w1_flops > 0 else 0.0,
        t_comm_down=t_comm_down if down_bits > 0 else 0.0,
        t_proc_gs=t_proc_gs if costs.w2_flops > 0 else 0.0,
        t_comm_up=t_comm_up if up_bits > 0 else 0.0,
        f_sat_hz=f_sat, f_gs_hz=f_gs, p_down_w=p_down, p_up_w=p_up,
        e_proc_sat=budget.sat_device.energy_for_time(costs.w1_flops, t_proc_sat, n),
        e_comm_down=budget.link.energy_for_time(down_bits, t_comm_down, d) if down_bits > 0 else 0.0,
        e_proc_gs=budget.gs_device.energy_for_time(costs.w2_flops, t_proc_gs, n),
        e_comm_up=budget.link.energy_for_time(up_bits, t_comm_up, d) if up_bits > 0 else 0.0,
        e_isl=budget.isl_energy_j(costs),
        t_fixed=budget.fixed_overhead_s(costs),
        feasible=feasible,
    )


def direct_download_costs(raw_bits_per_item: float, total_work_flops: float,
                          name: str = "direct-download") -> SplitCosts:
    """Fig. 3 (top) baseline: no split — raw data down, all compute on GS.

    W1 = 0 (satellite does no model work), D_tx = raw image bits, no ISL
    handoff (there is no on-sat model segment to move).  The gradient
    uplink payload is 0 in this baseline; we model that by halving via
    a dedicated flag — instead we simply fold it: direct download sends
    raw data one way only, so we encode dtx as *half* the round payload.
    To keep eq. (11) structure (which charges dtx twice), we pass
    dtx_bits = raw/2 so the total transmitted volume equals raw.
    """
    return SplitCosts(w1_flops=0.0, w2_flops=total_work_flops,
                      dtx_bits=raw_bits_per_item / 2.0, d_isl_bits=0.0,
                      name=name)
