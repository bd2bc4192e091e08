"""Processing model — paper eqs. (6)-(7).

``T_proc(W, f_p) = n_items * W / (N_c * N_FLOPS * f_p)`` and the cubic
CPU power law ``P(f) = P_p * (f/f_max)^3`` give

``E_proc(W, f_p) = n_items * W * P_p * f_p^2 / (N_c * N_FLOPS * f_max^3)``.

Units erratum (DESIGN.md §6): the paper calls the multiplier ``D`` "the
input size (e.g. pixels)" but every §V numeric result requires it to be the
*number of data items processed per pass* (400 images); ``W`` is FLOPs per
item (fvcore convention). We name it ``n_items``.

The port's copy of ``repro/core/compute_model.py`` (Table I's device).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DeviceComputeSpec:
    """A DVFS-capable processor (Table I "Computing" block)."""

    name: str = "paper-device"
    power_max_w: float = 15.0          # P_p: power at f_max
    f_max_hz: float = 625e6            # maximum clock
    n_cores: int = 1024                # N_c
    flops_per_cycle: float = 2.0       # N_FLOPS

    @property
    def peak_flops(self) -> float:
        return self.n_cores * self.flops_per_cycle * self.f_max_hz

    # --- eq. (6) ---------------------------------------------------------
    def proc_time_s(self, work_flops: float, f_hz: float, n_items: float = 1.0) -> float:
        if work_flops <= 0:
            return 0.0
        if f_hz <= 0:
            return math.inf
        return n_items * work_flops / (self.n_cores * self.flops_per_cycle * f_hz)

    # --- eq. (7) ---------------------------------------------------------
    def proc_energy_j(self, work_flops: float, f_hz: float, n_items: float = 1.0) -> float:
        return (
            n_items
            * work_flops
            * self.power_max_w
            * f_hz**2
            / (self.n_cores * self.flops_per_cycle * self.f_max_hz**3)
        )

    # --- time-domain form used by the convex solver ------------------------
    def min_proc_time_s(self, work_flops: float, n_items: float = 1.0) -> float:
        return self.proc_time_s(work_flops, self.f_max_hz, n_items)

    def freq_for_time(self, work_flops: float, t_s: float, n_items: float = 1.0) -> float:
        if work_flops <= 0:
            return 0.0
        if t_s <= 0:
            return math.inf
        return n_items * work_flops / (self.n_cores * self.flops_per_cycle * t_s)

    def energy_for_time(self, work_flops: float, t_s: float, n_items: float = 1.0) -> float:
        """E(t) = k / t^2 with k = P_p/f_max^3 * (n*W/(N_c*N_F))^3: convex, decreasing."""
        if work_flops <= 0:
            return 0.0
        nw = n_items * work_flops / (self.n_cores * self.flops_per_cycle)
        k = self.power_max_w / self.f_max_hz**3 * nw**3
        if k == 0.0:                    # sub-normal work: no meaningful phase
            return 0.0
        if t_s <= 0:
            return math.inf
        return k / (t_s * t_s)


# Table I device (used for both GS and LEO in the paper's evaluation).
PAPER_DEVICE = DeviceComputeSpec()

# The card the port runs on, in the model's terms: an H100 SXM at its
# 700 W limit and 1.98 GHz boost clock, its dense bf16 tensor-core peak
# (989 TFLOP/s, NVIDIA's data sheet) as one core's work per cycle. The
# counterpart of the reference's TPU_V5E_SPEC.
H100_SPEC = DeviceComputeSpec(
    name="h100-sxm",
    power_max_w=700.0,
    f_max_hz=1.98e9,
    n_cores=1,
    flops_per_cycle=989e12 / 1.98e9,
)
