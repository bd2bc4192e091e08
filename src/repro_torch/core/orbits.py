"""Orbital mechanics of the LEO constellation — paper eqs. (1)-(5).

Everything here is closed-form scalar math (float64 numpy); it feeds the
per-pass time budget of the energy optimizer (problem 13) and the pass
scheduler in :mod:`repro_torch.core.constellation`.

Erratum implemented (see DESIGN.md §6): eq. (4) of the paper reads
``T_pass = T_o * alpha_pass / pi`` but the geometry (and the paper's own
quoted ``T_pass ≈ 3.8 min`` for the Table I parameters) requires the
full-circle normalization ``T_o * alpha_pass / (2*pi)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

# Physical constants (SI).
R_EARTH_M = 6_371_000.0          # mean Earth radius [m]
MU_EARTH = 3.986_004_418e14      # G*M of Earth [m^3/s^2]
C_LIGHT = 299_792_458.0          # speed of light [m/s]


@dataclasses.dataclass(frozen=True)
class OrbitalPlane:
    """A single orbital ring of ``n_sats`` evenly spaced satellites.

    Matches the network architecture of paper §III-A: the ground terminal
    sees exactly one satellite at a time; after ``T_pass`` the next
    satellite in the ring takes over.
    """

    n_sats: int = 25
    altitude_m: float = 550_000.0
    min_elevation_rad: float = math.radians(30.0)

    # --- eq. (1): orbital period -------------------------------------
    @property
    def period_s(self) -> float:
        a = R_EARTH_M + self.altitude_m
        return 2.0 * math.pi * math.sqrt(a**3 / MU_EARTH)

    # --- eq. (2): slant range at elevation eps -----------------------
    def slant_range_m(self, elevation_rad: float) -> float:
        re, h = R_EARTH_M, self.altitude_m
        s = math.sin(elevation_rad)
        return math.sqrt(re**2 * s**2 + 2.0 * re * h + h**2) - re * s

    @property
    def max_slant_range_m(self) -> float:
        """Largest GS<->LEO distance, at the minimum elevation angle."""
        return self.slant_range_m(self.min_elevation_rad)

    # --- eq. (3): Earth-central angle swept during a pass -------------
    @property
    def pass_central_angle_rad(self) -> float:
        re, h = R_EARTH_M, self.altitude_m
        d = self.max_slant_range_m
        cosarg = ((re + h) ** 2 + re**2 - d**2) / (2.0 * (re**2 + re * h))
        cosarg = min(1.0, max(-1.0, cosarg))
        return 2.0 * math.acos(cosarg)

    # --- eq. (4) with the /(2*pi) erratum fix --------------------------
    @property
    def pass_duration_s(self) -> float:
        return self.period_s * self.pass_central_angle_rad / (2.0 * math.pi)

    # --- eq. (5): intra-plane inter-satellite distance -----------------
    @property
    def isl_distance_m(self) -> float:
        return 2.0 * (R_EARTH_M + self.altitude_m) * math.sin(math.pi / self.n_sats)

    # --- propagation helpers used by eq. (12) --------------------------
    @functools.lru_cache(maxsize=64)
    def mean_slant_range_m(self, n_samples: int = 256) -> float:
        """Average GS<->LEO distance over the visible arc.

        The elevation sweeps ``eps_min -> 90° -> eps_min``; by symmetry we
        average d(eps) over the half-arc parameterized by the central
        angle (uniform in time for a circular orbit).  Memoized per plane
        (the dataclass is frozen/hashable): this sits on the hot path of
        every problem-(13) solve, and re-running the quadrature per solve
        used to dominate constellation-scale sweeps.
        """
        re, h = R_EARTH_M, self.altitude_m
        alpha_half = self.pass_central_angle_rad / 2.0
        # central angle offset from nadir-closest point, uniform in time
        phi = alpha_half * (np.arange(n_samples) + 0.5) / n_samples
        # law of cosines between GS (radius re) and sat (radius re+h)
        d = np.sqrt(re**2 + (re + h) ** 2 - 2.0 * re * (re + h) * np.cos(phi))
        return float(d.mean())

    @property
    def mean_prop_delay_s(self) -> float:
        return self.mean_slant_range_m() / C_LIGHT

    @property
    def isl_prop_delay_s(self) -> float:
        return self.isl_distance_m / C_LIGHT

    def summary(self) -> dict:
        return {
            "n_sats": self.n_sats,
            "altitude_km": self.altitude_m / 1e3,
            "period_min": self.period_s / 60.0,
            "pass_duration_s": self.pass_duration_s,
            "pass_duration_min": self.pass_duration_s / 60.0,
            "max_slant_range_km": self.max_slant_range_m / 1e3,
            "mean_slant_range_km": self.mean_slant_range_m() / 1e3,
            "isl_distance_km": self.isl_distance_m / 1e3,
            "pass_central_angle_deg": math.degrees(self.pass_central_angle_rad),
        }


# Paper Table I constellation.
PAPER_PLANE = OrbitalPlane(n_sats=25, altitude_m=550_000.0, min_elevation_rad=math.radians(30.0))
