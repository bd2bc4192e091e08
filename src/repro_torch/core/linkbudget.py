"""Communication model — paper eqs. (8)-(10) plus the Table I link budget."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.orbits import C_LIGHT


def fspl_linear(distance_m: float, carrier_hz: float) -> float:
    """Free-space path loss as a linear power ratio (>= 1)."""
    return (4.0 * math.pi * distance_m * carrier_hz / C_LIGHT) ** 2


def db(x: float) -> float:
    return 10.0 * math.log10(x)


def from_db(x_db: float) -> float:
    return 10.0 ** (x_db / 10.0)


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """A Shannon-capacity link (GS<->LEO per Table I, or an ISL)."""

    bandwidth_hz: float = 500e6
    carrier_hz: float = 20e9
    antenna_gain_db: float = 66.33      # total (tx+rx) gain
    noise_power_dbw: float = -119.0
    max_tx_power_w: float = 10.0

    def channel_gain(self, distance_m: float) -> float:
        """g̃ = G / (FSPL * sigma^2): linear SNR per watt of tx power."""
        g = from_db(self.antenna_gain_db)
        fspl = fspl_linear(distance_m, self.carrier_hz)
        sigma2 = from_db(self.noise_power_dbw)
        return g / (fspl * sigma2)

    # --- eq. (8): rate and time ----------------------------------------
    def rate_bps(self, p_tx_w: float, distance_m: float) -> float:
        snr = p_tx_w * self.channel_gain(distance_m)
        return self.bandwidth_hz * math.log2(1.0 + snr)

    def comm_time_s(self, data_bits: float, p_tx_w: float, distance_m: float) -> float:
        r = self.rate_bps(p_tx_w, distance_m)
        return data_bits / r if r > 0 else math.inf

    # --- eq. (9): energy -------------------------------------------------
    def comm_energy_j(self, data_bits: float, p_tx_w: float, distance_m: float) -> float:
        return p_tx_w * self.comm_time_s(data_bits, p_tx_w, distance_m)

    # --- inverse: tx power needed to move data_bits in t seconds ----------
    def power_for_time(self, data_bits: float, t_s: float, distance_m: float) -> float:
        if t_s <= 0:
            return math.inf
        x = data_bits / (self.bandwidth_hz * t_s) * math.log(2.0)
        snr_needed = math.expm1(x) if x < 700 else math.inf
        return snr_needed / self.channel_gain(distance_m)

    def min_comm_time_s(self, data_bits: float, distance_m: float) -> float:
        """Fastest possible transfer: at max tx power."""
        return self.comm_time_s(data_bits, self.max_tx_power_w, distance_m)

    def energy_for_time(self, data_bits: float, t_s: float, distance_m: float) -> float:
        """E(t) = t * p(t): convex & decreasing in t (used by the solver)."""
        return t_s * self.power_for_time(data_bits, t_s, distance_m)


@dataclasses.dataclass(frozen=True)
class ISLConfig:
    """Fixed-rate intra-plane inter-satellite link — eq. (10)."""

    rate_bps: float = 5e9
    tx_power_w: float = 0.5

    def time_s(self, data_bits: float) -> float:
        return data_bits / self.rate_bps

    def energy_j(self, data_bits: float) -> float:
        return self.tx_power_w * self.time_s(data_bits)


# Table I links.
PAPER_GS_LINK = LinkConfig()
PAPER_ISL = ISLConfig()
