"""The contact-window model: the time-varying inter-plane ISL topology
(the port of ``repro/isl/link.py``).

Which plane pairs can exchange at pass ``k``, at what rate and for how
long. Everything is modular arithmetic on the pass index, like
:meth:`repro_torch.fleet.scenarios.EclipseConfig.sunlit`, so the fleet
engine (Python ints: its pass index is a host count), the NumPy oracle
and the planner evaluate one expression, at any pass, with no
precomputed horizon.

A contact opens every ``period`` passes (offset by ``phase``); the
``c``-th contact connects plane ``p`` to plane ``(p + offsets[c % len])
% P``, so cycling the offsets makes the topology vary in time. Each
contact lasts ``window_s`` seconds at the eq.-(10) fixed ISL rate of
:class:`repro_torch.core.linkbudget.ISLConfig` (or the eq.-(8) Shannon
rate at the configured cross-plane distance), which gives a hard bit
capacity ``rate_bps * window_s`` per contact: a payload that does not
fit does not transfer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.linkbudget import ISLConfig, LinkConfig


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """The inter-plane contact schedule, as arithmetic on the pass index.

    ``open_at(k)``: a contact window opens at pass ``k`` iff ``(k +
    phase) % period == 0``. ``offset_at(k)``: that contact's plane-pair
    offset, cycling through ``offsets``; plane ``p`` pushes to ``(p +
    offset) % P`` and receives from ``(p - offset) % P``.

    ``window_s`` bounds the contact; with ``distance_m`` unset the link
    runs at the eq.-(10) fixed ISL rate, otherwise at the eq.-(8)
    Shannon rate for that distance.
    """

    period: int = 1              # passes between contact-window opens
    phase: int = 0               # global schedule offset, in passes
    window_s: float = 1.0        # contact window duration, seconds
    offsets: Tuple[int, ...] = (1,)   # plane-pair offset cycle
    distance_m: Optional[float] = None  # cross-plane slant range (Shannon)

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"contact period must be >= 1, "
                             f"got {self.period}")
        if self.window_s <= 0.0:
            raise ValueError(f"contact window must be > 0 s, "
                             f"got {self.window_s}")
        if not self.offsets:
            raise ValueError("need at least one plane-pair offset")

    # ---- schedule arithmetic (Python ints and NumPy arrays alike) -----
    def open_at(self, k):
        """Does a contact window open at pass ``k``?"""
        return (k + self.phase) % self.period == 0

    def contact_index(self, k):
        """Which contact (0-based) pass ``k``'s window is; meaningful only
        where :meth:`open_at` holds."""
        return (k + self.phase) // self.period

    def offset_at(self, k, xp=np):
        """The plane-pair offset of pass ``k``'s contact."""
        offs = xp.asarray(self.offsets, xp.int32)
        return offs[self.contact_index(k) % len(self.offsets)]

    def partner(self, plane, k, n_planes: int, xp=np):
        """The plane that ``plane`` pushes to at pass ``k``'s contact."""
        return (plane + self.offset_at(k, xp)) % n_planes

    def contacts_in(self, n_passes: int, start: int = 0) -> int:
        """How many contact windows open in ``[start, start + n_passes)``
        (for ring sizing and amortization)."""
        return sum(1 for k in range(start, start + n_passes)
                   if (k + self.phase) % self.period == 0)

    # ---- physics ------------------------------------------------------
    def rate_bps(self, isl: ISLConfig,
                 link: Optional[LinkConfig] = None) -> float:
        """The contact's data rate: eq. (10) fixed, or the eq.-(8)
        Shannon rate at ``distance_m`` when a :class:`LinkConfig` is
        given."""
        if self.distance_m is not None and link is not None:
            return float(link.rate_bps(isl.tx_power_w, self.distance_m))
        return float(isl.rate_bps)

    def capacity_bits(self, isl: ISLConfig,
                      link: Optional[LinkConfig] = None) -> float:
        """The hard per-contact bit budget: ``rate * window_s``."""
        return self.rate_bps(isl, link) * self.window_s

    def tx_energy_j(self, bits: float, isl: ISLConfig,
                    link: Optional[LinkConfig] = None) -> float:
        """Transmit energy of one ``bits``-sized push: ``isl_pw * bits /
        rate``, the planner's eq.-(11) E_ISL pricing, drained from the
        pushing satellite."""
        return isl.tx_power_w * bits / self.rate_bps(isl, link)
