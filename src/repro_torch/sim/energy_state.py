"""Per-satellite energy state as device tensors: the battery of the
device engine (the port of ``repro/sim/energy_state.py``).

The host :class:`~repro_torch.core.constellation.ConstellationSim` keeps
one Python ``SatelliteState`` per satellite; the device engine
(:mod:`repro_torch.sim.device_sim`) keeps the same bookkeeping as one
:class:`EnergyState` of ``(N,)`` tensors, so battery drain, solar
recharge and the reserve-skip policy run on the device with no host
round trip. Indexed by ring slot = satellite id:

* ``battery_j``       float32 — charge, clamped to ``[0, capacity]``;
* ``energy_spent_j``  float32 — cumulative eq. (11) energy of served
  passes (satellite + ground + ISL, as the host sim's
  ``SatelliteState.energy_spent_j``);
* ``passes_served``   int32   — trained (incl. shed) pass count;
* ``passes_skipped``  int32   — reserve-policy skips.

The updates are index updates at a satellite index that may be a device
tensor, so they never read the host. The clamp is the port's one battery
policy, :func:`repro_torch.core.energy.clamp_battery` (re-exported).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.energy import clamp_battery

__all__ = ["EnergyState", "apply_pass", "apply_serve", "clamp_battery",
           "init_energy_state", "recharge"]


class EnergyState(NamedTuple):
    """Constellation-wide battery/serving counters as ``(N,)`` tensors
    (NumPy arrays once brought home)."""

    battery_j: Any
    energy_spent_j: Any
    passes_served: Any
    passes_skipped: Any

    @property
    def n_sats(self) -> int:
        return self.battery_j.shape[0]


def init_energy_state(n_sats: int, battery_j: float,
                      device="cuda") -> EnergyState:
    """Fresh fleet on ``device``: full batteries, zero counters."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return EnergyState(
        battery_j=torch.full((n_sats,), battery_j, **f32),
        energy_spent_j=torch.zeros((n_sats,), **f32),
        passes_served=torch.zeros((n_sats,), **i32),
        passes_skipped=torch.zeros((n_sats,), **i32))


def _one(x, dtype, device) -> torch.Tensor:
    """``x`` (a Python scalar or a 0-d/1-element tensor) as a (1,) tensor
    of ``dtype``; a Python scalar becomes a fill on ``device``, never a
    host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).reshape(1)
    return torch.full((1,), x, dtype=dtype, device=device)


def recharge(state: EnergyState, energy_j, capacity_j: float,
             member_mask: Optional[Any] = None,
             sunlit: Optional[Any] = None) -> EnergyState:
    """Solar recharge between passes, clamped at capacity.

    ``member_mask`` (bool ``(N,)``) limits recharge to the satellites
    that were ring members during the pass; None recharges the whole
    (static) ring. ``sunlit`` (bool, a 0-d tensor or a Python bool)
    gates the plane's solar input: False harvests nothing. None means
    permanent sunlight.
    """
    gain = energy_j
    if sunlit is not None:
        gain = torch.where(_one(sunlit, torch.bool,
                                state.battery_j.device), gain, 0.0)
    if member_mask is not None:
        gain = torch.where(member_mask, gain, 0.0)
    return state._replace(
        battery_j=clamp_battery(state.battery_j + gain, capacity_j))


def apply_serve(state: EnergyState, sat, drain_j,
                capacity_j: float) -> EnergyState:
    """Charge serving drain ``drain_j`` to satellite ``sat``: subtracted
    from the battery training drains too, and recorded in
    ``energy_spent_j``; the pass counters are untouched."""
    dev = state.battery_j.device
    idx = _one(sat, torch.long, dev)
    d = _one(drain_j, torch.float32, dev)
    return state._replace(
        battery_j=clamp_battery(state.battery_j.index_add(0, idx, -d),
                                capacity_j),
        energy_spent_j=state.energy_spent_j.index_add(0, idx, d))


def apply_pass(state: EnergyState, sat, drain_j, e_total_j,
               capacity_j: float, trained,
               skipped: Optional[Any] = None) -> EnergyState:
    """Account one pass for satellite ``sat``; every argument but the
    capacity may be a device tensor.

    ``trained`` (bool) gates everything: a reserve-policy skip drains
    nothing and bumps ``passes_skipped`` instead. ``drain_j`` is the
    satellite-side battery draw (E_proc^sat + E_comm^down + E_ISL),
    ``e_total_j`` the full eq.-(11) cost recorded in ``energy_spent_j``.
    ``skipped`` defaults to ``~trained``, the static ring's dichotomy.
    """
    dev = state.battery_j.device
    idx = _one(sat, torch.long, dev)
    t = _one(trained, torch.bool, dev)
    s = ~t if skipped is None else _one(skipped, torch.bool, dev)
    f = t.to(torch.float32)
    drain = _one(drain_j, torch.float32, dev)
    spent = _one(e_total_j, torch.float32, dev)
    return EnergyState(
        battery_j=clamp_battery(
            state.battery_j.index_add(0, idx, -drain * f), capacity_j),
        energy_spent_j=state.energy_spent_j.index_add(0, idx, spent * f),
        passes_served=state.passes_served.index_add(
            0, idx, t.to(torch.int32)),
        passes_skipped=state.passes_skipped.index_add(
            0, idx, s.to(torch.int32)))
