"""Degraded-operations scenarios of the fleet engine (the port of
``repro/fleet/scenarios.py``).

* **Eclipse windows** (:class:`EclipseConfig`): periodic shadow intervals
  per plane. ``sunlit(k, plane)`` is modular arithmetic on the pass index,
  on Python ints and on tensors alike, so the host engine and the fleet
  engine gate solar recharge with the same expression, at any pass index.
  An eclipsed pass harvests nothing, which is how shadow reaches the
  reserve-skip policy.
* **Byzantine satellites** (:class:`ByzantineConfig`): a static ``(P, M)``
  mask. When a Byzantine slot trains, the fleet engine corrupts the
  update its pass produced (``sign_flip``: the pass delta Δ becomes
  -scale·Δ; ``scaled_noise``: scale·N(0, 1) is added to every parameter).
* **Robust inter-plane aggregation** (:func:`aggregate_planes`):
  coordinate-wise ``mean`` (the default, the reference's parity mode),
  ``median`` or ``trimmed_mean`` over the planes' state trees.
* **Epidemic faults** (:class:`EpidemicConfig`): transient faults that
  spread to ring neighbours with probability ``beta`` a pass and recover
  after ``ttl`` passes (:func:`epidemic_step`, one rule for NumPy and
  tensors). The spread draws of the precomputed horizon come from
  :func:`build_scenario_schedule` (NumPy booleans, the reference's own
  streams); beyond it the engine draws them from a counter hash.

:func:`oracle_actions` replays the whole degraded decision loop
(membership, failure draw, epidemic fault, reserve skip, drain,
eclipse-gated recharge, the ISL push's charge) in NumPy over the
precomputed horizon: the exact ``ACTION_*`` sequence the fleet engine
must give. Byzantine corruption changes losses, never actions.
``python -m repro_torch.fleet --scenario degraded`` runs
:func:`_smoke_degraded`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.train_state import _leaves, _rebuild

#: entropy tag appended to the run seed, so the epidemic streams never
#: collide with the membership and failure streams of the same seed
_EPIDEMIC_TAG = 0xEC1D

#: the modes of :func:`aggregate_planes` (and ``FleetConfig.aggregate``)
AGGREGATION_MODES = ("mean", "median", "trimmed_mean")


@dataclasses.dataclass(frozen=True)
class EclipseConfig:
    """Periodic orbital shadow windows, per plane.

    Pass ``k`` of plane ``p`` is in eclipse iff ``(k + phase + p *
    stagger) % period < round(duty * period)``: the shadow opens each
    ``period``-pass cycle. ``stagger`` offsets the planes against each
    other; ``duty`` is the shadowed fraction of a cycle (1: recharge
    never fires).
    """

    period: int                 # eclipse cycle length, in passes
    duty: float                 # fraction of the cycle spent in shadow
    stagger: int = 0            # per-plane phase offset, in passes
    phase: int = 0              # global phase offset, in passes

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"eclipse period must be >= 1, got {self.period}")
        if not 0.0 <= self.duty <= 1.0:
            raise ValueError(f"eclipse duty must be in [0, 1], got {self.duty}")

    @property
    def eclipse_passes(self) -> int:
        return int(round(self.duty * self.period))

    def sunlit(self, k, plane=0):
        """Is plane ``plane`` in sunlight at pass ``k``? ``k`` and
        ``plane`` may be Python ints, NumPy arrays or integer tensors (the
        fleet engine passes its ``(P,)`` plane ids)."""
        pos = (k + self.phase + plane * self.stagger) % self.period
        return pos >= self.eclipse_passes


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Which slots lie, and how (``"sign_flip"``: the pass update Δ
    becomes -scale·Δ; ``"scaled_noise"``: scale·N(0, 1) is added to every
    float parameter). ``planes`` marks whole planes, ``slots`` single
    ``plane -> [slot, ...]`` entries."""

    planes: Tuple[int, ...] = ()
    slots: Mapping[int, Sequence[int]] = dataclasses.field(
        default_factory=dict)
    mode: str = "sign_flip"
    scale: float = 1.0

    def __post_init__(self):
        if self.mode not in ("sign_flip", "scaled_noise"):
            raise ValueError(f"unknown Byzantine mode {self.mode!r}; "
                             "expected 'sign_flip' or 'scaled_noise'")

    def mask(self, n_planes: int, n_slots: int) -> np.ndarray:
        """The static ``(P, M)`` corruption mask."""
        byz = np.zeros((n_planes, n_slots), bool)
        for p in self.planes:
            byz[int(p) % n_planes, :] = True
        for p, ms in self.slots.items():
            for m in ([ms] if isinstance(ms, (int, np.integer)) else ms):
                byz[int(p) % n_planes, int(m) % n_slots] = True
        return byz


@dataclasses.dataclass(frozen=True)
class EpidemicConfig:
    """Transient faults spreading along the slot ring: at pass ``start``
    the ``init_slots`` of every plane fault for ``ttl`` passes, and each
    pass a healthy neighbour of a faulted slot catches it with
    probability ``beta``."""

    beta: float = 0.3
    ttl: int = 3
    init_slots: Tuple[int, ...] = (0,)
    start: int = 0

    def __post_init__(self):
        if not 0.0 <= self.beta <= 1.0:
            raise ValueError(f"beta must be in [0, 1], got {self.beta}")
        if self.ttl < 1:
            raise ValueError(f"ttl must be >= 1, got {self.ttl}")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Any subset of the three stressors."""

    eclipse: Optional[EclipseConfig] = None
    byzantine: Optional[ByzantineConfig] = None
    epidemic: Optional[EpidemicConfig] = None

    @property
    def degraded(self) -> bool:
        return (self.eclipse is not None or self.byzantine is not None
                or self.epidemic is not None)


class ScenarioSchedule(NamedTuple):
    """The scenario's draws for one horizon, made on the host:
    ``spread_draw[p, k, m]`` the epidemic's Bernoulli draws (per-plane
    streams of ``np.random.SeedSequence([seed, tag])``; ``(P, 1, M)``
    all False without an epidemic), ``byz_mask[p, m]`` the Byzantine
    mask, ``init_mask[m]`` the epidemic's first slots."""

    spread_draw: np.ndarray       # (P, K, M) bool
    byz_mask: np.ndarray          # (P, M) bool
    init_mask: np.ndarray         # (M,) bool


def build_scenario_schedule(scn: Optional[ScenarioConfig], n_planes: int,
                            n_slots: int, n_passes: int,
                            seed: int = 0) -> ScenarioSchedule:
    """Precompute the scenario's host-side draws for ``n_passes``."""
    P, M, K = int(n_planes), int(n_slots), int(n_passes)
    byz = np.zeros((P, M), bool)
    init = np.zeros((M,), bool)
    spread = np.zeros((P, 1, M), bool)
    if scn is not None:
        if scn.byzantine is not None:
            byz = scn.byzantine.mask(P, M)
        if scn.epidemic is not None:
            ep = scn.epidemic
            for m in ep.init_slots:
                init[int(m) % M] = True
            streams = np.random.SeedSequence(
                [int(seed), _EPIDEMIC_TAG]).spawn(P)
            spread = np.stack([
                np.random.default_rng(s).random((K, M)) < ep.beta
                for s in streams])
    return ScenarioSchedule(spread_draw=spread, byz_mask=byz,
                            init_mask=init)


def plane_center(x: torch.Tensor, mode: str = "mean",
                 trim: int = 1) -> torch.Tensor:
    """The coordinate-wise center of ``x`` over its leading plane axis
    (the axis is dropped): the mean, the median (the mean of the two
    middle values for an even count, as ``jnp.median``) or the mean
    with the ``trim`` largest and smallest values of each coordinate
    left out."""
    if mode not in AGGREGATION_MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}; expected "
                         f"one of {AGGREGATION_MODES}")
    P = x.shape[0]
    if mode == "mean":
        return x.mean(dim=0)
    s = torch.sort(x, dim=0).values
    if mode == "median":
        if P % 2:
            return s[P // 2]
        return (s[P // 2 - 1] + s[P // 2]) / 2
    if P <= 2 * trim:
        raise ValueError(f"trimmed_mean(trim={trim}) needs more than "
                         f"{2 * trim} planes, got {P}")
    return s[trim:P - trim].mean(dim=0)


def aggregate_planes(trees: Sequence, mode: str = "mean",
                     trim: int = 1) -> List:
    """Inter-plane aggregation over a list of P per-plane trees (dicts,
    tuples and NamedTuples of tensors, one structure): every floating
    leaf becomes its coordinate-wise :func:`plane_center` over the
    planes, in every plane's tree (its own copy); integer leaves (step
    counters) stay per plane. Modes: ``"mean"`` (the parity default),
    ``"median"`` (robust to fewer than P/2 corrupted planes),
    ``"trimmed_mean"`` (needs P > 2·trim)."""
    if mode not in AGGREGATION_MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}; expected "
                         f"one of {AGGREGATION_MODES}")
    out = [[] for _ in trees]
    for col in zip(*[_leaves(t) for t in trees]):
        if col[0].is_floating_point():
            c = plane_center(torch.stack(col), mode, trim)
            for o in out:
                o.append(c.clone())
        else:
            for o, x in zip(out, col):
                o.append(x)
    return [_rebuild(t, iter(o)) for t, o in zip(trees, out)]


# --------------------------------------------------------------------------
# Epidemic dynamics and the NumPy oracles (the precomputed horizon)
# --------------------------------------------------------------------------

def epidemic_step(ttl, spread_k, k: int, ep: EpidemicConfig, init_mask,
                  xp=np):
    """One pass of the epidemic: THE update rule, on NumPy arrays
    (``xp=np``, the oracle, one plane's ``(M,)``) or tensors
    (``xp=torch``, the fleet engine, ``(P, M)``); the ring runs along the
    last axis and ``k`` is a host int.

    Order: (1) spread from the previous pass's faulted slots to their
    ring neighbours where this pass's draws allow, (2) inject the first
    infection at ``start`` (so the seed slots spread from the next pass
    on), (3) the returned ``faulted`` mask gates this pass, (4) the
    returned ``ttl`` is already counted down for the next pass.
    """
    if xp is np:
        roll = lambda x, n: np.roll(x, n, axis=-1)          # noqa: E731
        at_least = np.maximum
    else:
        roll = lambda x, n: torch.roll(x, n, dims=-1)       # noqa: E731
        at_least = lambda x, v: torch.clamp(x, min=v)       # noqa: E731
    infected_prev = ttl > 0
    neigh = roll(infected_prev, 1) | roll(infected_prev, -1)
    new_inf = ~infected_prev & neigh & spread_k
    ttl = xp.where(new_inf, ep.ttl, ttl)
    if k == ep.start:
        ttl = xp.where(init_mask, at_least(ttl, ep.ttl), ttl)
    return ttl > 0, at_least(ttl - 1, 0)


def epidemic_oracle(scn: Optional[ScenarioConfig], sched: ScenarioSchedule,
                    n_passes: Optional[int] = None) -> np.ndarray:
    """The epidemic over the precomputed horizon: ``(P, K, M)`` bool,
    which slots are faulted at each pass (all False without an
    epidemic)."""
    P, K_pre, M = sched.spread_draw.shape
    K = K_pre if n_passes is None else min(int(n_passes), K_pre)
    out = np.zeros((P, K, M), bool)
    if scn is None or scn.epidemic is None:
        return out
    for p in range(P):
        ttl = np.zeros((M,), np.int64)
        for k in range(K):
            out[p, k], ttl = epidemic_step(
                ttl, sched.spread_draw[p, k], k, scn.epidemic,
                sched.init_mask)
    return out


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def oracle_actions(fleet, return_slots: bool = False):
    """The exact ``(P, K)`` ``ACTION_*`` sequence a fleet that has not run
    yet must give over its precomputed horizon (it reads the initial
    batteries and failures).

    Replays the degraded decision loop in NumPy scalars: membership
    (joins, leaves, failures), the seeded failure stream, epidemic faults
    (:func:`epidemic_step` on the same draws), the reserve skip against
    the planned drains, the eclipse-gated recharge of the pass's members,
    and the ISL push's charge when the fleet has an exchange (an
    exchange-drained battery reaches the reserve skip in both).
    Byzantine corruption changes losses, never actions, so the oracle is
    exact for every scenario. ``return_slots=True`` also returns the
    ``(P, K)`` serving slots (-1 where the ring was empty), from which
    :func:`repro_torch.isl.exchange.oracle_exchange` replays the payers.
    """
    from repro_torch.sim.device_sim import (ACTION_FAILED, ACTION_FAULT,
                                            ACTION_SHED, ACTION_SKIPPED,
                                            ACTION_TRAINED)

    sched, scn = fleet.schedule, fleet.cfg.scenario
    ssched = fleet.scenario_schedule
    P, M, K = sched.n_planes, sched.n_slots, sched.n_passes
    cfg = fleet.cfg
    cap = np.float32(cfg.battery_j)

    def clamp(x):
        return np.clip(x, np.float32(0.0), cap)

    drain = _np(fleet.plan.drain_j).astype(np.float32)
    kept = _np(fleet.plan.kept_fraction).astype(np.float32)
    battery = _np(fleet.energy.battery_j).astype(np.float32).copy()
    failed = _np(fleet._failed).astype(bool).copy()
    recharge_j = np.float32(cfg.recharge_w
                            * fleet.budget.plane.pass_duration_s)
    reserve = np.float32(cfg.reserve_j)
    has_epi = scn is not None and scn.epidemic is not None
    # the ISL push's charge, in the engine's order: train drain, recharge,
    # then the push's transmit energy
    exch = getattr(fleet, "exchange", None)
    ex_on = bool(getattr(fleet, "_ex_on", False))
    e_isl = np.float32(getattr(fleet, "_ex_energy_j", 0.0))
    L, avg_every = fleet.rev_len, int(cfg.avg_every)

    actions = np.zeros((P, K), np.int32)
    slots = np.full((P, K), -1, np.int32)
    for p in range(P):
        ttl = np.zeros((M,), np.int64)
        for k in range(K):
            faulted_m = np.zeros((M,), bool)
            if has_epi:
                faulted_m, ttl = epidemic_step(
                    ttl, ssched.spread_draw[p, k], k, scn.epidemic,
                    ssched.init_mask)
            member = sched.member_at(k, failed[p])
            n_alive = int(member.sum())
            served = n_alive > 0
            slot = (np.flatnonzero(member)[k % n_alive] if served else 0)
            fail = served and bool(sched.fail_mask[p, k])
            fault = served and not fail and bool(faulted_m[slot])
            skip = battery[p, slot] < reserve
            trains = served and not fail and not fault and not skip
            if not served or fail:
                actions[p, k] = ACTION_FAILED
            elif fault:
                actions[p, k] = ACTION_FAULT
            elif skip:
                actions[p, k] = ACTION_SKIPPED
            else:
                actions[p, k] = (ACTION_SHED if kept[p, slot] < 1.0
                                 else ACTION_TRAINED)
            if served:
                slots[p, k] = slot
            if fail:
                failed[p, slot] = True
            if trains:
                battery[p, slot] = clamp(battery[p, slot] - drain[p, slot])
            sunlit = (scn is None or scn.eclipse is None
                      or bool(scn.eclipse.sunlit(k, p)))
            if sunlit:
                gain = np.where(member & ~failed[p], recharge_j,
                                np.float32(0.0))
                battery[p] = clamp(battery[p] + gain)
            if ex_on and served and not fail:
                if exch.mode == "async":
                    push = bool(exch.contact.open_at(k))
                else:
                    push = (avg_every > 0 and (k + 1) % L == 0
                            and ((k + 1) // L) % avg_every == 0)
                if push:
                    battery[p, slot] = clamp(battery[p, slot] - e_isl)
    return (actions, slots) if return_slots else actions


# --------------------------------------------------------------------------
# python -m repro_torch.fleet --scenario degraded
# --------------------------------------------------------------------------

def _smoke_degraded(n_sats: int = 8, n_planes: int = 2,
                    n_revolutions: int = 2, device="cuda"):
    """The degraded-ops smoke: a fleet under eclipses, one Byzantine slot
    (sign flip) and epidemic faults, aggregated by the trimmed mean (the
    median for fleets too small to trim). Its actions must equal
    :func:`oracle_actions` bit for bit, the losses stay finite, faults,
    reserve skips and a spreading epidemic occur, and each revolution
    takes one host sync. Returns the run's summary."""
    import time

    from repro_torch.core.energy import PassBudget
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.fleet.engine import FleetConfig, FleetEngine
    from repro_torch.sim.data import DeviceImageryShards
    from repro_torch.sim.device_sim import ACTION_FAULT, ACTION_SKIPPED

    shards = DeviceImageryShards(img=32, batch=4, device=device)
    adapter = autoencoder_adapter(cut=5, img=32)
    budget = PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=4e6)
    # the reference smoke's energy scale (~48 J a served pass, ~4.5 J of
    # recharge a sunlit pass at 0.02 W): a slot's first serve takes it
    # below the 180 J reserve, and the 50%-duty eclipse halves its
    # recovery, so second serves skip
    scn = ScenarioConfig(
        eclipse=EclipseConfig(period=4, duty=0.5, stagger=1),
        byzantine=ByzantineConfig(slots={0: [1]}, mode="sign_flip",
                                  scale=1.0),
        epidemic=EpidemicConfig(beta=0.6, ttl=2, init_slots=(0,), start=0))
    aggregate = "trimmed_mean" if n_planes > 2 else "median"
    cfg = FleetConfig(
        n_planes=n_planes, n_revolutions=n_revolutions, battery_j=200.0,
        recharge_w=0.02, reserve_j=180.0, max_steps_per_pass=2, seed=0,
        avg_every=1, scenario=scn, aggregate=aggregate)

    t0 = time.perf_counter()
    fleet = FleetEngine(adapter, budget, shards, cfg, device=device)
    expect = oracle_actions(fleet)
    res = fleet.run(stream_telemetry=True)
    s = res.summary()
    print(f"degraded-ops: {n_planes} planes x {n_sats} sats x "
          f"{n_revolutions} revolutions on {fleet.device}, eclipse + "
          f"byzantine + epidemic, aggregate={aggregate} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"  {s}")
    print(f"  traces={fleet.traces} device_calls={fleet.device_calls} "
          f"host_syncs={fleet.host_syncs} (one per revolution)")
    if fleet.traces != 1 or fleet.host_syncs != n_revolutions:
        raise AssertionError("more than one host sync per revolution")
    if not np.array_equal(res.action, expect):
        raise AssertionError(f"actions {res.action.tolist()} != oracle "
                             f"{expect.tolist()}")
    finite = res.loss[np.isfinite(res.loss)]
    if not finite.size:
        raise AssertionError("no pass trained")
    if not (res.action == ACTION_FAULT).any():
        raise AssertionError("the epidemic never faulted a serving slot")
    if not (res.action == ACTION_SKIPPED).any():
        raise AssertionError("eclipses never drove a battery below reserve")
    if res.n_infected.max() <= 1:
        raise AssertionError("the epidemic never spread")
    print(f"  action parity with the oracle OK; losses finite; max "
          f"infected {int(res.n_infected.max())}/{fleet.n_slots}")
    return s
