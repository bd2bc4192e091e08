"""The elastic fleet engine: P orbital planes, each an elastic M-slot ring,
on one device (the port of ``repro/fleet/engine.py``, without its mesh).

The single-ring engine (:mod:`repro_torch.sim.device_sim`) runs one
static ring. This one adds, still with no host read inside a revolution:

* **Elastic rings and failures.** A per-slot ``failed`` mask, with the
  precomputed join and leave passes (:mod:`repro_torch.fleet.events`),
  gives each pass its members, and the serving slot is found on the
  device as the host's ``ring[k % len(ring)]`` (a ``cumsum`` and an
  ``argmax`` over the members in slot order). The seeded failure stream
  (the host engine's own NumPy draws, one stream per plane) kills slots
  mid-run; a failed or absent slot's pass runs its steps masked, so the
  successor trains on from the state as it was.
* **The plane axis.** The energy state, the ``failed`` mask, the pass
  plan (:class:`~repro_torch.sim.device_sim.DevicePassPlan`), the data
  cursors, the join and leave passes, the failure mask and the eclipse
  flags are ``(P, M)`` or ``(P,)`` tensors; membership, the serving slot,
  the failure draw, the reserve skip, the battery drain and the recharge
  run for all planes at once. The models are a list of P
  :class:`~repro_torch.core.train_state.SLTrainState`, stepped in a
  Python loop over planes through the shared masked step
  (:func:`~repro_torch.core.sl_step.make_pass_step`). Not ``vmap``: the
  int8 boundary's straight-through estimator is an
  ``autograd.Function`` without a batching rule, and stacking the
  planes' conv weights would change the kernels each step runs.
* **Degraded operations** (:mod:`repro_torch.fleet.scenarios`): eclipse
  windows gate the recharge; epidemic faults spread along each ring
  (``ACTION_FAULT`` passes train nothing and pay nothing), drawn from the
  precomputed schedule inside the horizon and from a counter hash beyond
  it; a Byzantine slot's pass corrupts the parameter update it made.
* **The inter-plane exchange.** With ``exchange=None``, every
  ``avg_every`` revolutions (P > 1) every plane's parameters and
  optimizer state become their
  :func:`~repro_torch.fleet.scenarios.aggregate_planes` center (the mean
  by default), free and instantaneous. With an
  :class:`~repro_torch.isl.exchange.ExchangeConfig` the exchange is
  modeled (:mod:`repro_torch.isl`): async gossip at contact windows after
  the passes, or the sync codec exchange at the boundary, with the
  compressed deltas' exact bits metered, each push's energy charged to
  the serving satellite and the amortized bits priced into the plan.
  The int8 codec runs kernel B1, one launch per leaf per plane per push.
* **Planning.** All P×M problem-(13) instances are shed and solved in
  one call (:func:`~repro_torch.sim.device_sim.plan_ring_passes` with
  ``n_sats=(P, M)``), with per-satellite measured ``dtx_bits`` rows.

The host :class:`~repro_torch.core.constellation.ConstellationSim` is the
oracle: one host engine per plane, seeded ``seed + p`` and reading data
ids offset by ``p * M``, gives the plane's actions, slots, losses and
batteries (:func:`_smoke`). ``ConstellationSim.run(engine="device")``
hands elastic rings here as a one-plane fleet.

There is no mesh: every plane runs on one device (the reference shards
the plane axis over ``launch/mesh.py``, not ported). The reference draws
the epidemic's spread and the ``scaled_noise`` corruption beyond its
precomputed draws from ``jax.random``; the port draws them from the
counter hash of :mod:`repro_torch.sim.data` (as the failures), so they
are held to no bits of the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.energy import PassBudget, clamp_battery
from repro_torch.core.sl_step import (SplitAdapter, dedupe_state_buffers,
                                      make_pass_step)
from repro_torch.core.train_state import SLTrainState, _leaves, _rebuild
from repro_torch.fleet.events import EventSchedule, build_event_schedule
from repro_torch.fleet.scenarios import (AGGREGATION_MODES, ScenarioConfig,
                                         aggregate_planes,
                                         build_scenario_schedule,
                                         epidemic_step)
from repro_torch.isl.codec import delta_payload_bits
from repro_torch.isl.exchange import (ExchangeConfig, aggregate_into,
                                      async_gossip_step, exchange_init,
                                      null_exchange_state,
                                      sync_exchange_step)
from repro_torch.obs.metrics import (MetricsRegistry, counter_property,
                                     global_registry)
from repro_torch.obs.ring import (EV_EXCHANGE, EV_PASS, FlightRecorder,
                                  TelemetryRing, record as ring_record,
                                  ring_init)
from repro_torch.sim import energy_state as es_mod
from repro_torch.sim.data import _M32, _hash32, box_muller, uniforms
from repro_torch.sim.device_sim import (ACTION_FAILED, ACTION_FAULT,
                                        ACTION_SHED, ACTION_SKIPPED,
                                        ACTION_TRAINED, DevicePassPlan,
                                        _no_host_sync, _to_host,
                                        measure_and_plan)
from repro_torch.sim.energy_state import EnergyState
from repro_torch.train.optimizer import resolve_optimizer

#: entropy tags of the counter-hash draws: failures and epidemic spread
#: beyond the precomputed horizon, and the scaled_noise corruption
_FAIL_TAG = 0xFA11
_SPREAD_TAG = 0x5B8E
_NOISE_TAG = 0x4015E


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs of a P-plane elastic constellation run.

    The steady-state fields are those of
    :class:`~repro_torch.sim.device_sim.DeviceSimConfig`; the elastic
    fields those of the host
    :class:`~repro_torch.core.constellation.ConstellationConfig`
    (``join_events``, ``leave_events``, ``fail_prob``,
    ``join_battery_frac``): the same schedules drive both engines, which
    is what makes the host engine the oracle. Plane ``p``'s failure
    stream is seeded ``seed + p``.
    """

    n_planes: int = 1
    n_revolutions: int = 1
    lr: float = 1e-2
    optimizer: Any = "sgd"
    quantize_boundary: bool = False
    battery_j: float = 5_000.0
    recharge_w: float = 20.0
    reserve_j: float = 100.0
    max_steps_per_pass: Optional[int] = 128
    min_fraction: float = 0.05
    seed: int = 0
    # ---- elastic membership and failures (the host engine's) ----------
    fail_prob: float = 0.0
    join_events: Dict[int, int] = dataclasses.field(default_factory=dict)
    leave_events: Dict[int, Any] = dataclasses.field(default_factory=dict)
    join_battery_frac: float = 1.0
    # seed + p failure streams (host parity) or SeedSequence.spawn streams
    # (no collisions across runs); see fleet/events.py
    legacy_streams: bool = True
    # ---- fleet structure ----------------------------------------------
    # passes per revolution (the telemetry, streaming and averaging
    # period); None = the initial ring size
    passes_per_revolution: Optional[int] = None
    # inter-plane averaging period, in revolutions; 0 = off
    avg_every: int = 1
    # eclipse windows, Byzantine slots and epidemic faults
    # (fleet/scenarios.py); None = the cooperative, sunlit baseline
    scenario: Optional[ScenarioConfig] = None
    # inter-plane aggregation: "mean" | "median" | "trimmed_mean"
    aggregate: str = "mean"
    # the modeled ISL exchange (repro_torch.isl): contact windows,
    # compressed deltas, bits and joules charged to the batteries and
    # priced into the plan. None = the free revolution-boundary average
    exchange: Optional[ExchangeConfig] = None


class FleetTelemetry(NamedTuple):
    """Per-pass outputs, ``(P,)`` a pass; ``(R, L, P)`` a dispatch."""

    action: Any               # int32 ACTION_* code
    sat: Any                  # int32 serving slot (-1: ring empty)
    loss: Any                 # float32 mean loss (NaN unless trained)
    battery_j: Any            # float32 serving slot's battery at pass end
    n_steps: Any              # int32 valid steps
    n_infected: Any           # int32 epidemic-faulted slots this pass


def average_planes(trees):
    """Inter-plane averaging over a list of per-plane trees: the ``mean``
    mode of :func:`~repro_torch.fleet.scenarios.aggregate_planes`."""
    return aggregate_planes(trees, "mean")


@dataclasses.dataclass
class FleetResult:
    """Host view of one fleet run (the telemetry read).

    Per-pass arrays are ``(P, K)``, plane-major, in each plane's pass
    order; per-slot arrays are ``(P, M)``. ``state`` is the list of the P
    planes' final train states (device tensors).
    """

    action: np.ndarray        # (P, K) int32 ACTION_* codes
    sat: np.ndarray           # (P, K) serving slot (-1: ring empty)
    loss: np.ndarray          # (P, K) NaN unless trained
    battery_j: np.ndarray     # (P, K) serving slot's battery at pass end
    n_steps: np.ndarray       # (P, K)
    n_infected: np.ndarray    # (P, K) epidemic-faulted slots per pass
    plan: DevicePassPlan      # (P, M) host copies
    energy: EnergyState       # (P, M) final fleet state, host copies
    failed: np.ndarray        # (P, M) final failure mask
    fault_ttl: np.ndarray     # (P, M) final epidemic recovery counters
    state: List[SLTrainState]
    isl_bits: Optional[np.ndarray] = None      # (P,) pushed wire bits
    isl_e_j: Optional[np.ndarray] = None       # (P,) ISL transmit joules
    isl_contacts: Optional[np.ndarray] = None  # (P,) pushes

    def summary(self) -> Dict[str, Any]:
        """A fleet-wide roll-up with ``ConstellationSim.summary``'s keys
        (loss_first and loss_last in time order across the fleet)."""
        trained = (self.action == ACTION_TRAINED) | \
                  (self.action == ACTION_SHED)
        losses = self.loss.T.reshape(-1)[trained.T.reshape(-1)]
        p_idx, k_idx = np.nonzero(trained)
        sats = self.sat[p_idx, k_idx]
        return {
            "passes": int(self.action.size),
            "trained": int(trained.sum()),
            "skipped": int((self.action == ACTION_SKIPPED).sum()),
            "failed": int((self.action == ACTION_FAILED).sum()),
            "faulted": int((self.action == ACTION_FAULT).sum()),
            "loss_first": float(losses[0]) if losses.size else None,
            "loss_last": float(losses[-1]) if losses.size else None,
            "E_total_J": float(self.plan.e_total_j[p_idx, sats].sum()),
            "E_comm_J": float(self.plan.e_comm_j[p_idx, sats].sum()),
            "E_proc_J": float(self.plan.e_proc_j[p_idx, sats].sum()),
            "E_isl_J": float(self.plan.e_isl_j[p_idx, sats].sum()),
            "ISL_exchange_bits": (float(self.isl_bits.sum())
                                  if self.isl_bits is not None else 0.0),
            "ISL_exchange_J": (float(self.isl_e_j.sum())
                               if self.isl_e_j is not None else 0.0),
        }


def _key(seed: int, tag: int, *counters: int) -> int:
    """A counter-hash key of (seed, tag, counters...), on host ints."""
    key = _hash32((int(seed) ^ tag) & _M32)
    for c in counters:
        key = _hash32((key + int(c)) & _M32)
    return key


def failure_draws(seed: int, k: int, n_planes: int, fail_prob: float,
                  device, base: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The ``(P,)`` failure draws of pass ``k`` beyond the precomputed
    horizon: plane ``p`` fails iff a uniform hashed from (seed, k, p)
    (the counter hash of :mod:`repro_torch.sim.data`) is below
    ``fail_prob``. Deterministic by seed, at ``fail_prob``'s rate, and
    drawn on the device with no host read. The reference draws these
    from ``jax.random`` inside its scan; no stream of the port can match
    that one, so they are held to no bits of the reference's. ``base``
    is ``_hash32(arange(n_planes))``, which does not depend on the
    key."""
    return uniforms(_key(seed, _FAIL_TAG, k), n_planes, device,
                    base) < fail_prob


def spread_draws(seed: int, k: int, n_planes: int, n_slots: int,
                 beta: float, device, base: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The ``(P, M)`` epidemic spread draws of pass ``k`` beyond the
    precomputed horizon: True where a uniform hashed from (seed, k, p, m)
    is below ``beta`` (``base`` is ``_hash32(arange(P * M))``). The
    reference draws these from ``jax.random``; held to no bits of it."""
    u = uniforms(_key(seed, _SPREAD_TAG, k), n_planes * n_slots, device,
                 base)
    return (u < beta).reshape(n_planes, n_slots)


def noise_like(seed: int, k: int, plane: int, salt: int,
               x: torch.Tensor) -> torch.Tensor:
    """Standard normals shaped like ``x`` (its dtype) for the
    ``scaled_noise`` corruption of leaf ``salt`` of plane ``plane`` at pass
    ``k``: Box-Muller pairs of counter-hash uniforms, on x's device."""
    n = x.numel()
    u = uniforms(_key(seed, _NOISE_TAG, k, plane, salt), n + n % 2,
                 x.device)
    return box_muller(u)[:n].reshape(x.shape).to(x.dtype)


def _clone_state(state: SLTrainState) -> SLTrainState:
    """A live copy of ``state`` whose leaves are new tensors."""
    state._require_live("fleet replica")
    fields = state._fields()
    return SLTrainState(*_rebuild(fields, iter(
        [t.clone() for t in _leaves(fields)])))


def _check_aggregate(cfg: FleetConfig) -> None:
    if cfg.aggregate not in AGGREGATION_MODES:
        raise ValueError(f"unknown aggregation mode {cfg.aggregate!r}; "
                         f"expected one of {AGGREGATION_MODES}")


class FleetEngine:
    """P orbital planes × an elastic M-slot ring each, on one device.

    ``batch_fn(sat, idx) -> batch`` must take device tensors and never
    read the host (the contract of
    :class:`~repro_torch.sim.device_sim.DeviceConstellationSim`); plane
    ``p``'s slot ``m`` reads data id ``p * M + m``, so a per-plane host
    oracle is the same provider with its ids offset. ``state`` is one
    :class:`~repro_torch.core.train_state.SLTrainState`, copied to every
    plane (the input stays as it is); ``schedule`` replaces the event
    schedule built from ``cfg``; ``battery0`` and ``failed0`` set the
    initial ring's batteries and dead slots (every plane alike);
    ``device`` is the card unless the caller asks for the CPU.

    Every pass records an ``EV_PASS`` into its plane's telemetry ring,
    every exchange (the free average, a push or the sync exchange) an
    ``EV_EXCHANGE``; the rings come home with the
    telemetry into ``self.recorder``. ``traces``, ``device_calls`` and
    ``host_syncs`` live on ``self.metrics`` (namespace ``fleet``), with
    one host sync per revolution when the telemetry is streamed.
    """

    traces = counter_property("traces")
    device_calls = counter_property("device_calls")
    host_syncs = counter_property("host_syncs")

    def __init__(self, adapter: SplitAdapter, budget: PassBudget,
                 batch_fn: Callable[[Any, Any], Dict],
                 cfg: Optional[FleetConfig] = None, *,
                 state: Optional[SLTrainState] = None,
                 plan: Optional[DevicePassPlan] = None,
                 dtx_bits=None, schedule: Optional[EventSchedule] = None,
                 battery0=None, failed0=None, device="cuda"):
        cfg = FleetConfig() if cfg is None else cfg
        _check_aggregate(cfg)
        self.device = dev = resolve_device(device)
        own = getattr(batch_fn, "device", None)
        if own is not None and torch.device(own) != dev:
            raise ValueError(f"the batch provider generates on {own}, the "
                             f"engine runs on {dev}")
        self.adapter = adapter
        self.budget = budget
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.n_planes = P = int(cfg.n_planes)
        # the slot layout follows the schedule (a chained delegation's
        # ring may carry joiners beyond the configured plane); eq. (5)'s
        # ISL hop stays priced off budget.plane.n_sats
        self.n_initial = (budget.plane.n_sats if schedule is None
                          else schedule.n_initial)
        self.rev_len = (self.n_initial if cfg.passes_per_revolution is None
                        else int(cfg.passes_per_revolution))
        self.n_passes = cfg.n_revolutions * self.rev_len
        if schedule is None:
            schedule = build_event_schedule(
                self.n_initial, self.n_passes,
                join_events=cfg.join_events, leave_events=cfg.leave_events,
                fail_prob=cfg.fail_prob, n_planes=P, seed=cfg.seed,
                legacy_streams=cfg.legacy_streams)
        if schedule.n_planes != P:
            raise ValueError(f"schedule covers {schedule.n_planes} planes "
                             f"but the fleet has {P}")
        self.schedule = schedule
        self.n_slots = M = schedule.n_slots
        self.scenario_schedule = build_scenario_schedule(
            cfg.scenario, P, M, schedule.n_passes, seed=cfg.seed)

        self.optimizer = resolve_optimizer(cfg.optimizer, lr=cfg.lr)
        if state is None:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            state = SLTrainState.create(*adapter.init(gen), self.optimizer)

        # ---- the ISL exchange's statics (repro_torch.isl) ---------------
        # the wire bits, the contact capacity and a push's energy follow
        # from shapes; a payload over the capacity disables the exchange
        # outright (a hard limit, not a price), and the amortized bits a
        # pass feed the problem-(13) plan, so the codec moves the plan
        exch = cfg.exchange
        self.exchange = exch
        self._ex_bits = 0.0
        self._ex_energy_j = 0.0
        self._ex_cap_bits = math.inf
        fits = False
        isl_extra_bits = 0.0
        if exch is not None:
            self._ex_bits = delta_payload_bits(
                (state.params_a, state.params_b), exch.codec)
            self._ex_cap_bits = exch.contact.capacity_bits(budget.isl,
                                                           budget.link)
            fits = self._ex_bits <= self._ex_cap_bits
            if fits:
                self._ex_energy_j = exch.contact.tx_energy_j(
                    self._ex_bits, budget.isl, budget.link)
                isl_extra_bits = self._ex_bits * exch.mean_contacts_per_pass(
                    self.rev_len, int(cfg.avg_every))
        self._ex_on = fits and P > 1
        self.dtx_bits = dtx_bits
        self.batch_size, self.costs, self.plan, self._scan_steps = \
            measure_and_plan(adapter, budget, batch_fn,
                             quantize_boundary=cfg.quantize_boundary,
                             params_a=state.params_a, n_sats=(P, M),
                             ring_n=budget.plane.n_sats, dtx_bits=dtx_bits,
                             max_steps_per_pass=cfg.max_steps_per_pass,
                             min_fraction=cfg.min_fraction, plan=plan,
                             isl_extra_bits=isl_extra_bits, device=dev)
        if tuple(self.plan.n_steps.shape) != (P, M):
            raise ValueError(f"plan shape {tuple(self.plan.n_steps.shape)} "
                             f"!= fleet layout ({P}, {M})")
        self._host_plan = self.plan.to_host()
        self.states = [_clone_state(state) for _ in range(P)]

        n0 = self.n_initial
        battery = np.full((P, M), cfg.battery_j, np.float32)
        battery[:, n0:] = clamp_battery(cfg.battery_j * cfg.join_battery_frac,
                                        cfg.battery_j)
        if battery0 is not None:
            battery[:, :n0] = np.broadcast_to(
                np.asarray(battery0, np.float32), (P, n0))
        failed = np.zeros((P, M), bool)
        if failed0 is not None:
            failed[:, :n0] = np.broadcast_to(np.asarray(failed0, bool),
                                             (P, n0))
        i32 = dict(dtype=torch.int32, device=dev)
        self.energy = EnergyState(
            battery_j=torch.from_numpy(battery).to(dev),
            energy_spent_j=torch.zeros((P, M), dtype=torch.float32,
                                       device=dev),
            passes_served=torch.zeros((P, M), **i32),
            passes_skipped=torch.zeros((P, M), **i32))
        self._failed = torch.from_numpy(failed).to(dev)
        self._fail_mask = torch.from_numpy(schedule.fail_mask).to(dev)
        self._join_pass = torch.from_numpy(schedule.join_pass).to(dev)
        self._leave_pass = torch.from_numpy(schedule.leave_pass).to(dev)
        self._batch_idx = torch.zeros((P,), **i32)
        self._pass_idx = 0          # absolute pass index, across runs
        # the epidemic's recovery counters ride the carry; its draws, its
        # first slots and the Byzantine mask are inputs on the device
        ssched = self.scenario_schedule
        self._ttl = torch.zeros((P, M), **i32)
        self._spread = torch.from_numpy(ssched.spread_draw).to(dev)
        self._init_mask = torch.from_numpy(ssched.init_mask).to(dev)
        self._byz = torch.from_numpy(ssched.byz_mask).to(dev)
        self._ex_state = (
            exchange_init([(s.params_a, s.params_b) for s in self.states], P)
            if self._ex_on else null_exchange_state(P, dev))

        int8_codec = self._ex_on and exch.codec.scheme == "int8"
        if (cfg.quantize_boundary or int8_codec) and dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.load("split_quant")     # build before the first pass
        self._pass_step = make_pass_step(
            adapter, self.optimizer,
            quantize_boundary=cfg.quantize_boundary)
        self._programs: Dict[int, Callable] = {}
        self.metrics = MetricsRegistry("fleet", parent=global_registry())
        self.metrics.gauge("n_planes").set(P)
        self.metrics.gauge("n_slots").set(M)
        self.recorder = FlightRecorder(self.metrics)

    @property
    def scan_steps(self) -> int:
        """Steps every plane's pass executes (masked beyond its
        allocation, and all of them on a failed or skipped pass)."""
        return self._scan_steps

    # ------------------------------------------------------- the program
    def _program(self, n_revolutions: int) -> Callable:
        """The fleet loop for R revolutions, built once per R:
        ``(states, energy, failed, ttl, bidx, rings, ex, k, sunlit) ->
        (states, energy, failed, ttl, bidx, rings, ex, k, FleetTelemetry)``
        with no host read; ``k`` is the absolute index of the first pass
        (a host int: the pass count is known without the device)."""
        fn = self._programs.get(n_revolutions)
        if fn is not None:
            return fn
        self.metrics.inc("traces")

        cfg, dev = self.cfg, self.device
        P, M, L, K = self.n_planes, self.n_slots, self.rev_len, \
            self._scan_steps
        R = n_revolutions
        pass_step, batch_fn, plan = self._pass_step, self.batch_fn, self.plan
        horizon = self.schedule.n_passes
        fail_prob, seed = float(cfg.fail_prob), int(cfg.seed)
        avg_every = int(cfg.avg_every)
        averaging = cfg.exchange is None and avg_every > 0 and P > 1
        recharge_j = float(cfg.recharge_w * self.budget.plane.pass_duration_s)
        reserve, cap = float(cfg.reserve_j), float(cfg.battery_j)
        join_pass, leave_pass = self._join_pass, self._leave_pass
        fail_mask = self._fail_mask
        step_ids = torch.arange(K, dtype=torch.int32, device=dev)
        slot_ids = torch.arange(M, dtype=torch.int64, device=dev)
        plane_base = _hash32(torch.arange(P, dtype=torch.int64, device=dev))
        no_fail = torch.zeros((P,), dtype=torch.bool, device=dev)
        no_fault = torch.zeros((P, M), dtype=torch.bool, device=dev)
        # the stressors, static: an absent one is no code at all
        scn = cfg.scenario
        epidemic = None if scn is None else scn.epidemic
        byz_cfg = None if scn is None else scn.byzantine
        spread, init_mask, byz = self._spread, self._init_mask, self._byz
        slot_base = None if epidemic is None else _hash32(
            torch.arange(P * M, dtype=torch.int64, device=dev))
        # the planes that hold a Byzantine slot (the mask is static)
        byz_planes = ([] if byz_cfg is None else
                      [p for p in range(P)
                       if self.scenario_schedule.byz_mask[p].any()])
        # the exchange (off, over capacity or one plane: no code at all)
        exch = self.exchange if self._ex_on else None
        ex_async = exch is not None and exch.mode == "async"
        ex_sync = exch is not None and exch.mode == "sync" and avg_every > 0
        ex_kw = dict(wire_bits=float(self._ex_bits),
                     e_push_j=float(self._ex_energy_j), battery_cap=cap,
                     n_planes=P, action_failed=ACTION_FAILED)

        def fail_draw(k):
            if k < horizon:
                return fail_mask[:, k]
            if fail_prob > 0.0:
                return failure_draws(seed, k, P, fail_prob, dev, plane_base)
            return no_fail

        def corrupt(st, old, lie, plane, k):
            """A Byzantine pass: where ``lie``, the parameters the pass
            made become ``old - scale * (new - old)`` (sign_flip) or
            ``new + scale * N(0, 1)`` (scaled_noise), in place; the
            optimizer state stays the honest trajectory's."""
            scale = float(byz_cfg.scale)
            for salt, tree in enumerate((st.params_a, st.params_b)):
                for i, x in enumerate(_leaves(tree)):
                    if not x.is_floating_point():
                        continue
                    if byz_cfg.mode == "sign_flip":
                        o = old[salt][i]
                        bad = o - scale * (x - o)
                    else:
                        bad = x + scale * noise_like(seed, k, plane,
                                                     2 * i + salt, x)
                    x.copy_(torch.where(lie, bad, x))

        def fleet_pass(states, energy, failed, ttl, bidx, rings, k, sunlit):
            # the epidemic first: faults spread along each ring, gated by
            # the precomputed draws (or the counter hash beyond them)
            faulted_m = no_fault
            if epidemic is not None:
                draw = (spread[:, k] if k < horizon else spread_draws(
                    seed, k, P, M, epidemic.beta, dev, slot_base))
                faulted_m, ttl = epidemic_step(ttl, draw, k, epidemic,
                                               init_mask, xp=torch)
            # membership next, as the host scheduler: joins and leaves
            # apply at pass start; the serving slot is ring[k % len(ring)]
            # over the members in slot order
            member = (join_pass <= k) & (k < leave_pass) & ~failed
            n_alive = member.sum(dim=1)
            served = n_alive > 0
            rank = torch.where(served, k % torch.clamp(n_alive, min=1), 0)
            cums = torch.cumsum(member.to(torch.int32), dim=1)
            slot = torch.argmax(((cums == (rank + 1)[:, None]) & member)
                                .to(torch.int32), dim=1)
            at = slot[:, None]

            # the host's order: the seeded failure draw, then the epidemic
            # fault, then the reserve skip, then the planned masked steps
            fail = served & fail_draw(k)
            fault = served & ~fail & faulted_m.gather(1, at)[:, 0]
            skip = energy.battery_j.gather(1, at)[:, 0] < reserve
            trains = served & ~fail & ~fault & ~skip
            n_valid = torch.where(trains, torch.clamp(
                plan.n_steps.gather(1, at)[:, 0], max=K), 0)
            old = {}
            if byz_cfg is not None and byz_cfg.mode == "sign_flip":
                old = {p: [[x.clone() for x in _leaves(t)] for t in
                           (states[p].params_a, states[p].params_b)]
                       for p in byz_planes}
            losses = []
            for p in range(P):
                sat = at[p] + p * M
                st, lp = states[p], []
                for j in range(K):
                    st, loss = pass_step(st, batch_fn(sat, bidx[p] + j),
                                         (j < n_valid[p]).reshape(()))
                    lp.append(loss)
                states[p] = st
                losses.append(torch.stack(lp))
            if byz_planes:
                # a Byzantine serving slot corrupts the update it made
                lie = byz.gather(1, at)[:, 0] & trains
                for p in byz_planes:
                    corrupt(states[p], old.get(p), lie[p], p, k)
            valid = step_ids < n_valid[:, None]
            loss = torch.where(
                trains,
                torch.where(valid, torch.stack(losses), 0.0).sum(dim=1)
                / torch.clamp(n_valid, min=1).to(torch.float32), math.nan)

            failed = failed | ((slot_ids == at) & fail[:, None])
            energy = es_mod.apply_pass(
                energy, slot, plan.drain_j.gather(1, at)[:, 0],
                plan.e_total_j.gather(1, at)[:, 0], cap, trains,
                served & ~fail & ~fault & skip)
            # recharge this pass's members that are still alive (a slot
            # that just failed collects nothing); an eclipsed plane
            # harvests nothing
            energy = es_mod.recharge(
                energy, recharge_j, cap, member_mask=member & ~failed,
                sunlit=None if sunlit is None else sunlit[:, None])
            bidx = bidx + n_valid
            kept = plan.kept_fraction.gather(1, at)[:, 0]
            action = torch.where(
                ~served | fail, ACTION_FAILED, torch.where(
                    fault, ACTION_FAULT, torch.where(
                        skip, ACTION_SKIPPED, torch.where(
                            kept < 1.0, ACTION_SHED, ACTION_TRAINED)))
            ).to(torch.int32)
            sat_id = torch.where(served, slot, -1).to(torch.int32)
            battery = torch.where(served, energy.battery_j.gather(1, at)[:, 0],
                                  math.nan)
            n_inf = faulted_m.sum(dim=1).to(torch.int32)
            telem = FleetTelemetry(action, sat_id, loss, battery,
                                   n_valid.to(torch.int32), n_inf)
            # flight recorder: one EV_PASS per (plane, pass), t the
            # absolute pass index
            lit = (torch.ones((P,), device=dev) if sunlit is None
                   else sunlit.to(torch.float32))
            payload = torch.stack([
                action.to(torch.float32), battery, loss,
                n_valid.to(torch.float32), kept,
                (fail | fault).to(torch.float32), lit,
                n_inf.to(torch.float32)], dim=1)
            rings = [ring_record(rings[p], EV_PASS, k, sat_id[p], payload[p])
                     for p in range(P)]
            return states, energy, failed, ttl, bidx, rings, telem

        def closed_loop(states, energy, failed, ttl, bidx, rings, ex, k,
                        sunlit):
            telem = FleetTelemetry(*[
                torch.empty((R * L, P), dtype=dt, device=dev)
                for dt in (torch.int32, torch.int32, torch.float32,
                           torch.float32, torch.int32, torch.int32)])
            i = 0
            for _ in range(R):
                for _ in range(L):
                    states, energy, failed, ttl, bidx, rings, row = \
                        fleet_pass(states, energy, failed, ttl, bidx, rings,
                                   k, None if sunlit is None else sunlit[i])
                    for dst, v in zip(telem, row):
                        dst[i].copy_(v)
                    if ex_async:
                        # contact-window gossip after the pass: delta
                        # push, staleness-weighted merge, battery charge
                        states, ex, energy, rings = async_gossip_step(
                            exch, states, ex, energy, rings, k, row.sat,
                            row.action, **ex_kw)
                    i += 1
                    k += 1
                boundary = avg_every > 0 and (k // L) % avg_every == 0
                if ex_sync:
                    # the boundary exchange through the codec and the
                    # meter; the last pass's slot pays
                    states, ex, energy, rings = sync_exchange_step(
                        exch, cfg.aggregate, states, ex, energy, rings, k,
                        row.sat, row.action, boundary, **ex_kw)
                elif averaging and boundary:
                    # the free exchange at the revolution boundary: every
                    # float leaf of every plane's state (params and
                    # optimizer state) becomes the planes' center
                    aggregate_into(states, cfg.aggregate)
                    rings = [ring_record(r, EV_EXCHANGE, k, -1, (1.0,))
                             for r in rings]
            return states, energy, failed, ttl, bidx, rings, ex, k, \
                FleetTelemetry(*[t.reshape(R, L, P) for t in telem])

        self._programs[n_revolutions] = closed_loop
        return closed_loop

    def _sunlit(self, k0: int, n: int) -> Optional[torch.Tensor]:
        """The eclipse flags of passes ``k0 .. k0 + n - 1`` as an ``(n,
        P)`` bool tensor (None without eclipses), from the scenario's
        ``sunlit(k, plane)`` on host ints, as the host engine calls it;
        made before the dispatch, so the copy is outside the revolution."""
        scn = self.cfg.scenario
        if scn is None or scn.eclipse is None:
            return None
        flags = [[bool(scn.eclipse.sunlit(k, p))
                  for p in range(self.n_planes)] for k in range(k0, k0 + n)]
        return torch.tensor(flags, dtype=torch.bool, device=self.device)

    # --------------------------------------------------------------- run
    def run(self, n_revolutions: Optional[int] = None, *,
            stream_telemetry: bool = False) -> FleetResult:
        """Run R fleet revolutions; chainable (states, batteries, failures,
        epidemic counters, the exchange's state and the pass index carry
        over).

        ``stream_telemetry=True`` dispatches one revolution at a time and
        reads its telemetry (exactly one host sync per revolution); the
        default runs all R revolutions in one dispatch and one read.
        """
        R = self.cfg.n_revolutions if n_revolutions is None else n_revolutions
        if R < 1:
            raise ValueError("need at least one revolution")
        states = []
        for st in self.states:
            st._require_live("fleet closed loop")
            states.append(dedupe_state_buffers(st))
            st.mark_consumed()
        energy, failed, bidx = self.energy, self._failed, self._batch_idx
        ttl, ex = self._ttl, self._ex_state
        P, L = self.n_planes, self.rev_len

        chunks = []
        r_chunk = 1 if stream_telemetry else R
        fn = self._program(r_chunk)
        # L passes and the exchange's events a revolution, per plane: one
        # at the boundary, or one per contact window when gossiping
        n_ex = (L // self.exchange.contact.period + 1
                if self._ex_on and self.exchange.mode == "async" else 1)
        for _ in range(R if stream_telemetry else 1):
            rings = [ring_init(r_chunk * (L + n_ex), device=self.device)
                     for _ in range(P)]
            sunlit = self._sunlit(self._pass_idx, r_chunk * L)
            t0 = time.perf_counter()
            with _no_host_sync(self.device):
                states, energy, failed, ttl, bidx, rings, ex, k, telem = fn(
                    states, energy, failed, ttl, bidx, rings, ex,
                    self._pass_idx, sunlit)
            # commit the carry per dispatch: an interrupted streaming
            # study keeps every finished revolution and stays chainable
            self.states, self.energy, self._failed = states, energy, failed
            self._ttl, self._ex_state = ttl, ex
            self._batch_idx, self._pass_idx = bidx, k
            self.metrics.inc("device_calls")
            ring = TelemetryRing(*[torch.stack(f) for f in zip(*rings)])
            host = _to_host(*telem, *energy, failed.to(torch.int32), ttl,
                            ex.bits, ex.e_j, ex.n_contacts,
                            *ring)                       # the ONE sync
            self.metrics.inc("host_syncs")
            self.metrics.histogram("dispatch_s").record(
                time.perf_counter() - t0)
            energy_h = EnergyState(*host[6:10])
            failed_h = host[10].astype(bool)
            ttl_h, meters = host[11], host[12:15]
            self.recorder.ingest(TelemetryRing(*host[15:]))
            chunks.append(FleetTelemetry(*host[:6]))

        telem = FleetTelemetry(*[np.concatenate(xs) for xs in zip(*chunks)])

        def flat(x):        # (R, L, P) -> (P, R*L): plane-major timelines
            return np.transpose(x, (2, 0, 1)).reshape(P, -1)

        return FleetResult(
            action=flat(telem.action), sat=flat(telem.sat),
            loss=flat(telem.loss), battery_j=flat(telem.battery_j),
            n_steps=flat(telem.n_steps), n_infected=flat(telem.n_infected),
            plan=self._host_plan, energy=energy_h, failed=failed_h,
            fault_ttl=ttl_h, state=self.states, isl_bits=meters[0],
            isl_e_j=meters[1], isl_contacts=meters[2])


def _smoke(n_sats: int = 8, n_planes: int = 2, n_revolutions: int = 2,
           device="cuda") -> Dict[str, Any]:
    """``python -m repro_torch.fleet``: the fleet against the host engine,
    plane by plane, with join, leave and seeded-failure events.

    Plane ``p``'s oracle is a host
    :class:`~repro_torch.core.constellation.ConstellationSim` with the
    same events, the failure seed ``seed + p``, the same initial weights
    and its data ids offset into the plane's range; the fleet must give
    every action (trained, shed, skipped, failed) and serving slot, and
    each loss and battery within the reference's tolerances, with one
    host sync per revolution. Both run with ``cudnn.deterministic``, so
    they pick the same convolution algorithms. Returns the fleet's
    summary.
    """
    from repro_torch.core.constellation import (ConstellationConfig,
                                                ConstellationSim)
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.sim.data import DeviceImageryShards
    from repro_torch.sim.device_sim import ACTION_NAMES

    shards = DeviceImageryShards(img=32, batch=4, device=device)
    adapter = autoencoder_adapter(cut=5, img=32)
    budget = PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=4e6)
    events = dict(join_events={3: 1}, leave_events={5: 1})
    knobs = dict(battery_j=200.0, recharge_w=0.01, reserve_j=150.0,
                 max_steps_per_pass=2, fail_prob=0.2)
    cfg = FleetConfig(n_planes=n_planes, n_revolutions=n_revolutions,
                      seed=0, avg_every=0, **knobs, **events)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        fleet = FleetEngine(adapter, budget, shards, cfg, device=device)
        M, K = fleet.n_slots, fleet.n_passes
        res = fleet.run(stream_telemetry=True)
        t1 = time.perf_counter()
        hosts = []
        for p in range(n_planes):
            host = ConstellationSim(
                adapter, budget, lambda s, i, p=p: shards(p * M + s, i),
                ConstellationConfig(n_passes=K, batch_size=4,
                                    seed=cfg.seed + p, **knobs, **events),
                device=device)
            gen = torch.Generator(device=fleet.device).manual_seed(cfg.seed)
            host.state = SLTrainState.create(*adapter.init(gen),
                                             host.optimizer)
            host.run()
            hosts.append(host)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    s = res.summary()
    print(f"fleet: {n_planes} planes x {n_sats}(+{M - n_sats} join) sats x "
          f"{n_revolutions} revolutions on {fleet.device} ({t1 - t0:.1f} s)")
    print(f"  {s}")
    print(f"  traces={fleet.traces} device_calls={fleet.device_calls} "
          f"host_syncs={fleet.host_syncs} (one per revolution)")
    if fleet.traces != 1 or fleet.host_syncs != n_revolutions:
        raise AssertionError("more than one host sync per revolution")
    mism = 0
    for p, host in enumerate(hosts):
        h_act = [r.action for r in host.records]
        d_act = [ACTION_NAMES[int(a)] for a in res.action[p]]
        if h_act != d_act:
            raise AssertionError(f"plane {p}: host {h_act}, fleet {d_act}")
        if [r.sat_id for r in host.records] != res.sat[p].tolist():
            raise AssertionError(f"plane {p}: serving slots differ")
        for hr, dl, db in zip(host.records, res.loss[p], res.battery_j[p]):
            if hr.loss is not None:
                mism += abs(dl - hr.loss) > 2e-4 * abs(hr.loss) + 2e-5
            np.testing.assert_allclose(db, hr.battery_j, rtol=1e-5,
                                       atol=0.05)
    if mism:
        raise AssertionError(f"{mism} losses differ from the host engine's")
    if not (s["failed"] > 0 and s["skipped"] > 0 and s["trained"] > 0):
        raise AssertionError(f"failed, skipped and trained passes: {s}")
    print(f"  host-vs-fleet parity OK for all {n_planes} planes "
          f"({time.perf_counter() - t1:.1f} s host engines)")
    return s
