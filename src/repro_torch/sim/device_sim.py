"""The device-resident constellation loop (the port of
``repro/sim/device_sim.py``).

The host :class:`~repro_torch.core.constellation.ConstellationSim`
advances batteries and dispatches every pass from Python, reading each
pass's losses back. This engine keeps the whole closed loop on the
device: for every ring slot, [reserve-skip policy → masked SL steps on
batches generated on the device → battery drain → fleet recharge → one
flight-recorder event], with the model state, the per-satellite
:class:`~repro_torch.sim.energy_state.EnergyState`, the batch cursor and
the slot index all device tensors. The host reads the telemetry once per
revolution (``stream_telemetry=True``) or once per run.

Dispatch: eager. The reference compiles a (revolution × slot) nested
``lax.scan``; this port runs the same program as eager PyTorch that
never reads the device: the skip decision and every step's validity are
device bools, every step of a pass runs (K = ``bucket_size`` of the
plan's largest step count, as the reference's scan) and the masked ones
leave the state bit for bit as it was (``SLTrainState.apply_updates``
with a tensor ``where``). On the card the program runs under
``torch.cuda.set_sync_debug_mode("error")``, so an operation that would
wait for the device raises instead of stalling the loop. No CUDA graph
is captured, so there is no capture to fall back from.

Layers:

* planning: :func:`plan_ring_passes` builds the ring's N problem-(13)
  instances (:func:`~repro_torch.core.resource_opt_torch.
  ring_pass_coeffs`), sheds and solves them in float64 on the device and
  casts the plan (:class:`DevicePassPlan`) to float32/int32 at the
  planning/training boundary. A static ring's plan does not change
  between revolutions, so it is solved once. A swept grid cell gives a
  plan too (``RevolutionSweep.revolution_plan``).
* training: every step is the masked step of the host pass engine
  (:func:`~repro_torch.core.sl_step.make_pass_step`), so with
  ``quantize_boundary`` each executed step, masked or not, launches the
  boundary quantizer twice (z down, dz up).
* energy: :mod:`repro_torch.sim.energy_state`, with the host sim's
  battery clamp.

Counters on ``self.metrics`` (a :class:`~repro_torch.obs.metrics.
MetricsRegistry` under ``sim``): ``traces`` counts builds of a
revolution program (one per revolution count; it stays at 1 across
repeated runs of one shape), ``device_calls`` its dispatches and
``host_syncs`` the telemetry reads. ``self.recorder`` (a
:class:`~repro_torch.obs.ring.FlightRecorder`) gets one ``EV_PASS`` per
pass, brought home in the same read as the telemetry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.energy import PassBudget, SplitCosts
from repro_torch.core.sl_step import (SplitAdapter, _meta, boundary_bits,
                                      dedupe_state_buffers, make_pass_step)
from repro_torch.core.train_state import SLTrainState
from repro_torch.obs.metrics import (MetricsRegistry, counter_property,
                                     global_registry)
from repro_torch.obs.ring import (EV_PASS, FlightRecorder, TelemetryRing,
                                  record as ring_record, ring_init)
from repro_torch.sim import energy_state as es_mod
from repro_torch.sim.energy_state import EnergyState, init_energy_state
from repro_torch.train.optimizer import resolve_optimizer
from repro_torch.utils.bucketing import bucket_size as _bucket_size
from repro_torch.utils.treeutil import tree_bytes

ACTION_TRAINED = 0
ACTION_SHED = 1
ACTION_SKIPPED = 2
ACTION_FAILED = 3          # fleet engine only: a static ring cannot fail
ACTION_FAULT = 4           # fleet scenarios only: transient epidemic fault
ACTION_NAMES = {ACTION_TRAINED: "trained", ACTION_SHED: "shed",
                ACTION_SKIPPED: "skipped_energy", ACTION_FAILED: "failed",
                ACTION_FAULT: "faulted"}


class DevicePassPlan(NamedTuple):
    """One ring revolution of solved pass allocations, ``(N,)`` tensors
    at the float32 training boundary: SL steps per pass (``n_steps``,
    the ``n_valid`` feed of the masked steps), the satellite's battery
    drain (E_proc^sat + E_comm^down + E_ISL, what the host sim
    subtracts) and the eq. (11)/(12) records."""

    n_steps: Any              # (N,) int32   SL steps per pass (>=1)
    n_items_kept: Any         # (N,) float32 post-shedding item count
    kept_fraction: Any        # (N,) float32
    drain_j: Any              # (N,) float32 satellite battery draw / pass
    e_total_j: Any            # (N,) float32 eq. (11) incl. E_ISL
    e_proc_j: Any             # (N,) float32 sat + gs processing
    e_comm_j: Any             # (N,) float32 downlink + uplink
    e_isl_j: Any              # (N,) float32
    t_total_s: Any            # (N,) float32 eq. (12)
    d_isl_bits: Any           # (N,) float32 segment-A handoff payload
    feasible: Any             # (N,) bool   post-shedding feasibility

    @property
    def n_sats(self) -> int:
        return self.n_steps.shape[0]

    def to_host(self) -> "DevicePassPlan":
        """The whole plan as NumPy arrays."""
        return DevicePassPlan(*[a.cpu().numpy() for a in self])


def plan_from_report(rep, frac, n_items, d_isl_bits, batch_size,
                     max_steps_per_pass=None) -> DevicePassPlan:
    """Fold a solved ``ArraySolveReport`` and its shed fractions into a
    :class:`DevicePassPlan`, cast to float32/int32. The step count is the
    host scheduler's: ``max(1, round(n_items_kept / batch_size))``
    (round half to even, as Python's) capped at ``max_steps_per_pass``."""
    dev = rep.phase_energy.device
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                    device=dev)
    f32 = lambda a: a.to(torch.float32)                       # noqa: E731
    n_kept = f64(frac) * f64(n_items)
    steps = torch.clamp(torch.round(n_kept / float(batch_size)), min=1.0)
    if max_steps_per_pass is not None:
        steps = torch.clamp(steps, max=float(max_steps_per_pass))
    pe = rep.phase_energy                # (..., 4) canonical phase order
    return DevicePassPlan(
        n_steps=steps.to(torch.int32),
        n_items_kept=f32(n_kept),
        kept_fraction=f32(f64(frac)),
        drain_j=f32(pe[..., 0] + pe[..., 1] + rep.e_isl),
        e_total_j=f32(rep.e_total),
        e_proc_j=f32(pe[..., 0] + pe[..., 2]),
        e_comm_j=f32(pe[..., 1] + pe[..., 3]),
        e_isl_j=f32(rep.e_isl),
        t_total_s=f32(rep.t_total),
        d_isl_bits=f32(torch.broadcast_to(f64(d_isl_bits), steps.shape)),
        feasible=rep.feasible)


def plan_ring_passes(budget: PassBudget, costs: SplitCosts, *,
                     batch_size: int, n_sats=None,
                     dtx_bits=None, n_items=None,
                     max_steps_per_pass: Optional[int] = None,
                     min_fraction: float = 0.05, tol: float = 1e-10,
                     max_iters: int = 80,
                     ring_n: Optional[int] = None,
                     device="cuda") -> DevicePassPlan:
    """Shed and solve one ring revolution's N passes on ``device`` (the
    card unless the caller asks for the CPU): the device twin of
    ``RevolutionPlanner.plan_revolution``. ``dtx_bits`` and ``n_items``
    are scalars (broadcast ring-wide) or per-satellite ``(N,)`` arrays."""
    from repro_torch.core import resource_opt_torch as rot

    n_sats = budget.plane.n_sats if n_sats is None else n_sats
    dtx = costs.dtx_bits if dtx_bits is None else dtx_bits
    items = budget.n_items if n_items is None else n_items
    sc = rot.grid_scalars(budget.plane, budget.link, budget.isl,
                          budget.sat_device, budget.gs_device, device=device)
    coeffs = rot.ring_pass_coeffs(sc, n_sats, costs.w1_flops,
                                  costs.w2_flops, dtx, costs.d_isl_bits,
                                  items, ring_n=ring_n)
    rep, frac = rot.shed_and_solve_coeffs(coeffs, min_fraction, tol,
                                          max_iters)
    return plan_from_report(rep, frac, items, costs.d_isl_bits, batch_size,
                            max_steps_per_pass)


def meta_batch(batch_fn, sat, idx) -> Dict[str, torch.Tensor]:
    """The shapes and dtypes of ``batch_fn(sat, idx)`` as meta tensors,
    from the provider's own ``meta_batch`` where it has one (no batch is
    generated), else from one generated batch."""
    meta = getattr(batch_fn, "meta_batch", None)
    if meta is not None:
        return meta(sat, idx)
    return {k: _meta(v) for k, v in batch_fn(sat, idx).items()}


def measure_and_plan(adapter: SplitAdapter, budget: PassBudget, batch_fn,
                     *, quantize_boundary: bool, params_a, n_sats,
                     ring_n: Optional[int] = None, dtx_bits=None,
                     max_steps_per_pass: Optional[int] = None,
                     min_fraction: float = 0.05, plan=None,
                     isl_extra_bits=0.0, device="cuda"):
    """The construction block of the device engine: measure the boundary
    payload shape-only (segment A on the meta device), fold the measured
    costs (``dtx_bits`` per item, the segment-A handoff from
    ``params_a``), plan on the device (or take ``plan``), and size the
    per-pass step count from the plan's largest (one host read, at
    construction), bucketed as the reference's scan is. Returns
    ``(batch_size, costs, plan, scan_steps)``."""
    probe = meta_batch(batch_fn, 0, 0)
    batch_size = int(next(iter(probe.values())).shape[0])
    dtx = boundary_bits(adapter, probe, quantize_boundary) / batch_size
    costs = dataclasses.replace(adapter.costs(), dtx_bits=dtx,
                                d_isl_bits=8.0 * tree_bytes(params_a)
                                + isl_extra_bits)
    if plan is None:
        plan = plan_ring_passes(budget, costs, batch_size=batch_size,
                                n_sats=n_sats, ring_n=ring_n,
                                dtx_bits=dtx_bits,
                                max_steps_per_pass=max_steps_per_pass,
                                min_fraction=min_fraction, device=device)
    k_max = int(plan.n_steps.max())
    return batch_size, costs, plan, _bucket_size(max(k_max, 1))


class PassTelemetry(NamedTuple):
    """Per-pass outputs, ``(R, N)``."""

    action: Any               # int32 ACTION_* code
    loss: Any                 # float32 mean loss over executed steps (NaN
                              # when skipped)
    battery_j: Any            # float32 serving sat's battery at pass end
                              # (post-drain, post-recharge)
    n_steps: Any              # int32 steps actually executed


@dataclasses.dataclass(frozen=True)
class DeviceSimConfig:
    """Closed-loop knobs: the steady-state subset of
    :class:`~repro_torch.core.constellation.ConstellationConfig`.
    Elastic membership and random failures belong to the fleet engine,
    checkpoint persistence (``handoff_dir``) to the host engine."""

    n_revolutions: int = 1
    lr: float = 1e-2
    optimizer: Union[str, Any] = "sgd"
    quantize_boundary: bool = False
    battery_j: float = 5_000.0
    recharge_w: float = 20.0
    reserve_j: float = 100.0
    # per-pass step count ceiling; None = sized from the plan's largest
    # step count (one host read at construction)
    max_steps_per_pass: Optional[int] = 128
    min_fraction: float = 0.05
    seed: int = 0


@dataclasses.dataclass
class DeviceSimResult:
    """Host view of one closed-loop run (the synced telemetry)."""

    action: np.ndarray        # (R, N)
    loss: np.ndarray          # (R, N) NaN where skipped
    battery_j: np.ndarray     # (R, N) serving sat battery at pass end
    n_steps: np.ndarray       # (R, N)
    plan: DevicePassPlan      # host copies
    energy: EnergyState       # final fleet state, host copies
    state: Any                # final SLTrainState (device tensors)

    def summary(self) -> Dict[str, Any]:
        """Same keys as ``ConstellationSim.summary()`` (less
        ``faulted``, which a static ring never reports)."""
        R, N = self.action.shape
        sat = np.tile(np.arange(N), (R, 1))
        trained = self.action != ACTION_SKIPPED
        losses = self.loss[trained]
        return {
            "passes": int(R * N),
            "trained": int(trained.sum()),
            "skipped": int((~trained).sum()),
            "failed": 0,
            "loss_first": float(losses[0]) if losses.size else None,
            "loss_last": float(losses[-1]) if losses.size else None,
            "E_total_J": float(self.plan.e_total_j[sat[trained]].sum()),
            "E_comm_J": float(self.plan.e_comm_j[sat[trained]].sum()),
            "E_proc_J": float(self.plan.e_proc_j[sat[trained]].sum()),
            "E_isl_J": float(self.plan.e_isl_j[sat[trained]].sum()),
        }


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On the card: any operation that would wait for the device raises
    while the revolution runs (``set_sync_debug_mode("error")``)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _to_host(*tensors):
    """Every tensor to the host in ONE device-to-host copy: packed as
    float64 (exact for float32 and int32), copied, unpacked."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        dt = {torch.float32: np.float32, torch.int32: np.int32}[t.dtype]
        out.append(host[at:at + n].astype(dt).reshape(tuple(t.shape)))
        at += n
    return out


class DeviceConstellationSim:
    """The paper's cyclical SL protocol, resident on the device.

    ``batch_fn(sat, idx) -> batch`` must take device tensors and never
    read the host (a traceable provider, e.g.
    :class:`~repro_torch.sim.data.DeviceImageryShards`): it runs inside
    the revolution. ``state`` chains an existing
    :class:`~repro_torch.core.train_state.SLTrainState` (the engine takes
    it over; the input is marked consumed on ``run``); ``plan`` replaces
    the on-device planning with a :class:`DevicePassPlan` (e.g. a swept
    grid cell). ``device`` is the card unless the caller asks for the
    CPU; a provider with a ``device`` must be on the same one.
    """

    traces = counter_property("traces")
    device_calls = counter_property("device_calls")
    host_syncs = counter_property("host_syncs")

    def __init__(self, adapter: SplitAdapter, budget: PassBudget,
                 batch_fn: Callable[[Any, Any], Dict],
                 cfg: Optional[DeviceSimConfig] = None, *,
                 state: Optional[SLTrainState] = None,
                 plan: Optional[DevicePassPlan] = None,
                 dtx_bits=None, device="cuda"):
        cfg = DeviceSimConfig() if cfg is None else cfg
        self.device = resolve_device(device)
        own = getattr(batch_fn, "device", None)
        if own is not None and torch.device(own) != self.device:
            raise ValueError(f"the batch provider generates on {own}, the "
                             f"engine runs on {self.device}")
        self.adapter = adapter
        self.budget = budget
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.n_sats = budget.plane.n_sats
        self.optimizer = resolve_optimizer(cfg.optimizer, lr=cfg.lr)
        if state is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            state = SLTrainState.create(*adapter.init(gen), self.optimizer)
        self.state = state
        self.energy = init_energy_state(self.n_sats, cfg.battery_j,
                                        self.device)
        self.dtx_bits = dtx_bits
        self.batch_size, self.costs, self.plan, self._scan_steps = \
            measure_and_plan(adapter, budget, batch_fn,
                             quantize_boundary=cfg.quantize_boundary,
                             params_a=state.params_a, n_sats=self.n_sats,
                             dtx_bits=dtx_bits,
                             max_steps_per_pass=cfg.max_steps_per_pass,
                             min_fraction=cfg.min_fraction, plan=plan,
                             device=self.device)
        if self.plan.n_sats != self.n_sats:
            raise ValueError(f"plan covers {self.plan.n_sats} slots but the "
                             f"ring has {self.n_sats} satellites")
        self._host_plan = self.plan.to_host()
        if cfg.quantize_boundary and self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.load("split_quant")     # build before the first pass
        self._pass_step = make_pass_step(
            adapter, self.optimizer,
            quantize_boundary=cfg.quantize_boundary)
        self._batch_idx = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._programs: Dict[int, Callable] = {}
        self.metrics = MetricsRegistry("sim", parent=global_registry())
        self.metrics.gauge("n_sats").set(self.n_sats)
        self.recorder = FlightRecorder(self.metrics)
        self._passes_done = 0      # absolute pass count across chained runs

    @property
    def scan_steps(self) -> int:
        """Steps every pass executes (masked beyond its allocation)."""
        return self._scan_steps

    # ------------------------------------------------------- the program
    def _program(self, n_revolutions: int) -> Callable:
        """The closed loop for R revolutions, built once per R:
        ``(state, energy, bidx, ring) -> (state, energy, bidx, ring,
        PassTelemetry)``, all on the device, no host read."""
        fn = self._programs.get(n_revolutions)
        if fn is not None:
            return fn
        self.metrics.inc("traces")

        cfg, dev = self.cfg, self.device
        N, K, R = self.n_sats, self._scan_steps, n_revolutions
        pass_step, batch_fn, plan = self._pass_step, self.batch_fn, self.plan
        recharge_j = float(cfg.recharge_w * self.budget.plane.pass_duration_s)
        reserve, cap = float(cfg.reserve_j), float(cfg.battery_j)
        step_ids = torch.arange(K, dtype=torch.int32, device=dev)
        sats = torch.arange(N, dtype=torch.int64, device=dev)
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        one = torch.ones(1, dtype=torch.float32, device=dev)

        def pass_body(state, energy, bidx, ring, sat):
            # the energy policy first, as the host scheduler: below
            # reserve the whole pass is masked (the segment still moves on)
            skip = energy.battery_j.index_select(0, sat) < reserve
            n_valid = torch.where(skip, 0, torch.clamp(
                plan.n_steps.index_select(0, sat), max=K))
            losses = []
            for j in range(K):
                state, loss = pass_step(state, batch_fn(sat, bidx + j),
                                        (j < n_valid).reshape(()))
                losses.append(loss)
            valid = step_ids < n_valid
            loss = torch.where(
                skip, math.nan,
                torch.where(valid, torch.stack(losses), 0.0).sum()
                / torch.clamp(n_valid, min=1).to(torch.float32))
            kept = plan.kept_fraction.index_select(0, sat)
            energy = es_mod.apply_pass(
                energy, sat, plan.drain_j.index_select(0, sat),
                plan.e_total_j.index_select(0, sat), cap, ~skip)
            energy = es_mod.recharge(energy, recharge_j, cap)
            bidx = bidx + n_valid.reshape(())
            action = torch.where(skip, ACTION_SKIPPED, torch.where(
                kept < 1.0, ACTION_SHED, ACTION_TRAINED)).to(torch.int32)
            battery = energy.battery_j.index_select(0, sat)
            # flight recorder: one EV_PASS per pass, time = the ring's own
            # cursor (every pass records once), rebased by the host
            ring = ring_record(ring, EV_PASS, ring.cursor, sat, torch.cat([
                action.to(torch.float32), battery, loss,
                n_valid.to(torch.float32), kept, zero, one, zero]))
            return (state, energy, bidx, ring,
                    PassTelemetry(action, loss, battery,
                                  n_valid.to(torch.int32)))

        def closed_loop(state, energy, bidx, ring):
            telem = PassTelemetry(
                action=torch.zeros(R * N, dtype=torch.int32, device=dev),
                loss=torch.zeros(R * N, dtype=torch.float32, device=dev),
                battery_j=torch.zeros(R * N, dtype=torch.float32,
                                      device=dev),
                n_steps=torch.zeros(R * N, dtype=torch.int32, device=dev))
            for r in range(R):
                for s in range(N):
                    sat = sats[s:s + 1]
                    state, energy, bidx, ring, row = pass_body(
                        state, energy, bidx, ring, sat)
                    at = sat + r * N
                    for dst, v in zip(telem, row):
                        dst.index_copy_(0, at, v)
            return state, energy, bidx, ring, PassTelemetry(
                *[t.reshape(R, N) for t in telem])

        self._programs[n_revolutions] = closed_loop
        return closed_loop

    # --------------------------------------------------------------- run
    def run(self, n_revolutions: Optional[int] = None, *,
            stream_telemetry: bool = False) -> DeviceSimResult:
        """Run R closed-loop revolutions; chainable (state persists).

        ``stream_telemetry=True`` dispatches one revolution at a time and
        reads its telemetry (exactly one host sync per revolution); the
        default runs all R revolutions in one dispatch with one read at
        the end.
        """
        R = self.cfg.n_revolutions if n_revolutions is None else n_revolutions
        if R < 1:
            raise ValueError("need at least one revolution")
        self.state._require_live("device closed loop")
        state = dedupe_state_buffers(self.state)
        self.state.mark_consumed()
        energy, bidx = self.energy, self._batch_idx

        chunks = []
        r_chunk = 1 if stream_telemetry else R
        fn = self._program(r_chunk)
        for _ in range(R if stream_telemetry else 1):
            ring = ring_init(r_chunk * self.n_sats, device=self.device)
            t0 = time.perf_counter()
            with _no_host_sync(self.device):
                state, energy, bidx, ring, telem = fn(state, energy, bidx,
                                                      ring)
            # commit the carry per dispatch: an interrupted streaming
            # study keeps every finished revolution and stays chainable
            self.state, self.energy, self._batch_idx = state, energy, bidx
            self.metrics.inc("device_calls")
            host = _to_host(*telem, *energy, *ring)        # the ONE sync
            self.metrics.inc("host_syncs")
            self.metrics.histogram("dispatch_s").record(
                time.perf_counter() - t0)
            telem_h = PassTelemetry(*host[:4])
            energy_h = EnergyState(*host[4:8])
            self.recorder.ingest(TelemetryRing(*host[8:]),
                                 t_offset=self._passes_done)
            self._passes_done += r_chunk * self.n_sats
            chunks.append(telem_h)

        telem = PassTelemetry(*[np.concatenate(xs) for xs in zip(*chunks)])
        return DeviceSimResult(
            action=telem.action, loss=telem.loss,
            battery_j=telem.battery_j, n_steps=telem.n_steps,
            plan=self._host_plan, energy=energy_h, state=state)


def _smoke(argv=None) -> Dict[str, Any]:
    """``python -m repro_torch.sim.device_sim --smoke [--device cuda|cpu]``:
    the host engine against the device engine on a 4-satellite ring over
    16 passes (the reference smoke's config), with reserve skips: equal
    actions, the last loss within 2e-4, the energy within 1e-5, and one
    build and at most one sync per revolution. Runs on the card unless
    ``--device cpu`` is given; returns both summaries."""
    import argparse

    from repro_torch.core.constellation import (ConstellationConfig,
                                                ConstellationSim)
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.sim.data import DeviceImageryShards

    ap = argparse.ArgumentParser(prog="python -m repro_torch.sim.device_sim")
    ap.add_argument("--smoke", action="store_true",
                    help="the host-vs-device smoke (the only mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    shards = DeviceImageryShards(img=32, batch=4, device=args.device)
    adapter = autoencoder_adapter(cut=5, img=32)
    # n_items scales a pass's drain to ~48 J, so the 200 J batteries reach
    # the reserve-skip policy mid-run
    budget = PassBudget(plane=OrbitalPlane(n_sats=4), n_items=4e6)

    def sim():
        return ConstellationSim(adapter, budget, shards, ConstellationConfig(
            n_passes=16, batch_size=4, battery_j=200.0, recharge_w=0.01,
            reserve_j=150.0, max_steps_per_pass=4), device=args.device)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        host = sim()
        host.run()
        t1 = time.perf_counter()
        dev = sim()
        dev.run(engine="device")
        t2 = time.perf_counter()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    hs, ds = host.summary(), dev.summary()
    eng = dev.device_engine
    print(f"host   {t1 - t0:6.1f} s  {hs}")
    print(f"device {t2 - t1:6.1f} s  {ds}  (traces={eng.traces}, "
          f"syncs={eng.host_syncs})")
    actions = [(h.action, d.action) for h, d in zip(host.records,
                                                    dev.records)]
    if not all(h == d for h, d in actions):
        raise AssertionError(f"actions differ: {actions}")
    if not hs["skipped"] == ds["skipped"] > 0:
        raise AssertionError(f"no reserve skip, or skips differ: {actions}")
    if abs(ds["loss_last"] - hs["loss_last"]) > \
            2e-5 + 2e-4 * abs(hs["loss_last"]):
        raise AssertionError(f"last loss {ds['loss_last']} != host "
                             f"{hs['loss_last']}")
    if abs(ds["E_total_J"] - hs["E_total_J"]) > 1e-5 * abs(hs["E_total_J"]):
        raise AssertionError(f"energy {ds['E_total_J']} != host "
                             f"{hs['E_total_J']}")
    if eng.traces != 1 or eng.host_syncs > eng.cfg.n_revolutions:
        raise AssertionError("more than one host sync per revolution")
    print("device-sim smoke: OK (host == device closed loop)")
    return {"host": hs, "device": ds}


if __name__ == "__main__":
    import sys

    _smoke(sys.argv[1:])
