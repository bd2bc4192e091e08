"""The constellation as an inference fleet (the port of
``repro/serve_fleet/engine.py``).

Two layers, one battery:

* :class:`SplitDecodeEngine` runs continuous-batching greedy decode with
  the model cut at a unit boundary: the satellite half (embedding +
  units ``[0, cut)``) runs per-token decode and the boundary activation
  ``(B, 1, d_model)`` crosses the downlink every generated token; the
  ground half (units ``[cut, U)``, final norm, head) finishes the step.
  Slot mechanics and bulk prefill are inherited from
  :class:`repro_torch.serve.engine.DecodeEngine`; only the decode body
  changes. The serving cost model (:class:`ServeCost`,
  :func:`serve_cost`, :class:`TrainLoad`) prices a generated token in
  the satellite's joules.

* :class:`FleetServeEngine` is the pass-window serving loop at
  constellation scale, on the device: per window, Poisson arrivals
  (:mod:`repro_torch.serve_fleet.traffic`) are routed to the satellite
  overhead (:mod:`repro_torch.serve_fleet.router`), served FIFO up to
  the window's token capacity, and the decode energy is charged through
  the same :class:`~repro_torch.sim.energy_state.EnergyState` batteries
  training drains, so the reserve gates, the eclipse windows
  (:class:`~repro_torch.fleet.scenarios.EclipseConfig`) and
  train-vs-serve contention act on one battery. The reference runs it
  as one jitted ``lax.scan`` over windows, vmapped over planes; the
  port runs it eagerly over windows with the plane axis as a tensor
  axis, in the idiom of :mod:`repro_torch.fleet.engine`, with no host
  read inside a run (sync-debug "error" on the card) and one read at
  its end. A NumPy host oracle (:func:`host_oracle`) replays the f32
  accounting from the run's realized arrivals (see
  :func:`assert_host_parity`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane, PAPER_PLANE
from repro_torch.fleet.scenarios import EclipseConfig
from repro_torch.models import lm
from repro_torch.obs.metrics import (MetricsRegistry, counter_property,
                                     global_registry)
from repro_torch.obs.ring import EV_SERVE, FlightRecorder, TelemetryRing
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve_fleet import router
from repro_torch.serve_fleet.traffic import PassWindowTraffic, TrafficConfig
from repro_torch.sim import energy_state as es
from repro_torch.sim.device_sim import _no_host_sync, _to_host
from repro_torch.utils.treeutil import tree_leaves


class SplitDecodeEngine(DecodeEngine):
    """Greedy decode of the split model; token-identical to the unsplit
    :class:`DecodeEngine` (the same blocks run in the same order)."""

    def __init__(self, cfg, params, *, cut_units: int, **kw):
        self.cut_units = int(cut_units)
        lm.split_serve_params(cfg, params, self.cut_units)   # validate early
        super().__init__(cfg, params, **kw)
        self.params_sat, self.params_gnd = lm.split_serve_params(
            cfg, self.params, self.cut_units)

    def _decode_fn(self, tokens, positions):
        logits, _, _boundary = lm.decode_step_split(
            self.cfg, self.params_sat, self.params_gnd, self.cache, tokens,
            positions, ctx=self.ctx)
        return logits

    @property
    def boundary_bits_per_token(self) -> float:
        """Downlink payload per generated token per request: the boundary
        activation ``(d_model,)`` at the engine's activation dtype."""
        return float(self.cfg.d_model * self.act_dtype.itemsize * 8)


def measure_decode_rate(engine: DecodeEngine, *, n_requests: int = 32,
                        prompt_len: int = 6, new_tokens: int = 12,
                        vocab: Optional[int] = None, seed: int = 0,
                        warmup: bool = True) -> float:
    """Sustained generated-tokens/sec of one engine, wall clock over a
    continuous-batching run (prefill included), synchronized with the
    device at both ends."""
    vocab = engine.cfg.vocab if vocab is None else vocab
    rng = np.random.default_rng(seed)

    def batch(n, rid0):
        return [Request(rid=rid0 + i,
                        prompt=rng.integers(0, vocab, prompt_len)
                        .astype(np.int32),
                        max_new_tokens=new_tokens) for i in range(n)]

    if warmup:                      # first kernel launches build and load
        engine.submit_and_run(batch(min(2, n_requests), 10_000_000))
    reqs = batch(n_requests, 0)
    _sync(engine.device)
    t0 = time.perf_counter()
    out = engine.submit_and_run(reqs)
    _sync(engine.device)
    dt = time.perf_counter() - t0
    return sum(len(v) for v in out.values()) / dt


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Serving cost model (per generated token, satellite side).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeCost:
    """What one generated token costs the serving satellite.

    ``tokens_per_s`` is the measured (or assumed) sustained decode rate
    of one satellite, which caps each pass window's service;
    ``e_token_j`` is the battery draw per token (eq.-(7) DVFS compute
    of the satellite half + eq.-(9) downlink energy of the boundary
    activation); ``dtx_bits_token`` is that boundary payload.
    """

    tokens_per_s: float
    e_token_j: float
    dtx_bits_token: float

    def window_capacity_requests(self, window_s: float,
                                 tokens_per_request: float) -> float:
        """Whole requests one pass window can serve (the reference's f32
        floor)."""
        toks = np.float32(self.tokens_per_s) * np.float32(window_s)
        return float(np.floor(toks / np.float32(tokens_per_request)))


def serve_cost(cfg, params, cut_units: int, *, tokens_per_s: float,
               budget: Optional[PassBudget] = None,
               tx_power_w: float = 2.0,
               act_bits: Optional[int] = None) -> ServeCost:
    """Analytic per-token satellite cost of the split model.

    The satellite half's decode FLOPs per token are ``2 x`` its unit
    parameter count (``units`` plus Zamba2's ``shared`` block; the
    embedding gather is free); compute energy follows the paper's DVFS
    model at ``f_max``, downlink energy the Shannon link at
    ``tx_power_w`` over the mean slant range.
    """
    budget = PassBudget() if budget is None else budget
    pa, _ = lm.split_serve_params(cfg, params, cut_units)
    n_params = sum(t.numel() for t in tree_leaves(pa["units"]))
    if "shared" in pa:
        n_params += sum(t.numel() for t in tree_leaves(pa["shared"]))
    flops_tok = 2.0 * n_params
    e_proc = budget.sat_device.proc_energy_j(
        flops_tok, budget.sat_device.f_max_hz, 1.0)
    bits = float(cfg.d_model * (32 if act_bits is None else act_bits))
    e_comm = budget.link.comm_energy_j(bits, tx_power_w,
                                       budget.mean_distance_m)
    return ServeCost(tokens_per_s=float(tokens_per_s),
                     e_token_j=float(e_proc + e_comm),
                     dtx_bits_token=bits)


@dataclasses.dataclass(frozen=True)
class TrainLoad:
    """One planned training pass per serving window, energy only: the
    drain the planner priced for the training fleet."""

    drain_j: float       # satellite-side battery draw per training pass
    e_total_j: float     # full eq.-(11) cost recorded per pass

    @classmethod
    def from_plan(cls, plan) -> "TrainLoad":
        """Mean per-satellite load of a ``DevicePassPlan`` (or anything
        with ``drain_j`` / ``e_total_j`` tensors or arrays)."""
        mean = lambda a: float(np.mean(a.cpu().numpy()  # noqa: E731
                                       if isinstance(a, torch.Tensor)
                                       else np.asarray(a)))
        return cls(drain_j=mean(plan.drain_j), e_total_j=mean(plan.e_total_j))


# --------------------------------------------------------------------------
# Fleet-scale serving loop.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeFleetConfig:
    """Constellation + battery policy for the serving fleet."""

    n_planes: int = 1
    n_sats: int = 8                       # ring slots per plane
    n_windows: int = 64                   # pass windows per run
    battery_j: float = 500.0              # capacity (and initial charge)
    recharge_w: float = 20.0              # solar input while sunlit
    reserve_serve_j: float = 0.0          # serving gate: min charge to serve
    reserve_train_j: float = 0.0          # training gate (reserve-skip)
    eclipse: Optional[EclipseConfig] = None
    plane: OrbitalPlane = PAPER_PLANE
    window_s: Optional[float] = None      # None -> plane.pass_duration_s

    @property
    def pass_window_s(self) -> float:
        return (self.plane.pass_duration_s if self.window_s is None
                else self.window_s)


class ServeTelemetry(NamedTuple):
    """Per-(window, plane) serving telemetry."""

    arrivals: Any         # int32 — Poisson arrivals this window
    served: Any           # f32   — requests served this window
    backlog: Any          # f32   — queue carried to the next satellite
    tokens: Any           # f32   — generated tokens this window
    battery_j: Any        # f32   — serving slot's charge, post-recharge
    slot: Any             # int32 — which satellite was overhead
    trained: Any          # int32 — 1 trained / 0 reserve-skipped / -1 n/a


_TELEMETRY_DTYPES = (torch.int32, torch.float32, torch.float32,
                     torch.float32, torch.float32, torch.int32, torch.int32)


@dataclasses.dataclass
class ServeFleetResult:
    """One run's telemetry, ``(P, K)`` host arrays."""

    cfg: ServeFleetConfig
    cost: ServeCost
    traffic: PassWindowTraffic
    arrivals: np.ndarray
    served: np.ndarray
    backlog: np.ndarray
    tokens: np.ndarray
    battery_j: np.ndarray
    slot: np.ndarray
    trained: np.ndarray
    energy: es.EnergyState          # final (P, M) state, host arrays
    run_s: float = float("nan")

    @property
    def window_s(self) -> float:
        return self.cfg.pass_window_s

    def sustained_tokens_per_s(self) -> float:
        """Fleet-wide generated tokens per wall-second of orbit time."""
        K = self.arrivals.shape[1]
        return float(self.tokens.sum() / (K * self.window_s))

    def request_service_s(self) -> float:
        """One request's own decode time on the serving satellite."""
        return float(self.traffic.cfg.decode_len / self.cost.tokens_per_s)

    def p99_latency_s(self, q: float = 0.99) -> float:
        """FIFO latency quantile over every served request, all planes."""
        waits = [router.fifo_latency_windows(self.arrivals[p],
                                             self.served[p])
                 for p in range(self.arrivals.shape[0])]
        waits = np.concatenate(waits) if waits else np.zeros((0,))
        if waits.size == 0:
            return float("nan")
        lat = waits * self.window_s + self.request_service_s()
        return float(np.quantile(lat, q))

    def summary(self) -> Dict[str, Any]:
        trained = self.trained[self.trained >= 0]
        return {
            "n_planes": self.cfg.n_planes,
            "n_sats": self.cfg.n_sats,
            "n_windows": int(self.arrivals.shape[1]),
            "window_s": self.window_s,
            "offered_users_per_day": self.traffic.cfg.users_per_day,
            "arrived_requests": int(self.arrivals.sum()),
            "served_requests": float(self.served.sum()),
            "final_backlog_requests": float(self.backlog[:, -1].sum()),
            "sustained_tokens_per_s": self.sustained_tokens_per_s(),
            "p99_latency_s": self.p99_latency_s(),
            "serve_energy_spent_j": float(
                np.sum(self.energy.energy_spent_j)),
            "trained_passes": int(trained.sum()) if trained.size else None,
            "skipped_passes": (int((trained == 0).sum())
                               if trained.size else None),
            "min_battery_j": float(self.battery_j.min())
            if self.battery_j.size else float("nan"),
        }


class FleetServeEngine:
    """The pass-window serving loop on the device (chainable runs).

    Per run, the arrivals are realized on the host by the traffic
    (``realize(K, start=k)`` on the absolute window index, so chained
    runs continue one stream) and copied to the device once, with the
    eclipse flags; the NumPy oracle replays the same array. Each window
    then computes, for all planes at once: the serving slot (the ring
    rotation), FIFO service up to the window's request capacity,
    ``apply_serve`` for the decode drain, the optional concurrent
    :class:`TrainLoad` through ``apply_pass`` (the reserve skip reads
    the post-serve battery: that is the contention), and the
    eclipse-gated ``recharge`` last. The window index is a host int; the
    slot, the gates and every joule are tensors, so nothing reads the
    device inside a run (on the card it runs under sync-debug "error").
    Every window gives one ``EV_SERVE`` per plane: after the last window
    the run's telemetry is written, at once, into one flat telemetry
    ring per plane (a ``(P, K)`` ring); the telemetry, the final state
    and the rings come home in ONE read at the end of the run, and the
    rings are flushed into ``self.recorder`` there.

    ``traces`` (programs built, one per distinct window count),
    ``device_calls`` and ``host_syncs`` (one per run) live on
    ``self.metrics`` (namespace ``serve_fleet``). ``device`` is the card
    unless the caller asks for the CPU.
    """

    traces = counter_property("traces")
    device_calls = counter_property("device_calls")
    host_syncs = counter_property("host_syncs")

    def __init__(self, cfg: ServeFleetConfig, traffic: TrafficConfig,
                 cost: ServeCost, *, train: Optional[TrainLoad] = None,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.cost = cost
        self.train = train
        self.traffic = PassWindowTraffic(traffic, cfg.pass_window_s,
                                         cfg.n_planes)
        P, M = cfg.n_planes, cfg.n_sats
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.energy = es.EnergyState(
            battery_j=torch.full((P, M), cfg.battery_j, **f32),
            energy_spent_j=torch.zeros((P, M), **f32),
            passes_served=torch.zeros((P, M), **i32),
            passes_skipped=torch.zeros((P, M), **i32))
        self.backlog = torch.zeros((P,), **f32)
        self.k = 0
        self.metrics = MetricsRegistry("serve_fleet",
                                       parent=global_registry())
        self.metrics.gauge("n_planes").set(P)
        self.metrics.gauge("n_sats").set(M)
        self.recorder = FlightRecorder(self.metrics)
        self._programs: Dict[int, Callable] = {}
        # f32 constants shared verbatim with the host oracle
        self._c = serve_constants(cfg, self.traffic, cost, train)

    # ------------------------------------------------------- the program
    def _program(self, n_windows: int) -> Callable:
        """The serving loop over K windows, built once per K:
        ``(backlog, energy, k0, xs) -> (backlog, energy, (P, K)
        EV_SERVE ring, ServeTelemetry of (K, P) tensors)``, where ``xs``
        is the run's ``(2, K, P)`` int32 input (arrivals, sunlit flags)
        and ``k0`` the absolute index of its first window (a host int)."""
        fn = self._programs.get(n_windows)
        if fn is not None:
            return fn
        self.metrics.inc("traces")
        cfg, train, dev = self.cfg, self.train, self.device
        P, M, K = cfg.n_planes, cfg.n_sats, n_windows
        c = {k: float(v) for k, v in self._c.items()}   # exact in f32
        member = torch.ones((P, M), dtype=torch.bool, device=dev)
        untrained = torch.full((P,), -1, dtype=torch.int32, device=dev)
        cap_req = torch.full((P,), c["cap_req"], dtype=torch.float32,
                             device=dev)

        def closed_loop(backlog, energy, k0, xs):
            arrivals, lit = xs[0], xs[1].to(torch.bool)
            telem = ServeTelemetry(*[torch.empty((K, P), dtype=dt,
                                                 device=dev)
                                     for dt in _TELEMETRY_DTYPES])
            for i in range(K):
                k = k0 + i
                a_i = arrivals[i]
                slot = router.serving_slot_torch(member, k)
                at = slot[:, None].long()
                serve_ok = (energy.battery_j.gather(1, at)[:, 0]
                            >= c["reserve_serve"])
                served, backlog = router.drain_queue_torch(
                    backlog, a_i.to(torch.float32), c["cap_req"], serve_ok)
                tokens = served * c["tok_per_req"]
                energy = es.apply_serve(energy, slot, tokens * c["e_token"],
                                        c["capacity"])
                trained = untrained
                if train is not None:
                    # contention: the reserve-skip gate reads the
                    # POST-serve battery, so serving drain is what flips
                    # a trained pass into a skip
                    trains = (energy.battery_j.gather(1, at)[:, 0]
                              >= c["reserve_train"])
                    energy = es.apply_pass(
                        energy, slot, c["train_drain"], c["train_e_total"],
                        c["capacity"], trains)
                    trained = trains.to(torch.int32)
                energy = es.recharge(energy, c["recharge"], c["capacity"],
                                     sunlit=lit[i][:, None])
                battery = energy.battery_j.gather(1, at)[:, 0]
                row = ServeTelemetry(a_i, served, backlog, tokens, battery,
                                     slot, trained)
                for dst, v in zip(telem, row):
                    dst[i].copy_(v)
            # flight recorder: one EV_SERVE per (plane, window), t the
            # absolute window index, written as P full flat rings of K
            # events (SERVE_FIELDS' 8 payload columns)
            payload = torch.stack([
                telem.arrivals.to(torch.float32), telem.battery_j,
                telem.served, telem.backlog, telem.tokens,
                telem.trained.to(torch.float32), lit.to(torch.float32),
                cap_req.expand(K, P)], dim=-1)
            i32 = dict(dtype=torch.int32, device=dev)
            ring = TelemetryRing(
                kind=torch.full((P, K), EV_SERVE, **i32),
                t=torch.arange(k0, k0 + K, **i32).expand(P, K),
                slot=telem.slot.T, payload=payload.transpose(0, 1),
                cursor=torch.full((P,), K, **i32))
            return backlog, energy, ring, telem

        self._programs[n_windows] = closed_loop
        return closed_loop

    def _inputs(self, n_windows: int) -> torch.Tensor:
        """The run's arrivals (from the traffic, at the absolute window
        offset) and eclipse flags (``sunlit(k, plane)`` on host ints) as
        one ``(2, K, P)`` int32 tensor: one host-to-device copy a run."""
        P, k0 = self.cfg.n_planes, self.k
        arr = np.asarray(self.traffic.realize(n_windows, start=k0),
                         np.int32).T
        ecl = self.cfg.eclipse
        lit = np.ones((n_windows, P), np.int32)
        if ecl is not None:
            lit[:] = [[bool(ecl.sunlit(k, p)) for p in range(P)]
                      for k in range(k0, k0 + n_windows)]
        return torch.from_numpy(np.stack([arr, lit])).to(self.device)

    # --------------------------------------------------------------- run
    def run(self, n_windows: Optional[int] = None) -> ServeFleetResult:
        K = self.cfg.n_windows if n_windows is None else n_windows
        if K < 1:
            raise ValueError("need at least one pass window")
        fn = self._program(K)
        xs = self._inputs(K)
        t0 = time.perf_counter()
        self.metrics.inc("device_calls")
        with _no_host_sync(self.device):
            backlog, energy, ring, telem = fn(self.backlog, self.energy,
                                              self.k, xs)
        host = _to_host(*telem, *energy, *ring)             # the ONE sync
        self.metrics.inc("host_syncs")
        dt = time.perf_counter() - t0
        self.metrics.histogram("dispatch_s").record(dt)
        # the ring flush rides the same sync
        self.recorder.ingest(TelemetryRing(*host[11:]))
        self.backlog, self.energy, self.k = backlog, energy, self.k + K
        t = ServeTelemetry(*[a.T for a in host[:7]])      # (K, P) -> (P, K)
        return ServeFleetResult(
            cfg=self.cfg, cost=self.cost, traffic=self.traffic,
            arrivals=t.arrivals, served=t.served, backlog=t.backlog,
            tokens=t.tokens, battery_j=t.battery_j, slot=t.slot,
            trained=t.trained, energy=es.EnergyState(*host[7:11]), run_s=dt)


# --------------------------------------------------------------------------
# NumPy host oracle (f32 energy parity).
# --------------------------------------------------------------------------

def serve_constants(cfg: ServeFleetConfig, traffic: PassWindowTraffic,
                    cost: ServeCost,
                    train: Optional[TrainLoad]) -> Dict[str, np.float32]:
    """Every scalar the serving loop folds into its f32 arithmetic,
    rounded to f32 ONCE so the device loop and the NumPy oracle consume
    the same constants."""
    w = traffic.window_s
    c = {
        "capacity": cfg.battery_j,
        "recharge": cfg.recharge_w * w,
        "reserve_serve": cfg.reserve_serve_j,
        "reserve_train": cfg.reserve_train_j,
        "tok_per_req": traffic.cfg.tokens_per_request,
        "e_token": cost.e_token_j,
        "cap_req": cost.window_capacity_requests(
            w, traffic.cfg.tokens_per_request),
        "train_drain": 0.0 if train is None else train.drain_j,
        "train_e_total": 0.0 if train is None else train.e_total_j,
    }
    return {k: np.float32(v) for k, v in c.items()}


def host_oracle(cfg: ServeFleetConfig, traffic: PassWindowTraffic,
                cost: ServeCost, train: Optional[TrainLoad],
                n_windows: int,
                arrivals: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
    """Replay ``n_windows`` serving windows from a fresh fleet in NumPy
    f32 scalars (same arrivals, same constants (:func:`serve_constants`),
    same order of operations) and return the telemetry the device loop
    must reproduce (see :func:`assert_host_parity`).

    ``arrivals`` defaults to the traffic from window 0
    (``traffic.realize(n_windows)``, what a fresh fleet's first run
    consumes); pass an explicit array to replay another stream, e.g. a
    chained run's ``result.arrivals``.
    """
    P, M = cfg.n_planes, cfg.n_sats
    c = serve_constants(cfg, traffic, cost, train)
    arr = (traffic.realize(n_windows) if arrivals is None
           else np.asarray(arrivals, np.int32))        # (P, K) int32
    f32 = np.float32
    battery = np.full((P, M), f32(cfg.battery_j), f32)
    spent = np.zeros((P, M), f32)
    srv = np.zeros((P, M), np.int32)
    skp = np.zeros((P, M), np.int32)
    backlog = np.zeros((P,), f32)
    t_served = np.zeros((P, n_windows), f32)
    t_backlog = np.zeros((P, n_windows), f32)
    t_tokens = np.zeros((P, n_windows), f32)
    t_battery = np.zeros((P, n_windows), f32)
    t_trained = np.full((P, n_windows), -1, np.int32)
    for k in range(n_windows):
        for p in range(P):
            slot = int(router.serving_slot(np.ones((M,), bool), k))
            ok = battery[p, slot] >= c["reserve_serve"]
            served, backlog[p] = router.drain_queue(
                backlog[p], f32(arr[p, k]), c["cap_req"], ok)
            tokens = f32(served * c["tok_per_req"])
            drain = f32(tokens * c["e_token"])
            battery[p, slot] = clamp_battery_f32(
                f32(battery[p, slot] - drain), c["capacity"])
            spent[p, slot] = f32(spent[p, slot] + drain)
            if train is not None:
                trains = battery[p, slot] >= c["reserve_train"]
                if trains:
                    battery[p, slot] = clamp_battery_f32(
                        f32(battery[p, slot] - c["train_drain"]),
                        c["capacity"])
                    spent[p, slot] = f32(spent[p, slot]
                                         + c["train_e_total"])
                    srv[p, slot] += 1
                else:
                    skp[p, slot] += 1
                t_trained[p, k] = int(trains)
            sunlit = (True if cfg.eclipse is None
                      else bool(cfg.eclipse.sunlit(k, p)))
            if sunlit:
                battery[p] = np.minimum(
                    np.maximum(battery[p] + c["recharge"], f32(0.0)),
                    c["capacity"])
            t_served[p, k] = served
            t_backlog[p, k] = backlog[p]
            t_tokens[p, k] = tokens
            t_battery[p, k] = battery[p, slot]
    return {"arrivals": arr, "served": t_served, "backlog": t_backlog,
            "tokens": t_tokens, "battery_j": t_battery,
            "trained": t_trained, "final_battery_j": battery,
            "energy_spent_j": spent, "passes_served": srv,
            "passes_skipped": skp}


def clamp_battery_f32(battery: np.float32, capacity: np.float32):
    """f32 scalar twin of :func:`repro_torch.core.energy.clamp_battery`
    (max-then-min, in NumPy f32)."""
    return np.minimum(np.maximum(battery, np.float32(0.0)), capacity)


def assert_host_parity(result: ServeFleetResult,
                       train: Optional[TrainLoad]) -> Dict[str, np.ndarray]:
    """Assert the host-vs-device parity contract for a fresh fleet's
    first run and return the oracle telemetry.

    Routing and counting are exact: arrivals (the engine and the oracle
    consume the same realized array), served/backlog/token counts (all
    integer-valued f32), the trained/skipped decisions and the pass
    counters. The joule accumulators (the battery trajectory,
    ``energy_spent_j``) are held at the reference's f32 tolerance, rtol
    1e-5 and atol 1e-6 (its XLA scan fuses multiply-adds into FMAs the
    NumPy replay cannot reproduce; the port's eager loop does not fuse,
    but the gate stays the reference's). Battery trajectories must also
    sit in ``[0, capacity]``, the clamp policy's invariant.
    """
    K = result.arrivals.shape[1]
    o = host_oracle(result.cfg, result.traffic, result.cost, train, K)
    np.testing.assert_array_equal(result.arrivals, o["arrivals"])
    np.testing.assert_array_equal(result.served, o["served"])
    np.testing.assert_array_equal(result.tokens, o["tokens"])
    np.testing.assert_array_equal(result.backlog, o["backlog"])
    np.testing.assert_array_equal(result.trained, o["trained"])
    np.testing.assert_array_equal(np.asarray(result.energy.passes_served),
                                  o["passes_served"])
    np.testing.assert_array_equal(np.asarray(result.energy.passes_skipped),
                                  o["passes_skipped"])
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(result.battery_j, o["battery_j"], **tol)
    np.testing.assert_allclose(np.asarray(result.energy.battery_j),
                               o["final_battery_j"], **tol)
    np.testing.assert_allclose(np.asarray(result.energy.energy_spent_j),
                               o["energy_spent_j"], **tol)
    assert float(result.battery_j.min()) >= 0.0
    assert float(result.battery_j.max()) <= result.cfg.battery_j
    return o
