"""The metered inter-plane exchange of the fleet engine (the port of
``repro/isl/exchange.py``).

Without it the fleet's inter-plane exchange is a free, instantaneous
full-float average of the planes at revolution boundaries
(``FleetConfig.exchange=None``). This module models the link:

* **async gossip** (``mode="async"``): at every contact window
  (:class:`~repro_torch.isl.link.ContactConfig`) each plane pushes its
  compressed checkpoint delta (:mod:`repro_torch.isl.codec`) to the
  contacted plane and merges what it received with the
  staleness-discounted weight ``mix / (1 + lam * staleness)``: no
  barrier, and no precomputed horizon;
* **sync codec** (``mode="sync"``): the revolution-boundary aggregation,
  over compressed delta reconstructions instead of free full-float
  checkpoints; with ``scheme="none"`` it is the free average bit for bit.

Either way the payload is charged: the push's transmit energy ``isl_pw *
bits / rate`` drains the serving satellite's battery (the
:class:`~repro_torch.sim.energy_state.EnergyState` that training shares),
a payload larger than the contact's ``rate * window_s`` capacity does not
transfer at all, and the amortized bits per pass feed the planner's
problem-(13) ``d_isl_bits`` term
(:func:`repro_torch.sim.device_sim.measure_and_plan`,
``isl_extra_bits=``).

The fleet's planes are a list of P
:class:`~repro_torch.core.train_state.SLTrainState`; the steps write the
merged parameters into each plane's tensors in place. The pass index
``k`` is a host int, so whether a window opens, its offset and the
sender of each plane are Python decisions; whether a plane pays depends
on its pass's action and stays a device select. Nothing reads the
device. :func:`oracle_exchange` replays every contact in NumPy, bit for
bit, over the precomputed horizon, beside
:func:`repro_torch.fleet.scenarios.oracle_actions`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.energy import clamp_battery
from repro_torch.core.train_state import _leaves
from repro_torch.isl.codec import CodecConfig, encode_delta, residual_init
from repro_torch.isl.link import ContactConfig
from repro_torch.obs.ring import EV_EXCHANGE, record as ring_record
from repro_torch.train.compression import tree_map

EXCHANGE_MODES = ("sync", "async")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """How the fleet's planes exchange checkpoints over the ISL.

    ``mode="sync"`` keeps the revolution-boundary cadence
    (``FleetConfig.avg_every``) through the codec and the meter;
    ``mode="async"`` replaces the barrier with contact-window gossip.
    ``mix`` is the merge weight of a received delta at zero staleness;
    ``staleness_lam`` discounts it as ``mix / (1 + lam * s)``, ``s`` the
    passes since the sender's previous push.
    """

    mode: str = "async"
    codec: CodecConfig = CodecConfig()
    contact: ContactConfig = ContactConfig()
    mix: float = 0.5
    staleness_lam: float = 0.1

    def __post_init__(self):
        if self.mode not in EXCHANGE_MODES:
            raise ValueError(f"unknown exchange mode {self.mode!r}; "
                             f"expected one of {EXCHANGE_MODES}")
        if not 0.0 < self.mix <= 1.0:
            raise ValueError(f"mix must be in (0, 1], got {self.mix}")
        if self.staleness_lam < 0.0:
            raise ValueError(f"staleness_lam must be >= 0, "
                             f"got {self.staleness_lam}")

    def mean_contacts_per_pass(self, rev_len: int, avg_every: int) -> float:
        """Exchanges per pass, amortized: what scales one push's bits
        into the planner's per-pass ``d_isl_bits`` surcharge."""
        if self.mode == "async":
            return 1.0 / float(self.contact.period)
        if avg_every <= 0:
            return 0.0
        return 1.0 / float(avg_every * rev_len)


class ExchangeState(NamedTuple):
    """What the exchange carries across passes.

    ``anchor[p]`` is plane ``p``'s last pushed checkpoint ``(params_a,
    params_b)`` (its next delta is taken against it), ``residual[p]`` its
    codec's error-feedback carry (f32), ``last_k`` the pass of each
    plane's last push (staleness = pass - ``last_k``); ``bits``, ``e_j``
    and ``n_contacts`` are the cumulative wire meter. The trees are
    lists of P (empty when the exchange is off); the rest ``(P,)``
    tensors.
    """

    anchor: Any        # P x (params_a, params_b)
    residual: Any      # P x the same trees, f32
    last_k: Any        # (P,) int32
    bits: Any          # (P,) float32 cumulative pushed wire bits
    e_j: Any           # (P,) float32 cumulative ISL transmit joules
    n_contacts: Any    # (P,) int32 pushes


def _meters(n_planes: int, device) -> dict:
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(last_k=torch.zeros((n_planes,), **i32),
                bits=torch.zeros((n_planes,), **f32),
                e_j=torch.zeros((n_planes,), **f32),
                n_contacts=torch.zeros((n_planes,), **i32))


def exchange_init(params_trees, n_planes: int) -> ExchangeState:
    """A fresh exchange state for the planes' ``(params_a, params_b)``
    trees (a list of P): anchors start at the current checkpoints (the
    first delta is the training since the run began)."""
    if len(params_trees) != n_planes:
        raise ValueError(f"{len(params_trees)} trees for {n_planes} planes")
    dev = _leaves(params_trees[0])[0].device
    return ExchangeState(
        anchor=[tree_map(torch.clone, t) for t in params_trees],
        residual=[residual_init(t) for t in params_trees],
        **_meters(n_planes, dev))


def null_exchange_state(n_planes: int, device="cuda") -> ExchangeState:
    """The state of a fleet without an exchange: no trees, zero meters."""
    return ExchangeState(anchor=[], residual=[],
                         **_meters(n_planes, device))


def staleness_weight(stale, mix: float, lam: float, xp=np):
    """THE merge-weight rule ``mix / (1 + lam * s)``, f32 throughout:
    NumPy (``xp=np``, the oracle) or a tensor (``xp=torch``, the engine),
    each operation one IEEE f32 operation, so both give the same bits."""
    if xp is np:
        s = np.asarray(stale, np.float32)
        return np.float32(mix) / (np.float32(1.0) + np.float32(lam) * s)
    s = stale.to(torch.float32)
    return torch.full_like(s, mix) / (
        torch.ones_like(s) + torch.full_like(s, lam) * s)


def _charge(energy, slot, drain, cap: float):
    """Drain ``drain[p]`` joules from plane ``p``'s serving slot:
    subtract-then-clamp on the whole (P, M) battery (the other entries
    subtract exactly 0.0), as the oracle replays it."""
    M = energy.battery_j.shape[-1]
    hit = (torch.arange(M, device=slot.device)[None, :]
           == torch.clamp(slot, 0, M - 1)[:, None])
    d2 = torch.where(hit, drain[:, None], 0.0)
    return energy._replace(
        battery_j=clamp_battery(energy.battery_j - d2, cap),
        energy_spent_j=energy.energy_spent_j + d2)


def _params(states):
    return [(st.params_a, st.params_b) for st in states]


def _pay(ex: ExchangeState, action, action_failed: int, e_push_j: float):
    """Which planes pay this exchange (a plane whose pass FAILED has no
    transmitter up) and what each drains, (P,) bool and f32."""
    pays = action != action_failed
    drain = torch.where(pays, torch.full_like(ex.e_j, e_push_j),
                        torch.zeros_like(ex.e_j))
    return pays, drain


def _record(rings, k, sat, pays, columns):
    slot_rec = torch.where(pays, sat, -1).to(torch.int32)
    payload = torch.stack(columns, dim=1)
    return [ring_record(r, EV_EXCHANGE, k, slot_rec[p], payload[p])
            for p, r in enumerate(rings)]


def aggregate_into(states, mode: str, params_from=None) -> None:
    """The inter-plane aggregation, in place: every floating leaf of every
    plane's state (parameters and optimizer state) becomes the planes'
    :func:`~repro_torch.fleet.scenarios.plane_center`; integer leaves (the
    step counters) stay per plane. With ``params_from`` (P trees shaped
    ``(params_a, params_b)``) the parameters' center is taken over those
    trees instead of the states' own parameters."""
    from repro_torch.fleet.scenarios import plane_center

    n_par = len(_leaves(_params(states[:1])))
    src = (None if params_from is None
           else list(zip(*[_leaves(t) for t in params_from])))
    for i, col in enumerate(zip(*[_leaves(s._fields()) for s in states])):
        if not col[0].is_floating_point():
            continue
        pick = col if src is None or i >= n_par else src[i]
        c = plane_center(torch.stack(pick), mode)
        for x in col:
            x.copy_(c)


def async_gossip_step(exch: ExchangeConfig, states, ex: ExchangeState,
                      energy, rings, k: int, sat, action, *,
                      wire_bits: float, e_push_j: float, battery_cap: float,
                      n_planes: int, action_failed: int):
    """One contact-window attempt after pass ``k`` (a host int).

    A shut window does nothing. An open one, for every plane at once:
    (1) delta-encode its checkpoint against its anchor, every plane
    before any merge; (2) push to plane ``(p + offset) % P``; (3) merge
    the delta received from ``(p - offset) % P`` with the
    staleness-discounted weight, into the plane's parameters in place;
    (4) pay the transmit energy from the serving slot's battery (a plane
    whose pass FAILED drains nothing, and still merges); (5) record one
    ``EV_EXCHANGE`` per plane. Returns ``(states, ex, energy, rings)``.
    """
    P = n_planes
    cc = exch.contact
    if not cc.open_at(k):
        return states, ex, energy, rings
    off = int(cc.offset_at(k))
    params = _params(states)
    enc = [encode_delta(params[p], ex.anchor[p], ex.residual[p],
                        exch.codec) for p in range(P)]
    anchor = [tree_map(torch.clone, t) for t in params]      # pre-merge
    stale = (k - ex.last_k).to(torch.float32)
    stale_r = torch.roll(stale, off)             # stale_r[p] = stale[p-off]
    w = staleness_weight(stale_r, exch.mix, exch.staleness_lam, xp=torch)
    for p in range(P):
        recv = enc[(p - off) % P][0]
        for x, d in zip(_leaves(params[p]), _leaves(recv)):
            x.copy_((x.float() + w[p] * d).to(x.dtype))

    pays, drain = _pay(ex, action, action_failed, e_push_j)
    energy = _charge(energy, sat, drain, battery_cap)
    ex = ExchangeState(
        anchor=anchor, residual=[e[1] for e in enc],
        last_k=torch.full_like(ex.last_k, k),
        bits=ex.bits + torch.full_like(ex.bits, wire_bits),
        e_j=ex.e_j + drain, n_contacts=ex.n_contacts + 1)
    rings = _record(rings, k, sat, pays, [
        torch.zeros_like(drain), torch.full_like(drain, wire_bits), drain,
        stale_r, w])
    return states, ex, energy, rings


def sync_exchange_step(exch: ExchangeConfig, aggregate_mode: str, states,
                       ex: ExchangeState, energy, rings, k: int, sat,
                       action, do: bool, *, wire_bits: float,
                       e_push_j: float, battery_cap: float, n_planes: int,
                       action_failed: int):
    """The revolution-boundary exchange, codec'd and metered; ``k`` is the
    boundary (the next pass's index) and ``do`` whether this boundary
    exchanges (host values).

    Optimizer state aggregates as the free average does; the parameters
    travel as compressed delta reconstructions ``anchor + delta_hat``.
    With ``scheme="none"`` the reconstruction is the live checkpoint, so
    the merged state is the free average's bit for bit, while the meter
    still charges the full-float bits. ``sat`` and ``action`` are the
    last pass's (the payer).
    """
    if not do:
        return states, ex, energy, rings
    P = n_planes
    stale = (k - ex.last_k).to(torch.float32)
    if exch.codec.scheme == "none":
        resid = ex.residual
        aggregate_into(states, aggregate_mode)
    else:
        params = _params(states)
        enc = [encode_delta(params[p], ex.anchor[p], ex.residual[p],
                            exch.codec) for p in range(P)]
        resid = [e[1] for e in enc]
        recon = [tree_map(lambda a, d: a + d, ex.anchor[p], enc[p][0])
                 for p in range(P)]
        aggregate_into(states, aggregate_mode, params_from=recon)

    pays, drain = _pay(ex, action, action_failed, e_push_j)
    energy = _charge(energy, sat, drain, battery_cap)
    ex = ExchangeState(
        anchor=[tree_map(torch.clone, t) for t in _params(states)],
        residual=resid, last_k=torch.full_like(ex.last_k, k),
        bits=ex.bits + torch.full_like(ex.bits, wire_bits),
        e_j=ex.e_j + drain, n_contacts=ex.n_contacts + 1)
    rings = _record(rings, k, sat, pays, [
        torch.ones_like(drain), torch.full_like(drain, wire_bits), drain,
        stale, torch.full_like(drain, np.float32(1.0 / P))])
    return states, ex, energy, rings


# --------------------------------------------------------------------------
# The NumPy oracle (the style of fleet.scenarios.oracle_actions)
# --------------------------------------------------------------------------

def oracle_exchange(fleet, n_passes: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """Replay every contact and merge decision of ``fleet``'s exchange over
    the precomputed horizon, bit for bit, before the fleet runs.

    One row per exchange: ``t`` (the pass index as the ring records it),
    ``offset`` (the plane-pair offset; 0 for sync), ``aggregate`` (1.0
    sync, 0.0 async) and per plane ``slot`` (the paying transmitter, -1
    where that plane's pass FAILED), ``bits``, ``e_isl_j`` (the joules
    drained), ``staleness`` and ``weight``: the ``EV_EXCHANGE`` payload
    columns the fleet's rings must hold, in order. A fleet without an
    exchange (or with a payload over the contact capacity) has no rows.
    """
    from repro_torch.fleet.scenarios import oracle_actions
    from repro_torch.sim.device_sim import ACTION_FAILED

    P = fleet.n_planes
    empty = {"t": np.zeros((0,), np.int32),
             "offset": np.zeros((0,), np.int32),
             "aggregate": np.zeros((0,), np.float32),
             "slot": np.zeros((0, P), np.int32),
             "bits": np.zeros((0, P), np.float32),
             "e_isl_j": np.zeros((0, P), np.float32),
             "staleness": np.zeros((0, P), np.float32),
             "weight": np.zeros((0, P), np.float32)}
    exch = fleet.exchange
    if exch is None or not fleet._ex_on:
        return empty
    actions, slots = oracle_actions(fleet, return_slots=True)
    K = actions.shape[1] if n_passes is None else min(int(n_passes),
                                                      actions.shape[1])
    bits_c = np.float32(fleet._ex_bits)
    e_c = np.float32(fleet._ex_energy_j)
    cc, L, avg_every = exch.contact, fleet.rev_len, fleet.cfg.avg_every
    last_k = np.zeros((P,), np.int64)
    rows = []

    def row(t, off, agg, stale_r, weight, pay_k):
        pays = actions[:, pay_k] != ACTION_FAILED
        rows.append((t, off, agg,
                     np.where(pays, slots[:, pay_k], -1).astype(np.int32),
                     np.full((P,), bits_c, np.float32),
                     np.where(pays, e_c, np.float32(0.0)),
                     stale_r.astype(np.float32),
                     weight.astype(np.float32)))

    for k in range(K):
        if exch.mode == "async":
            if cc.open_at(k):
                off = int(cc.offset_at(k))
                src = (np.arange(P) - off) % P
                stale_r = (k - last_k)[src]
                w = staleness_weight(stale_r, exch.mix,
                                     exch.staleness_lam, xp=np)
                row(k, off, 0.0, stale_r, w, k)
                last_k[:] = k
        elif avg_every > 0:
            kb = k + 1           # the boundary index the ring records
            if kb % L == 0 and (kb // L) % avg_every == 0:
                stale = kb - last_k
                w = np.full((P,), np.float32(1.0 / P))
                row(kb, 0, 1.0, stale, w, k)
                last_k[:] = kb
    if not rows:
        return empty
    cols = list(zip(*rows))
    return {"t": np.asarray(cols[0], np.int32),
            "offset": np.asarray(cols[1], np.int32),
            "aggregate": np.asarray(cols[2], np.float32),
            "slot": np.stack(cols[3]),
            "bits": np.stack(cols[4]),
            "e_isl_j": np.stack(cols[5]),
            "staleness": np.stack(cols[6]),
            "weight": np.stack(cols[7])}


def exchange_events(recorder) -> Dict[str, np.ndarray]:
    """The ``EV_EXCHANGE`` rows of a
    :class:`~repro_torch.obs.ring.FlightRecorder` in the oracle's layout
    (one row per event time, per-plane columns)."""
    from repro_torch.obs.ring import EXCHANGE_FIELDS

    ev = recorder.events()
    m = ev["kind"] == EV_EXCHANGE
    t, plane = ev["t"][m], ev["plane"][m]
    slot, pay = ev["slot"][m], ev["payload"][m]
    times = np.unique(t)
    P = int(plane.max()) + 1 if plane.size else 0
    out = {"t": times.astype(np.int32),
           "aggregate": np.zeros((times.size,), np.float32),
           "slot": np.full((times.size, P), -1, np.int32),
           "bits": np.zeros((times.size, P), np.float32),
           "e_isl_j": np.zeros((times.size, P), np.float32),
           "staleness": np.zeros((times.size, P), np.float32),
           "weight": np.zeros((times.size, P), np.float32)}
    col = {f: EXCHANGE_FIELDS.index(f) for f in EXCHANGE_FIELDS}
    for i, tt in enumerate(times):
        sel = t == tt
        out["aggregate"][i] = pay[sel][0, col["aggregate"]]
        for p, s, prow in zip(plane[sel], slot[sel], pay[sel]):
            out["slot"][i, p] = s
            out["bits"][i, p] = prow[col["bits"]]
            out["e_isl_j"][i, p] = prow[col["e_isl_j"]]
            out["staleness"][i, p] = prow[col["staleness"]]
            out["weight"][i, p] = prow[col["weight"]]
    return out
