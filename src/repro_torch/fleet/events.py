"""Precomputed membership and failure schedules for the fleet engine (the
port of ``repro/fleet/events.py``; host code, NumPy, array for array the
reference's).

The host :class:`~repro_torch.core.constellation.ConstellationSim`
changes its ring from Python: ``join_events`` append satellites,
``leave_events`` and seeded ``fail_prob`` draws clear ``alive`` flags. A
device program keeps fixed shapes instead, and needs none of that: every
membership event is either known from the config (join and leave
schedules are dicts) or seeded (the failure draw takes one NumPy
``Generator.random()`` per pass, a stream that can be drawn ahead). This
module folds both into an :class:`EventSchedule` of fixed-shape arrays:

* ``join_pass[m]``: the pass at which slot ``m`` joins the ring (0 for
  the initial ring; joiners take slots in event order, as the host's
  ``len(self.sats)`` ids);
* ``leave_pass[m]``: the pass at which slot ``m`` leaves (``NEVER`` =
  int32 max, so membership holds in chained runs past the horizon; the
  host's ``sid % len(sats)`` is replayed against the join schedule, so
  the ids match);
* ``fail_mask[p, k]``: plane ``p``'s seeded failure stream,
  ``default_rng(seed + p).random(K) < fail_prob``, the stream the host
  engine draws one pass at a time (sequential draws equal one array
  draw), as booleans, so no float rounding can flip a decision.
  ``legacy_streams=False`` draws plane ``p`` from
  ``np.random.SeedSequence(seed).spawn(n_planes)[p]`` instead: ``seed +
  p`` collides across runs ((seed=0, plane=1) is (seed=1, plane=0)),
  spawned sequences never do, but no host engine can follow them, so
  runs held against the host keep the legacy streams.

On the device, slot ``m`` is a member at pass ``k`` iff ``join_pass[m]
<= k < leave_pass[m]`` and it has not failed; the serving slot is the
``k mod n_alive``-th member in slot order, the host's ``ring[k %
len(ring)]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np

#: ``leave_pass`` for "never leaves": past any horizon, so chained runs
#: keep their membership (only the seeded failures end at the horizon)
NEVER = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class EventSchedule:
    """Membership and failure events for ``n_passes`` passes over
    ``n_slots`` slots (the initial ring and every joiner), per plane."""

    n_initial: int                  # slots alive at pass 0
    n_slots: int                    # M = n_initial + total joins
    n_passes: int                   # K, the precomputed horizon
    join_pass: np.ndarray           # (M,) int32
    leave_pass: np.ndarray          # (M,) int32; NEVER = never leaves
    fail_mask: np.ndarray           # (P, K) bool, seeded per plane
    fail_prob: float
    seed: int
    legacy_streams: bool = True     # seed + p streams (host parity) or
                                    # SeedSequence.spawn (no collisions)

    @property
    def n_planes(self) -> int:
        return self.fail_mask.shape[0]

    def member_at(self, k: int, failed: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """The slots that are members at pass ``k`` (host side)."""
        member = (self.join_pass <= k) & (k < self.leave_pass)
        if failed is not None:
            member = member & ~np.asarray(failed)
        return member


def leave_ids(value) -> list:
    """Normalize one ``leave_events`` value (a satellite id or a sequence
    of them) into a list of ints; the host and device engines share it,
    so a pass with several leaves resolves alike in both."""
    if isinstance(value, (int, np.integer)):
        return [int(value)]
    return [int(v) for v in value]


def build_event_schedule(n_initial: int, n_passes: int, *,
                         join_events: Optional[Mapping[int, int]] = None,
                         leave_events: Optional[Mapping[int, Any]] = None,
                         fail_prob: float = 0.0, n_planes: int = 1,
                         seed: int = 0,
                         legacy_streams: bool = True) -> EventSchedule:
    """Replay the host scheduler's events into fixed arrays.

    As ``ConstellationSim.run``, pass by pass: at pass ``k`` the joins
    come first (slot id = the count so far), then each leave id resolves
    ``sid % <count so far>``, so a leave naming a slot that has not yet
    joined behaves alike in both engines. With ``legacy_streams`` plane
    ``p``'s failures come from ``default_rng(seed + p)``, one draw a
    pass whether it fires or not, as the host engine of plane ``p``
    (seeded ``seed + p``) draws them; otherwise from the ``p``-th child
    of ``SeedSequence(seed).spawn(n_planes)``.
    """
    join_events = dict(join_events or {})
    leave_events = dict(leave_events or {})
    join_pass = [0] * int(n_initial)
    leaves = []
    for k in range(int(n_passes)):
        for _ in range(int(join_events.get(k, 0))):
            join_pass.append(k)
        if k in leave_events:
            for sid in leave_ids(leave_events[k]):
                leaves.append((k, sid % len(join_pass)))
    n_slots = len(join_pass)
    leave_pass = np.full((n_slots,), NEVER, np.int32)
    for k, sid in leaves:
        leave_pass[sid] = min(int(leave_pass[sid]), k)
    if legacy_streams:
        streams = [seed + p for p in range(int(n_planes))]
    else:
        streams = np.random.SeedSequence(int(seed)).spawn(int(n_planes))
    fail_mask = np.stack([
        np.random.default_rng(s).random(int(n_passes)) < fail_prob
        for s in streams])
    return EventSchedule(
        n_initial=int(n_initial), n_slots=n_slots, n_passes=int(n_passes),
        join_pass=np.asarray(join_pass, np.int32), leave_pass=leave_pass,
        fail_mask=fail_mask, fail_prob=float(fail_prob), seed=int(seed),
        legacy_streams=bool(legacy_streams))


def static_schedule(n_sats: int, n_passes: int,
                    n_planes: int = 1, seed: int = 0) -> EventSchedule:
    """A steady-state schedule: no events, no failures."""
    return build_event_schedule(n_sats, n_passes, n_planes=n_planes,
                                seed=seed)
