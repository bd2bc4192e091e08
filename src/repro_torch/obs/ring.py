"""Telemetry rings on tensors: the device half of the flight recorder
(the port of ``repro/obs/ring.py``).

An engine that runs a whole revolution on the device can tell the host
nothing between its telemetry syncs without adding a sync. A
:class:`TelemetryRing` is a fixed-size event buffer on the device (kind,
time, slot and a float32 payload row per event) with a monotonic cursor,
written by :func:`record` as the loop runs and brought home with the
telemetry at the existing sync, so recording costs no sync of its own.

Device API:

* :func:`ring_init` allocates a ring of ``capacity`` event slots;
* :func:`record` writes one event at ``cursor % capacity`` and returns
  the new ring. The index is a device tensor, so recording never reads
  the host. ``mask=False`` writes every slot back with its own value and
  leaves the cursor as it was: the ring is bit for bit unchanged. When
  the ring is full the cursor keeps counting and the write wraps: the
  newest events overwrite the oldest, and :func:`flush` reports the
  overwritten ones as ``dropped = cursor - min(cursor, capacity)``.

Host API: :func:`flush` (one copy of a ring, unwrapped oldest first) and
:class:`FlightRecorder`, which accumulates flushed rings into one event
table. Payload columns are named per event kind (``PASS_FIELDS`` ...).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------- schema

EV_PASS = 0          # one training pass (sim + fleet engines)
EV_SERVE = 1         # one serving window (serve-fleet engine)
EV_EXCHANGE = 2      # inter-plane ISL checkpoint exchange

EVENT_NAMES = {EV_PASS: "pass", EV_SERVE: "serve", EV_EXCHANGE: "exchange"}

#: float32 payload columns, fixed per event kind (unused tail = 0)
PASS_FIELDS = ("action", "battery_j", "loss", "n_steps", "kept_fraction",
               "fault", "sunlit", "n_infected")
SERVE_FIELDS = ("arrivals", "battery_j", "served", "backlog", "tokens",
                "trained", "sunlit", "capacity_req")
EXCHANGE_FIELDS = ("aggregate", "bits", "e_isl_j", "staleness", "weight")
FIELDS_BY_KIND = {EV_PASS: PASS_FIELDS, EV_SERVE: SERVE_FIELDS,
                  EV_EXCHANGE: EXCHANGE_FIELDS}

#: every ring row is this wide — the max any kind needs
PAYLOAD_WIDTH = 8


class TelemetryRing(NamedTuple):
    """Fixed-size event buffer. ``cursor`` counts every recorded event;
    the write index is ``cursor % capacity``. Fields are tensors on the
    device, or NumPy arrays once brought home."""

    kind: Any        # (C,)   int32  EV_* code (-1 = never written)
    t: Any           # (C,)   int32  pass / window index
    slot: Any        # (C,)   int32  ring slot (satellite), -1 = plane-wide
    payload: Any     # (C, W) float32 columns named by FIELDS_BY_KIND
    cursor: Any      # ()     int32  total events recorded (monotonic)

    @property
    def capacity(self) -> int:
        return self.kind.shape[-1]


def ring_init(capacity: int, payload_width: int = PAYLOAD_WIDTH,
              batch: Tuple[int, ...] = (), device="cuda") -> TelemetryRing:
    """A fresh ring of ``capacity`` event slots on ``device`` (``batch``
    adds leading axes, one ring per plane)."""
    if capacity < 1:
        raise ValueError(f"ring capacity must be >= 1, got {capacity}")
    i32 = dict(dtype=torch.int32, device=device)
    return TelemetryRing(
        kind=torch.full(batch + (capacity,), -1, **i32),
        t=torch.zeros(batch + (capacity,), **i32),
        slot=torch.zeros(batch + (capacity,), **i32),
        payload=torch.zeros(batch + (capacity, payload_width),
                            dtype=torch.float32, device=device),
        cursor=torch.zeros(batch, **i32))


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype`` on ``device``. A Python number
    becomes a fill on the device, never a host-to-device copy (which
    would wait for the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def record(ring: TelemetryRing, kind, t, slot, payload,
           mask=True) -> TelemetryRing:
    """Write one event at the cursor; returns the new ring.

    ``kind``, ``t``, ``slot`` and ``mask`` are Python scalars or 0-d
    tensors on the ring's device; ``payload`` is a tensor or a sequence
    of up to ``PAYLOAD_WIDTH`` scalars (shorter rows are zero-padded).
    Nothing here reads the device.
    """
    if ring.cursor.dim() != 0:
        raise ValueError("record() takes a flat ring (one plane)")
    dev = ring.kind.device
    cap, width = ring.kind.shape[-1], ring.payload.shape[-1]
    if isinstance(payload, torch.Tensor):
        pay = payload.to(torch.float32).reshape(-1)
    else:
        pay = torch.stack([_on(p, torch.float32, dev) for p in payload])
    if pay.shape[0] > width:
        raise ValueError(f"payload has {pay.shape[0]} columns; the ring "
                         f"holds {width}")
    if pay.shape[0] < width:
        pay = torch.cat([pay, pay.new_zeros(width - pay.shape[0])])
    m = _on(mask, torch.bool, dev)
    idx = (ring.cursor % cap).long().reshape(1)

    def put(col, value, dtype):
        old = col.index_select(0, idx)
        new = torch.where(m, _on(value, dtype, dev), old)
        return col.index_copy(0, idx, new)

    old_pay = ring.payload.index_select(0, idx)
    return TelemetryRing(
        kind=put(ring.kind, kind, torch.int32),
        t=put(ring.t, t, torch.int32),
        slot=put(ring.slot, slot, torch.int32),
        payload=ring.payload.index_copy(
            0, idx, torch.where(m, pay[None], old_pay)),
        cursor=ring.cursor + m.to(torch.int32))


# ------------------------------------------------------------- host side

def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ring_to_host(ring: TelemetryRing) -> TelemetryRing:
    """The ring's fields as NumPy arrays (one copy per field)."""
    return TelemetryRing(*[_host(a) for a in ring])


class RingEvents(NamedTuple):
    """One flushed ring, chronological, host arrays."""

    kind: np.ndarray      # (n,) int32
    t: np.ndarray         # (n,) int32
    slot: np.ndarray      # (n,) int32
    payload: np.ndarray   # (n, W) float32
    dropped: int          # events overwritten before this flush


def flush(ring: TelemetryRing) -> RingEvents:
    """A (flat) ring on the host, unwrapped oldest first. Call it where
    the engine already syncs, or on a ring already brought home."""
    host = _ring_to_host(ring)
    if host.cursor.ndim != 0:
        raise ValueError("flush() takes a flat ring; index the plane axis "
                         "first (FlightRecorder.ingest does)")
    cap = host.kind.shape[-1]
    cursor = int(host.cursor)
    n = min(cursor, cap)
    if cursor <= cap:
        order = np.arange(n)
    else:                       # wrapped: oldest event sits at cursor % cap
        start = cursor % cap
        order = np.concatenate([np.arange(start, cap), np.arange(start)])
    return RingEvents(kind=host.kind[order], t=host.t[order],
                      slot=host.slot[order], payload=host.payload[order],
                      dropped=cursor - n)


_EVENT_COLUMNS = ("kind", "t", "slot", "plane", "payload")


def _empty_events() -> Dict[str, np.ndarray]:
    return {"kind": np.zeros((0,), np.int32), "t": np.zeros((0,), np.int32),
            "slot": np.zeros((0,), np.int32),
            "plane": np.zeros((0,), np.int32),
            "payload": np.zeros((0, PAYLOAD_WIDTH), np.float32)}


class FlightRecorder:
    """Host-side accumulator of flushed rings.

    Engines own one recorder each and call :meth:`ingest` where they
    sync telemetry. The recorder splits plane-batched rings, tags every
    event with its plane, feeds the engine's metrics registry
    (``events_recorded`` / ``events_dropped``) and serves the merged,
    time-ordered event table.
    """

    def __init__(self, metrics=None):
        self.metrics = metrics
        self.dropped = 0
        self._chunks = []          # list of per-ingest column dicts

    def __len__(self) -> int:
        return sum(int(c["kind"].shape[0]) for c in self._chunks)

    def ingest(self, ring: TelemetryRing, *, t_offset: int = 0) -> int:
        """Flush ``ring`` (flat, or plane-batched ``(P, ...)``; tensors or
        host arrays) into the event table; returns the events ingested.
        ``t_offset`` shifts dispatch-local event times onto the run's
        timeline."""
        host = _ring_to_host(ring)
        planes = ([None] if host.cursor.ndim == 0
                  else range(host.cursor.shape[0]))
        n_total = 0
        for p in planes:
            r = host if p is None else TelemetryRing(*[a[p] for a in host])
            ev = flush(r)
            n = ev.kind.shape[0]
            n_total += n
            self.dropped += ev.dropped
            self._chunks.append({
                "kind": ev.kind, "t": ev.t + np.int32(t_offset),
                "slot": ev.slot,
                "plane": np.full((n,), 0 if p is None else p, np.int32),
                "payload": ev.payload})
        if self.metrics is not None:
            self.metrics.inc("events_recorded", n_total)
            if self.dropped:
                self.metrics.counter("events_dropped").set(self.dropped)
        return n_total

    def events(self) -> Dict[str, np.ndarray]:
        """The merged event table, stably sorted by (t, plane)."""
        if not self._chunks:
            return _empty_events()
        cols = {k: np.concatenate([c[k] for c in self._chunks])
                for k in _EVENT_COLUMNS}
        order = np.lexsort((cols["plane"], cols["t"]))
        return {k: v[order] for k, v in cols.items()}

    def save(self, path: str) -> None:
        """One ``.npz`` with the merged table and the dropped count."""
        np.savez(path, dropped=np.int64(self.dropped), **self.events())

    @staticmethod
    def load(path: str) -> "FlightRecorder":
        data = np.load(path)
        rec = FlightRecorder()
        rec.dropped = int(data["dropped"])
        rec._chunks.append({k: data[k] for k in _EVENT_COLUMNS})
        return rec


def merge_events(*tables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge event tables into one, stably sorted by (t, plane)."""
    tables = [t for t in tables if t["kind"].shape[0]]
    if not tables:
        return _empty_events()
    cols = {k: np.concatenate([t[k] for t in tables])
            for k in _EVENT_COLUMNS}
    order = np.lexsort((cols["plane"], cols["t"]))
    return {k: v[order] for k, v in cols.items()}


def payload_column(events: Dict[str, np.ndarray], kind: int,
                   field: str) -> np.ndarray:
    """The named payload column of every ``kind`` event (host helper)."""
    fields = FIELDS_BY_KIND[kind]
    mask = events["kind"] == kind
    return events["payload"][mask][:, fields.index(field)]
