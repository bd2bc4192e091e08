"""Pass-window-aware request routing for the serving fleet (the port of
``repro/serve_fleet/router.py``).

An arrival lands on whichever satellite is currently overhead: the
serving-slot rotation ``ring[k % n_alive]`` over the alive slots, in
slot order, as the fleet engine computes it (a cumsum and an argmax).
A window that closes before its backlog drains carries the queue over
to the NEXT satellite in the ring: the ground terminal holds the queue,
so routing is "the head of the FIFO goes to the current serving slot,
up to its window capacity".

The reference runs one ``xp``-agnostic body under NumPy and JAX. Torch
is not NumPy's API, so each function here has two bodies of the same
arithmetic: the NumPy one (:func:`serving_slot`, :func:`drain_queue`),
which the host oracle and the latency functions use, and the torch one
(:func:`serving_slot_torch`, :func:`drain_queue_torch`), which the
serving fleet runs on the device for all planes at once. The tests hold
the two to each other bit for bit.

FIFO latency is reconstructed on the host from per-window ``(arrivals,
served)`` telemetry: under FIFO service the ``i``-th request ever
arrived is the ``i``-th ever served, so arrival and service windows
come from two ``searchsorted`` calls on the cumulative counts, with no
per-request state in the scan.
"""
from __future__ import annotations

import numpy as np
import torch


def serving_slot(member, k) -> np.int32:
    """Slot currently overhead: ``ring[k % n_alive]`` over alive slots.

    ``member``: bool ``(M,)`` aliveness mask; returns -1 when nobody is
    alive."""
    member = np.asarray(member)
    n_alive = member.sum()
    served = n_alive > 0
    rank = np.where(served, k % np.maximum(n_alive, 1), 0)
    cums = np.cumsum(member.astype(np.int32))
    slot = np.argmax((cums == rank + 1) & member)
    return np.where(served, slot, -1).astype(np.int32)


def serving_slot_torch(member: torch.Tensor, k) -> torch.Tensor:
    """:func:`serving_slot` on a device tensor: ``member`` is ``(M,)`` or
    ``(P, M)`` bool, ``k`` a host int or an integer tensor; returns int32
    of ``member``'s leading shape, without reading the device."""
    n_alive = member.sum(dim=-1)
    served = n_alive > 0
    rank = torch.where(served, k % torch.clamp(n_alive, min=1), 0)
    cums = torch.cumsum(member.to(torch.int32), dim=-1)
    hit = (cums == (rank + 1).unsqueeze(-1)) & member
    slot = torch.argmax(hit.to(torch.int32), dim=-1)
    return torch.where(served, slot, -1).to(torch.int32)


def drain_queue(backlog, arrivals, capacity, serve_ok):
    """One window of FIFO service at the current serving slot.

    ``backlog`` carries over from the previous window (the previous
    satellite's unfinished queue, now routed to this one). ``serve_ok``
    gates service (battery reserve / eclipse-dead slot): a gated window
    serves nothing and the whole queue carries over. All f32 scalar
    arithmetic. Returns ``(served, new_backlog)``.
    """
    offered = backlog + arrivals
    served = np.where(serve_ok, np.minimum(offered, capacity),
                      np.float32(0.0))
    return served, offered - served


def drain_queue_torch(backlog: torch.Tensor, arrivals: torch.Tensor,
                      capacity: float, serve_ok: torch.Tensor):
    """:func:`drain_queue` on f32 device tensors (one entry per plane);
    ``capacity`` is a Python float that f32 holds exactly, so the f32
    arithmetic is the NumPy body's."""
    offered = backlog + arrivals
    served = torch.where(serve_ok, torch.clamp(offered, max=capacity), 0.0)
    return served, offered - served


def fifo_latency_windows(arrivals, served) -> np.ndarray:
    """Per-request queueing delay, in whole windows, under FIFO service.

    ``arrivals`` / ``served`` are per-window counts ``(K,)`` (host
    NumPy). Request ordinal ``i`` arrives in the first window whose
    cumulative arrivals reach ``i`` and is served in the first window
    whose cumulative served count reaches ``i``; the delay is the window
    difference (0 = served within its arrival window). Requests still
    in the backlog at the end of the trace are not counted.
    """
    arrivals = np.asarray(arrivals, np.float64)
    served = np.asarray(served, np.float64)
    cum_a = np.cumsum(arrivals)
    cum_s = np.cumsum(served)
    n_served = int(round(cum_s[-1])) if cum_s.size else 0
    if n_served == 0:
        return np.zeros((0,), np.int64)
    idx = np.arange(1, n_served + 1, dtype=np.float64) - 0.5
    arrive_w = np.searchsorted(cum_a, idx)
    serve_w = np.searchsorted(cum_s, idx)
    return (serve_w - arrive_w).astype(np.int64)


def latency_quantile_s(arrivals, served, window_s: float,
                       service_s: float = 0.0, q: float = 0.99) -> float:
    """Latency quantile in seconds over all served requests.

    Window-granular: a request waits ``delay`` whole windows in the
    terminal queue, plus ``service_s`` (its own prefill+decode time on
    the serving satellite). Returns NaN when nothing was served.
    """
    waits = fifo_latency_windows(arrivals, served)
    if waits.size == 0:
        return float("nan")
    return float(np.quantile(waits * float(window_s) + service_s, q))
