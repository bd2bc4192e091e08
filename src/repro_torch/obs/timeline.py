"""Mission-timeline export: flushed rings -> Chrome-trace / Perfetto JSON
(the port of ``repro/obs/timeline.py``; NumPy and json only).

Renders a :class:`~repro_torch.obs.ring.FlightRecorder` event table as the
kind of dense per-pass timeline SFL-LEO / LEO-Split evaluate with: one
process per orbital plane, one thread per ring slot, a complete-event
("X") span per training pass (named by its action: trained / shed /
reserve-skip / failed / fault) or serving window, eclipse shading and
ISL exchange markers on dedicated tracks, and battery / backlog counter
("C") series.  The JSON loads directly in ``ui.perfetto.dev`` or
``chrome://tracing``; :func:`timeline_summary` gives the same story as
plain text for terminals and smoke logs.

Event times are pass/window *indices*; :func:`to_chrome_trace` maps
index ``t`` to ``t * window_s`` seconds of trace time (trace
timestamps are microseconds), so the timeline's x-axis is mission time
under the configured pass cadence.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

from .ring import (EV_EXCHANGE, EV_PASS, EV_SERVE, EXCHANGE_FIELDS,
                   FIELDS_BY_KIND, PASS_FIELDS, SERVE_FIELDS)

# Synthetic tids for plane-wide tracks (real slots are small ints).
_TID_ECLIPSE = 9000
_TID_EXCHANGE = 9001
_TID_SERVE_BASE = 5000     # serve slot m renders at tid 5000 + m


def _action_names() -> Dict[int, str]:
    # Lazy import: device_sim imports repro_torch.obs, so a top-level
    # import here would be circular.
    from repro_torch.sim.device_sim import ACTION_NAMES
    return dict(ACTION_NAMES)


def _row(ev: Dict[str, np.ndarray], i: int) -> Dict[str, float]:
    fields = FIELDS_BY_KIND.get(int(ev["kind"][i]), ())
    pay = ev["payload"][i]
    return {f: float(pay[j]) for j, f in enumerate(fields)}


def to_chrome_trace(events: Dict[str, np.ndarray],
                    window_s: float = 1.0) -> Dict[str, Any]:
    """Event table (from ``FlightRecorder.events`` / ``merge_events``)
    -> Chrome-trace JSON object (``{"traceEvents": [...]}``)."""
    actions = _action_names()
    us = window_s * 1e6
    out: List[Dict[str, Any]] = []
    seen_procs = set()
    seen_threads = set()

    def meta_proc(pid: int, name: str) -> None:
        if pid not in seen_procs:
            seen_procs.add(pid)
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})

    def meta_thread(pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in seen_threads:
            seen_threads.add((pid, tid))
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": name}})

    # Eclipse shading: consecutive sunlit==0 passes on one plane merge
    # into a single span on the plane's eclipse track.
    eclipse_open: Dict[int, List[float]] = {}   # plane -> [start_ts, end_ts]

    def close_eclipse(pid: int) -> None:
        span = eclipse_open.pop(pid, None)
        if span is not None:
            out.append({"ph": "X", "name": "eclipse", "cat": "eclipse",
                        "pid": pid, "tid": _TID_ECLIPSE,
                        "ts": span[0], "dur": span[1] - span[0], "args": {}})

    n = int(events["kind"].shape[0])
    for i in range(n):
        kind = int(events["kind"][i])
        t = int(events["t"][i])
        slot = int(events["slot"][i])
        pid = int(events["plane"][i])
        ts = t * us
        args = _row(events, i)
        meta_proc(pid, f"plane {pid}")

        if kind == EV_PASS:
            meta_thread(pid, slot, f"slot {slot}")
            name = actions.get(int(args.get("action", -1)),
                               f"action {int(args.get('action', -1))}")
            out.append({"ph": "X", "name": name, "cat": "train",
                        "pid": pid, "tid": slot, "ts": ts, "dur": us,
                        "args": args})
            out.append({"ph": "C", "name": f"battery slot {slot}",
                        "pid": pid, "tid": slot, "ts": ts,
                        "args": {"J": args.get("battery_j", 0.0)}})
            if "sunlit" in args:
                meta_thread(pid, _TID_ECLIPSE, "eclipse")
                if args["sunlit"] < 0.5:
                    span = eclipse_open.setdefault(pid, [ts, ts])
                    span[1] = ts + us
                else:
                    close_eclipse(pid)
        elif kind == EV_SERVE:
            tid = _TID_SERVE_BASE + max(slot, 0)
            meta_thread(pid, tid, f"serve slot {slot}")
            out.append({"ph": "X", "name": "serve", "cat": "serve",
                        "pid": pid, "tid": tid, "ts": ts, "dur": us,
                        "args": args})
            out.append({"ph": "C", "name": f"backlog slot {slot}",
                        "pid": pid, "tid": tid, "ts": ts,
                        "args": {"tok": args.get("backlog", 0.0)}})
        elif kind == EV_EXCHANGE:
            meta_thread(pid, _TID_EXCHANGE, "isl exchange")
            out.append({"ph": "i", "name": "plane exchange",
                        "cat": "exchange", "pid": pid,
                        "tid": _TID_EXCHANGE, "ts": ts, "s": "p",
                        "args": args})

    for pid in list(eclipse_open):
        close_eclipse(pid)
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"window_s": window_s, "n_events": n}}


def write_chrome_trace(path: str, events: Dict[str, np.ndarray],
                       window_s: float = 1.0) -> Dict[str, Any]:
    trace = to_chrome_trace(events, window_s=window_s)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace


def validate_chrome_trace(obj: Any) -> None:
    """Raise ``ValueError`` unless ``obj`` is a loadable Chrome-trace
    object (what the acceptance criterion means by "valid")."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a chrome trace: missing 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("ph", "pid", "tid", "name"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing {key!r}")
        if ev["ph"] in ("X", "C", "i") and "ts" not in ev:
            raise ValueError(f"traceEvents[{i}] ({ev['ph']}) missing 'ts'")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"traceEvents[{i}] (X) missing 'dur'")


def timeline_summary(events: Dict[str, np.ndarray]) -> str:
    """Plain-text digest of an event table (for smokes / terminals)."""
    actions = _action_names()
    kind = events["kind"]
    lines = [f"flight recorder: {kind.shape[0]} events, "
             f"planes {sorted(set(events['plane'].tolist())) or '-'}"]
    pass_mask = kind == EV_PASS
    if pass_mask.any():
        acts = events["payload"][pass_mask][:, PASS_FIELDS.index("action")]
        acts = acts.astype(np.int32)
        counts = ", ".join(
            f"{actions.get(int(a), int(a))}={int((acts == a).sum())}"
            for a in np.unique(acts))
        batt = events["payload"][pass_mask][:, PASS_FIELDS.index("battery_j")]
        finite = batt[np.isfinite(batt)]
        lines.append(f"  passes: {int(pass_mask.sum())} ({counts})")
        if finite.size:
            lines.append(f"  battery J: min {finite.min():.1f} / "
                         f"mean {finite.mean():.1f} / max {finite.max():.1f}")
        sun = events["payload"][pass_mask][:, PASS_FIELDS.index("sunlit")]
        if (sun < 0.5).any():
            lines.append(f"  eclipsed passes: {int((sun < 0.5).sum())}")
    serve_mask = kind == EV_SERVE
    if serve_mask.any():
        pay = events["payload"][serve_mask]
        served = pay[:, SERVE_FIELDS.index("served")]
        tokens = pay[:, SERVE_FIELDS.index("tokens")]
        backlog = pay[:, SERVE_FIELDS.index("backlog")]
        lines.append(f"  serve windows: {int(serve_mask.sum())}, "
                     f"served {served.sum():.0f} req / "
                     f"{tokens.sum():.0f} tok, final backlog "
                     f"{backlog[-1]:.0f} req")
    n_ex = int((kind == EV_EXCHANGE).sum())
    if n_ex:
        pay = events["payload"][kind == EV_EXCHANGE]
        bits = pay[:, EXCHANGE_FIELDS.index("bits")]
        e_isl = pay[:, EXCHANGE_FIELDS.index("e_isl_j")]
        stale = pay[:, EXCHANGE_FIELDS.index("staleness")]
        line = f"  plane exchanges: {n_ex}"
        if bits.sum() > 0:      # metered (repro_torch.isl); free average = 0
            line += (f", {bits.sum():.3g} bits / {e_isl.sum():.3g} J "
                     f"over ISL, max staleness {stale.max():.0f}")
        lines.append(line)
    return "\n".join(lines)
