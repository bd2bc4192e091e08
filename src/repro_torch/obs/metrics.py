"""Host-side metrics: counters, gauges, histograms (the port's copy of
``repro/obs/metrics.py``; that module is plain Python, but its package
``__init__`` imports jax, so the port keeps its own).

Every engine exposes the same counter names (``traces``,
``device_calls``, ``host_syncs``) under its own namespace; child
registries propagate counter deltas into a process-global parent, and
:func:`sync_budget` turns the at-most-one-host-sync-per-revolution
contract into a context manager a test can wrap around a run. The
engines keep an attribute API through :func:`counter_property`
(``sim.host_syncs`` reads and writes go to the registry counter).

Everything here is host-side Python: incrementing a counter never
touches a device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonic-by-convention integer metric (``inc``/``add``/``set``).

    Deltas propagate to the owning registry's parent chain, so a fleet
    engine bumping ``fleet.host_syncs`` also bumps the global
    aggregate — which is what :func:`sync_budget` watches by default.
    """

    kind = "counter"

    def __init__(self, name: str, registry: "MetricsRegistry"):
        self.name = name
        self._registry = registry
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.add(n)

    def add(self, n: int) -> None:
        self.value += n
        self._registry._propagate(self.name, n)

    def set(self, value: int) -> None:
        """Absolute write (the compat-property setter needs it; the
        delta still propagates so parent aggregates stay consistent)."""
        self.add(value - self.value)

    def to_value(self):
        return self.value


class Gauge:
    """Last-write-wins scalar (mesh shape, plane count, battery floor…).

    Gauges do NOT aggregate to the parent — summing "n_planes" across
    engines is meaningless — but they do *appear* in the parent's
    ``to_dict`` under their qualified name, via registry traversal.
    """

    kind = "gauge"

    def __init__(self, name: str, registry: "MetricsRegistry"):
        self.name = name
        self.value: Any = None

    def set(self, value) -> None:
        self.value = value

    def to_value(self):
        return self.value


class Histogram:
    """Streaming summary of a float series (dispatch latencies, window
    throughputs): count / sum / min / max plus power-of-two buckets.

    Buckets are ``le`` upper bounds in a fixed geometric ladder — good
    enough to eyeball a latency distribution in a BENCH JSON without
    storing samples.
    """

    kind = "histogram"

    #: geometric bucket upper bounds (seconds-ish scale); +inf implied
    BOUNDS = tuple(2.0 ** e for e in range(-10, 7))

    def __init__(self, name: str, registry: "MetricsRegistry"):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * (len(self.BOUNDS) + 1)

    def record(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for i, bound in enumerate(self.BOUNDS):
            if x <= bound:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_value(self):
        if not self.count:
            return {"count": 0}
        out = {"count": self.count, "sum": self.sum, "mean": self.mean,
               "min": self.min, "max": self.max}
        nonzero = {f"le_{bound:g}": n
                   for bound, n in zip(self.BOUNDS, self.buckets) if n}
        if self.buckets[-1]:
            nonzero["le_inf"] = self.buckets[-1]
        out["buckets"] = nonzero
        return out


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """A namespaced bag of metrics with get-or-create accessors.

    Engines build one per instance, parented to the process-global
    registry::

        self.metrics = MetricsRegistry("fleet", parent=global_registry())
        self.metrics.inc("traces")            # counter shorthand
        self.metrics.histogram("dispatch_s").record(dt)

    Counter deltas roll up the parent chain under the child's qualified
    name (``fleet.traces``), so the global registry is always the sum
    over every live engine — that aggregate is what lands in BENCH
    JSONs and what :func:`sync_budget` guards by default.
    """

    def __init__(self, namespace: str = "",
                 parent: Optional["MetricsRegistry"] = None):
        self.namespace = namespace
        self.parent = parent
        self._metrics: Dict[str, Any] = {}

    # ----------------------------------------------------- accessors
    def _get(self, kind: str, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = _METRIC_TYPES[kind](name, self)
            self._metrics[name] = m
        elif m.kind != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    # --------------------------------------------------- aggregation
    def _qualify(self, name: str) -> str:
        return f"{self.namespace}.{name}" if self.namespace else name

    def _propagate(self, name: str, delta: int) -> None:
        if self.parent is not None and delta:
            self.parent.counter(self._qualify(name)).add(delta)

    def counters_matching(self, suffix: str) -> List[Counter]:
        """Every counter whose name is ``suffix`` or ends with
        ``.suffix`` — how :func:`sync_budget` finds host-sync counters
        from any engine namespace."""
        return [m for name, m in sorted(self._metrics.items())
                if m.kind == "counter"
                and (name == suffix or name.endswith("." + suffix))]

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready snapshot (the BENCH ``metrics`` block)."""
        return {name: m.to_value()
                for name, m in sorted(self._metrics.items())}


# ------------------------------------------------------ global registry

_GLOBAL: MetricsRegistry = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide aggregate every engine parents to."""
    return _GLOBAL


def reset_global() -> MetricsRegistry:
    """Fresh global registry (benchmark entry points call this so one
    process's runs don't bleed into the next BENCH JSON).  Engines
    created *before* the reset keep propagating into the old registry;
    construct engines after resetting."""
    global _GLOBAL
    _GLOBAL = MetricsRegistry()
    return _GLOBAL


# --------------------------------------------------------- sync budget

class SyncBudgetExceeded(AssertionError):
    """A guarded region performed more device→host syncs than allowed."""


@contextlib.contextmanager
def sync_budget(max_syncs: int, registry: Optional[MetricsRegistry] = None,
                counter: str = "host_syncs"):
    """Assert that the wrapped region performs ≤ ``max_syncs`` telemetry
    syncs — the ≤-1-per-revolution contract as a context manager::

        with sync_budget(cfg.n_revolutions, registry=fleet.metrics):
            fleet.run()

    Watches every counter named ``counter`` (or ``*.{counter}``) in
    ``registry`` (default: the global registry, i.e. all engines at
    once) and raises :class:`SyncBudgetExceeded` with the offending
    delta.  Counters created *inside* the region are picked up too —
    the before-snapshot treats unseen counters as 0.
    """
    reg = registry if registry is not None else global_registry()
    before = {c.name: c.value for c in reg.counters_matching(counter)}
    yield reg
    after = {c.name: c.value for c in reg.counters_matching(counter)}
    spent = sum(after.values()) - sum(before.get(k, 0) for k in after)
    if spent > max_syncs:
        detail = ", ".join(f"{k}: +{v - before.get(k, 0)}"
                           for k, v in sorted(after.items())
                           if v - before.get(k, 0))
        raise SyncBudgetExceeded(
            f"sync budget exceeded: {spent} host syncs > allowed "
            f"{max_syncs} ({detail})")


# ------------------------------------------------------- compat shim

def counter_property(name: str):
    """A class-level property backing an old-style ``self.<attr>`` int
    against ``self.metrics.counter(name)``.

    Keeps the pre-registry API alive verbatim: reads return the counter
    value, ``engine.traces += 1`` and ``engine.host_syncs = 0`` both
    work (augmented assignment reads then sets; the set propagates the
    delta).  Engines declare::

        traces = counter_property("traces")
    """

    def _get(self):
        return self.metrics.counter(name).value

    def _set(self, value):
        self.metrics.counter(name).set(int(value))

    return property(_get, _set, doc=f"compat view of metrics counter "
                                    f"{name!r}")
