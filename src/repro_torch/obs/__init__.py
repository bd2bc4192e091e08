"""Flight recorder: telemetry rings on tensors and host metrics (the
port of ``repro/obs``; the timeline export comes with the fleet slice).

See :mod:`repro_torch.obs.ring` (event rings and
:class:`FlightRecorder`) and :mod:`repro_torch.obs.metrics` (registry and
the ``sync_budget`` guard).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      SyncBudgetExceeded, counter_property,
                      global_registry, reset_global, sync_budget)
from .ring import (EV_EXCHANGE, EV_PASS, EV_SERVE, EVENT_NAMES,
                   EXCHANGE_FIELDS, FIELDS_BY_KIND, PASS_FIELDS,
                   PAYLOAD_WIDTH, SERVE_FIELDS, FlightRecorder,
                   RingEvents, TelemetryRing, flush, merge_events,
                   payload_column, record, ring_init)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SyncBudgetExceeded", "counter_property", "global_registry",
    "reset_global", "sync_budget",
    "EV_EXCHANGE", "EV_PASS", "EV_SERVE", "EVENT_NAMES",
    "EXCHANGE_FIELDS", "FIELDS_BY_KIND", "PASS_FIELDS", "PAYLOAD_WIDTH",
    "SERVE_FIELDS", "FlightRecorder", "RingEvents", "TelemetryRing",
    "flush", "merge_events", "payload_column", "record", "ring_init",
]
