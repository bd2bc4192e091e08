"""Flight recorder: telemetry rings on tensors, host metrics and the
timeline export (the port of ``repro/obs``).

See :mod:`repro_torch.obs.ring` (event rings and
:class:`FlightRecorder`), :mod:`repro_torch.obs.metrics` (registry and
the ``sync_budget`` guard) and :mod:`repro_torch.obs.timeline`
(Chrome-trace / Perfetto rendering and a text digest).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      SyncBudgetExceeded, counter_property,
                      global_registry, reset_global, sync_budget)
from .ring import (EV_EXCHANGE, EV_PASS, EV_SERVE, EVENT_NAMES,
                   EXCHANGE_FIELDS, FIELDS_BY_KIND, PASS_FIELDS,
                   PAYLOAD_WIDTH, SERVE_FIELDS, FlightRecorder,
                   RingEvents, TelemetryRing, flush, merge_events,
                   payload_column, record, ring_init)
from .timeline import (timeline_summary, to_chrome_trace,
                       validate_chrome_trace, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SyncBudgetExceeded", "counter_property", "global_registry",
    "reset_global", "sync_budget",
    "EV_EXCHANGE", "EV_PASS", "EV_SERVE", "EVENT_NAMES",
    "EXCHANGE_FIELDS", "FIELDS_BY_KIND", "PASS_FIELDS", "PAYLOAD_WIDTH",
    "SERVE_FIELDS", "FlightRecorder", "RingEvents", "TelemetryRing",
    "flush", "merge_events", "payload_column", "record", "ring_init",
    "timeline_summary", "to_chrome_trace", "validate_chrome_trace",
    "write_chrome_trace",
]
