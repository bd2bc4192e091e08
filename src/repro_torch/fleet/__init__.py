"""The elastic fleet engine: P planes of elastic rings on one device (the
port of ``repro/fleet``).

See :mod:`repro_torch.fleet.engine` for the loop,
:mod:`repro_torch.fleet.events` for the precomputed membership and failure
schedules that keep elastic runs on the device with the host
:class:`~repro_torch.core.constellation.ConstellationSim` as the oracle,
and :mod:`repro_torch.fleet.scenarios` for the degraded-ops stressors
(eclipse windows, Byzantine slots, epidemic faults), the inter-plane
aggregation modes and the NumPy action oracle.
"""
from repro_torch.fleet.engine import (FleetConfig, FleetEngine, FleetResult,
                                      FleetTelemetry, average_planes,
                                      failure_draws)
from repro_torch.fleet.events import (EventSchedule, build_event_schedule,
                                      leave_ids, static_schedule)
from repro_torch.fleet.scenarios import (ByzantineConfig, EclipseConfig,
                                         EpidemicConfig, ScenarioConfig,
                                         ScenarioSchedule, aggregate_planes,
                                         build_scenario_schedule,
                                         epidemic_oracle, epidemic_step,
                                         oracle_actions)

__all__ = [
    "FleetConfig", "FleetEngine", "FleetResult", "FleetTelemetry",
    "average_planes", "failure_draws", "EventSchedule",
    "build_event_schedule", "leave_ids", "static_schedule",
    "ByzantineConfig", "EclipseConfig", "EpidemicConfig", "ScenarioConfig",
    "ScenarioSchedule", "aggregate_planes", "build_scenario_schedule",
    "epidemic_oracle", "epidemic_step", "oracle_actions",
]
