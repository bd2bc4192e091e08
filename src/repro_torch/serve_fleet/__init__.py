"""The constellation as an inference fleet: pass-window-routed
continuous-batching serving of the split model, on the same batteries
training drains (the port of ``repro/serve_fleet``).

``python -m repro_torch.serve_fleet [--device cpu]`` runs the smoke:
split-vs-full decode parity, a few hundred synthetic requests routed
through pass windows on the split engine, and the serving fleet held to
its NumPy oracle.
"""
from repro_torch.serve_fleet.engine import (
    FleetServeEngine,
    ServeCost,
    ServeFleetConfig,
    ServeFleetResult,
    SplitDecodeEngine,
    TrainLoad,
    assert_host_parity,
    host_oracle,
    measure_decode_rate,
    serve_cost,
)
from repro_torch.serve_fleet.traffic import PassWindowTraffic, TrafficConfig

__all__ = [
    "FleetServeEngine",
    "PassWindowTraffic",
    "ServeCost",
    "ServeFleetConfig",
    "ServeFleetResult",
    "SplitDecodeEngine",
    "TrafficConfig",
    "TrainLoad",
    "assert_host_parity",
    "host_oracle",
    "measure_decode_rate",
    "serve_cost",
]
