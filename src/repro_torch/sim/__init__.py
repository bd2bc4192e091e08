"""The device-resident constellation loop (the port of ``repro/sim``).

The host :class:`~repro_torch.core.constellation.ConstellationSim` is
the feature-complete oracle (elastic membership, random failures,
checkpoint handoffs, any Python data provider); this package is the
engine: the steady-state closed loop (orbit plan → energy policy → SL
passes → recharge) kept on the device for constellation-scale studies.
``ConstellationSim.run(engine="device")`` bridges the two.
"""
from repro_torch.sim.data import DeviceImageryShards
from repro_torch.sim.device_sim import (ACTION_NAMES, ACTION_SHED,
                                        ACTION_SKIPPED, ACTION_TRAINED,
                                        DeviceConstellationSim,
                                        DevicePassPlan, DeviceSimConfig,
                                        DeviceSimResult, plan_ring_passes)
from repro_torch.sim.energy_state import (EnergyState, clamp_battery,
                                          init_energy_state)

__all__ = [
    "ACTION_NAMES", "ACTION_SHED", "ACTION_SKIPPED", "ACTION_TRAINED",
    "DeviceConstellationSim", "DeviceImageryShards", "DevicePassPlan",
    "DeviceSimConfig", "DeviceSimResult", "EnergyState", "clamp_battery",
    "init_energy_state", "plan_ring_passes",
]
