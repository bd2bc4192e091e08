"""The fleet engine on a card. Imports neither JAX nor the JAX package, so
it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda
tests/test_torch_fleet_cuda.py``. Every test skips without a card.

Two planes of an elastic ring (a join, a leave, seeded failures, reserve
skips) with the int8 boundary on the quantizer kernel, against the port's
host engine plane by plane (the reference's host-vs-device tolerances),
two quantizer launches per executed step, and the engine's no-host-sync
guard around each revolution."""
import numpy as np
import pytest
import torch

from repro_torch.core import energy
from repro_torch.core.constellation import (ConstellationConfig,
                                            ConstellationSim)
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.core.train_state import SLTrainState
from repro_torch.fleet import FleetConfig, FleetEngine
from repro_torch.kernels import split_quant
from repro_torch.sim import DeviceImageryShards
from repro_torch.sim.device_sim import ACTION_NAMES

ADAPTER = autoencoder_adapter(cut=5, img=32)
EVENTS = dict(join_events={2: 1}, leave_events={5: 0}, fail_prob=0.3)
# 175 J batteries: a satellite's second pass in two revolutions is a
# reserve skip
KNOBS = dict(battery_j=175.0, recharge_w=0.01, reserve_j=150.0,
             max_steps_per_pass=2, quantize_boundary=True)


def require_cuda():
    """Skip the calling test unless a CUDA card is present. Called inside
    the test, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _budget(n_sats=4, n_items=4e6):
    return energy.PassBudget(plane=OrbitalPlane(n_sats=n_sats),
                             n_items=n_items)


@pytest.mark.requires_cuda
def test_two_planes_match_the_host_engine_on_the_card():
    require_cuda()
    shards = DeviceImageryShards(img=32, batch=4, device="cuda")
    cfg = FleetConfig(n_planes=2, n_revolutions=2, seed=0, avg_every=0,
                      **EVENTS, **KNOBS)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fleet = FleetEngine(ADAPTER, _budget(), shards, cfg)
        n0, c0 = split_quant.quantize_dequantize.launches, split_quant.copies
        res = fleet.run(stream_telemetry=True)
        launches = split_quant.quantize_dequantize.launches - n0
        M, K = fleet.n_slots, fleet.n_passes
        hosts = []
        for p in range(2):
            host = ConstellationSim(
                ADAPTER, _budget(), lambda s, i, p=p: shards(p * M + s, i),
                ConstellationConfig(n_passes=K, seed=p, **EVENTS, **KNOBS),
                device="cuda")
            host.state = SLTrainState.create(*ADAPTER.init(torch.Generator(
                device="cuda").manual_seed(0)), host.optimizer)
            host.run()
            hosts.append(host)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert launches == 2 * 2 * K * fleet.scan_steps
    assert split_quant.copies == c0
    assert fleet.traces == 1 and fleet.host_syncs == 2
    acts = set()
    for p, host in enumerate(hosts):
        assert [r.action for r in host.records] == \
            [ACTION_NAMES[int(a)] for a in res.action[p]]
        assert [r.sat_id for r in host.records] == res.sat[p].tolist()
        for hr, dl, db in zip(host.records, res.loss[p], res.battery_j[p]):
            if hr.loss is not None:
                assert abs(dl - hr.loss) <= 2e-4 * abs(hr.loss) + 2e-5
            np.testing.assert_allclose(db, hr.battery_j, rtol=1e-5,
                                       atol=0.05)
        acts |= {r.action for r in host.records}
    assert {"trained", "skipped_energy", "failed"} <= acts


@pytest.mark.requires_cuda
def test_a_fleet_revolution_never_waits_for_the_card():
    """Each revolution runs under set_sync_debug_mode("error"): a clean
    one completes with averaging at its boundary, a provider that reads
    the card back raises, and the mode is restored after either."""
    require_cuda()
    cfg = FleetConfig(n_planes=2, n_revolutions=1, max_steps_per_pass=2,
                      quantize_boundary=True, fail_prob=0.3,
                      join_events={1: 1})
    shards = DeviceImageryShards(img=32, batch=4, device="cuda")
    fleet = FleetEngine(ADAPTER, _budget(n_items=16.0), shards, cfg)
    res = fleet.run(1)
    assert res.action.shape == (2, 4)
    assert torch.cuda.get_sync_debug_mode() == 0

    class Syncing(DeviceImageryShards):
        def __call__(self, sat, idx):
            int(sat.reshape(()))                       # a host read
            return super().__call__(sat, idx)

    bad = FleetEngine(ADAPTER, _budget(n_items=16.0),
                      Syncing(img=32, batch=4), cfg)
    with pytest.raises(RuntimeError, match="synchroniz"):
        bad.run(1)
    assert torch.cuda.get_sync_debug_mode() == 0
