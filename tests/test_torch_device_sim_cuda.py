"""The device-resident loop on a card. Imports neither JAX nor the JAX
package, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda
tests/test_torch_device_sim_cuda.py``. Every test skips without a card.

The port's host engine against its device engine with the int8 boundary
on the quantizer kernel (the reference's host-vs-device tolerances), the
engine's no-host-sync guard, and the float64 solver on the card against
the NumPy solver."""
import numpy as np
import pytest
import torch

from repro_torch.core import energy, resource_opt, splitting
from repro_torch.core.constellation import (ConstellationConfig,
                                            ConstellationSim)
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.kernels import split_quant
from repro_torch.sim import (DeviceConstellationSim, DeviceImageryShards,
                             DeviceSimConfig)

ADAPTER = autoencoder_adapter(cut=5, img=32)
RING = dict(n_passes=12, battery_j=200.0, recharge_w=0.01, reserve_j=150.0,
            max_steps_per_pass=4, quantize_boundary=True)


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
def test_host_and_device_engines_agree_on_the_card():
    require_cuda()
    shards = DeviceImageryShards(img=32, batch=4, device="cuda")
    host = ConstellationSim(ADAPTER, _budget(), shards,
                            ConstellationConfig(**RING), device="cuda")
    dev = ConstellationSim(ADAPTER, _budget(), shards,
                           ConstellationConfig(**RING), device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host.run()
        n0, c0 = split_quant.quantize_dequantize.launches, split_quant.copies
        dev.run(engine="device")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eng = dev.device_engine
    executed = 12 * eng.scan_steps              # masked steps included
    assert split_quant.quantize_dequantize.launches - n0 == 2 * executed
    assert split_quant.copies == c0
    acts = [r.action for r in host.records]
    assert "skipped_energy" in acts and "trained" in acts
    assert [r.action for r in dev.records] == acts
    for h, d in zip(host.records, dev.records):
        if h.loss is None:
            assert d.loss is None
        else:
            np.testing.assert_allclose(d.loss, h.loss, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(d.battery_j, h.battery_j, rtol=1e-5,
                                   atol=0.05)
        np.testing.assert_allclose(d.e_total_j, h.e_total_j, rtol=1e-5,
                                   atol=1e-9)
    assert eng.traces == 1 and eng.host_syncs == 3


@pytest.mark.requires_cuda
def test_a_revolution_never_waits_for_the_card():
    """The engine runs each revolution under set_sync_debug_mode
    ("error"): a clean revolution completes, a provider that reads the
    card back raises, and the mode is restored after either."""
    require_cuda()
    shards = DeviceImageryShards(img=32, batch=4, device="cuda")
    cfg = DeviceSimConfig(max_steps_per_pass=2, quantize_boundary=True)
    eng = DeviceConstellationSim(ADAPTER, _budget(n_items=16.0), shards, cfg)
    res = eng.run(1)
    assert np.isfinite(res.loss).all()
    assert torch.cuda.get_sync_debug_mode() == 0

    class Syncing(DeviceImageryShards):
        def __call__(self, sat, idx):
            int(sat.reshape(()))                       # a host read
            return super().__call__(sat, idx)

    bad = DeviceConstellationSim(ADAPTER, _budget(n_items=16.0),
                                 Syncing(img=32, batch=4), cfg)
    with pytest.raises(RuntimeError, match="synchroniz"):
        bad.run(1)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.requires_cuda
def test_torch_solver_on_the_card_matches_numpy():
    require_cuda()
    b = energy.PassBudget()
    cuts = (splitting.resnet18_plan(img=224).enumerate_cuts()
            + splitting.autoencoder_plan(img=224).enumerate_cuts())
    budgets = [energy.PassBudget(n_items=n) for n in (8.0, 400.0, 4e4)]
    bl = [x for x in budgets for _ in cuts]
    cl = cuts * len(budgets)
    got = resource_opt.solve_batch(bl, cl, backend="torch")
    want = resource_opt.solve_batch(bl, cl, backend="numpy")
    np.testing.assert_allclose(got.phase_times, want.phase_times, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(got.phase_energy, want.phase_energy,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    shed = resource_opt.solve_with_shedding_batch(b, cl, backend="torch")
    ref = resource_opt.solve_with_shedding_batch(b, cl, backend="numpy")
    np.testing.assert_allclose(shed.kept_fraction, ref.kept_fraction,
                               atol=2e-4)
