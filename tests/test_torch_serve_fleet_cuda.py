"""The serving fleet on a card. Imports neither JAX nor the JAX package, so
it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda
tests/test_torch_serve_fleet_cuda.py``. Every test skips without a card.

The serving loop on the card (under sync-debug "error": no host read
inside a run) against the same loop on the CPU and the NumPy oracle:
routing and counts exact, joules at the reference's f32 tolerance, one
host sync a run, one ``EV_SERVE`` per (plane, window)."""
import numpy as np
import pytest
import torch

from repro_torch.fleet.scenarios import EclipseConfig
from repro_torch.obs.ring import EV_SERVE
from repro_torch.serve_fleet import (FleetServeEngine, ServeCost,
                                     ServeFleetConfig, TrafficConfig,
                                     TrainLoad, assert_host_parity)

EXACT = ("arrivals", "served", "tokens", "backlog", "slot", "trained")


def require_cuda():
    """Skip the calling test unless a CUDA card is present. Called inside
    the test, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _fleet(device, P, M, K):
    cfg = ServeFleetConfig(n_planes=P, n_sats=M, n_windows=K, battery_j=60.0,
                           recharge_w=0.02, reserve_serve_j=5.0,
                           reserve_train_j=30.0, window_s=90.0,
                           eclipse=EclipseConfig(period=6, duty=0.5,
                                                 stagger=1))
    cost = ServeCost(tokens_per_s=60.0, e_token_j=0.05, dtx_bits_token=2048.0)
    train = TrainLoad(drain_j=8.0, e_total_j=12.0)
    return FleetServeEngine(cfg, TrafficConfig(users_per_day=90_000.0,
                                               decode_len=4, seed=5),
                            cost, train=train, device=device), train


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P,M,K", [(2, 8, 24), (4, 64, 200)])
def test_serving_loop_on_card_equals_cpu(P, M, K):
    dev = require_cuda()
    card, train = _fleet(dev, P, M, K)
    cpu, _ = _fleet("cpu", P, M, K)
    res, want = card.run(), cpu.run()
    for f in EXACT:
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f), f)
    for f in ("passes_served", "passes_skipped"):
        np.testing.assert_array_equal(getattr(res.energy, f),
                                      getattr(want.energy, f))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.battery_j, want.battery_j, **tol)
    np.testing.assert_allclose(res.energy.energy_spent_j,
                               want.energy.energy_spent_j, **tol)
    assert_host_parity(res, train)
    assert card.traces == 1 and card.host_syncs == 1
    ev = card.recorder.events()
    assert (ev["kind"] == EV_SERVE).sum() == P * K
    np.testing.assert_allclose(ev["payload"],
                               cpu.recorder.events()["payload"], **tol)
    # a chained run continues the stream and still reads the card once
    card.run(K // 2)
    assert card.k == K + K // 2 and card.host_syncs == 2
