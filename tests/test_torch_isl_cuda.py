"""The ISL exchange and the degraded-ops fleet on a card. Imports neither
JAX nor the JAX package, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda
tests/test_torch_isl_cuda.py``. Every test skips without a card.

The int8 codec on kernel B1 (one launch per leaf, bit for bit the plain
version's), and a 2-plane fleet under eclipses, an epidemic, a Byzantine
slot and the async int8 gossip on the card against its own CPU run and
the NumPy oracles, with the exact B1 launch count."""
import numpy as np
import pytest
import torch

from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.core.train_state import SLTrainState, _leaves
from repro_torch.fleet import (ByzantineConfig, EclipseConfig, EpidemicConfig,
                               FleetConfig, FleetEngine, ScenarioConfig,
                               oracle_actions)
from repro_torch.isl import (CodecConfig, ContactConfig, ExchangeConfig,
                             encode_delta, exchange_events, oracle_exchange)
from repro_torch.kernels import split_quant
from repro_torch.models.param import map_tree
from repro_torch.sim import DeviceImageryShards
from repro_torch.train.optimizer import resolve_optimizer

ADAPTER = autoencoder_adapter(cut=5, img=32)
SCENARIO = ScenarioConfig(
    eclipse=EclipseConfig(period=4, duty=0.5, stagger=1),
    byzantine=ByzantineConfig(slots={0: [1]}, mode="sign_flip", scale=1.0),
    epidemic=EpidemicConfig(beta=0.6, ttl=2, init_slots=(0,), start=0))
EXCHANGE = ExchangeConfig(mode="async", codec=CodecConfig("int8"),
                          contact=ContactConfig(period=2, offsets=(1,)),
                          mix=0.5, staleness_lam=0.1)


def require_cuda():
    """Skip the calling test unless a CUDA card is present. Called inside
    the test, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_int8_codec_launches_b1_per_leaf_bit_for_bit():
    require_cuda()
    gen = torch.Generator().manual_seed(0)
    pa, pb = ADAPTER.init(gen)

    def noisy(t, s):
        return map_tree(lambda x: x + s * torch.randn(x.shape, generator=gen),
                        t)
    host = [(pa, pb), (noisy(pa, 0.1), noisy(pb, 0.1)),
            (noisy(pa, 0.01), noisy(pb, 0.01))]
    card = [map_tree(lambda x: x.cuda(), t) for t in host]
    n0, c0 = split_quant.quantize_dequantize.launches, split_quant.copies
    got = encode_delta(*card, EXCHANGE.codec)
    torch.cuda.synchronize()
    assert split_quant.quantize_dequantize.launches - n0 == \
        len(_leaves((pa, pb)))
    assert split_quant.copies == c0
    want = encode_delta(*host, EXCHANGE.codec)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g.cpu(), w)


def _fleet(device):
    """The fleet on ``device``, from weights drawn on the CPU (a CUDA
    generator draws other numbers than the CPU's)."""
    budget = PassBudget(plane=OrbitalPlane(n_sats=4), n_items=4e6)
    cfg = FleetConfig(n_planes=2, n_revolutions=2, seed=0, avg_every=0,
                      battery_j=200.0, recharge_w=0.02, reserve_j=180.0,
                      max_steps_per_pass=2, quantize_boundary=True,
                      scenario=SCENARIO, exchange=EXCHANGE)
    shards = DeviceImageryShards(img=32, batch=4, device=device)
    init = [map_tree(lambda x: x.to(device), t)
            for t in ADAPTER.init(torch.Generator().manual_seed(0))]
    state = SLTrainState.create(*init, resolve_optimizer("sgd"))
    return FleetEngine(ADAPTER, budget, shards, cfg, state=state,
                       device=device)


@pytest.mark.requires_cuda
def test_degraded_exchange_fleet_on_the_card():
    require_cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fleet = _fleet("cuda")
        expect_act, expect_ex = oracle_actions(fleet), oracle_exchange(fleet)
        n0, c0 = split_quant.quantize_dequantize.launches, split_quant.copies
        res = fleet.run(stream_telemetry=True)
        launches = split_quant.quantize_dequantize.launches - n0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    host = _fleet("cpu")
    res_h = host.run(stream_telemetry=True)
    contacts = expect_ex["t"].size
    leaves = len(_leaves((fleet.states[0].params_a,
                          fleet.states[0].params_b)))
    executed = 2 * fleet.n_passes * fleet.scan_steps
    trained = np.isfinite(res_h.loss)
    rel = np.abs(res.loss - res_h.loss)[trained] / np.abs(res_h.loss[trained])
    assert launches == 2 * executed + contacts * 2 * leaves, \
        (launches, executed, contacts, leaves)
    assert split_quant.copies == c0
    assert fleet.traces == 1 and fleet.host_syncs == 2
    np.testing.assert_array_equal(res.action, expect_act)
    np.testing.assert_array_equal(res.action, res_h.action)
    got = exchange_events(fleet.recorder)
    for col in ("t", "aggregate", "slot", "bits", "e_isl_j", "staleness",
                "weight"):
        np.testing.assert_array_equal(got[col], expect_ex[col], col)
    assert (res.action == 4).any() and res.isl_bits.sum() > 0
    np.testing.assert_array_equal(np.isfinite(res.loss), trained)
    print(f"card vs CPU loss: largest relative difference {rel.max():.3e}")
    # cuDNN's convolutions and the CPU's sum in other orders
    assert rel.max() <= 2e-3, rel
