"""The port's device-resident loop (``repro_torch.sim``) on the CPU: the
reference's ``tests/test_device_sim.py`` case by case, the port's host
engine against the port's device engine on the port's
``DeviceImageryShards``, at the reference's tolerances
(``_assert_record_parity``: losses rtol 2e-4 atol 1e-5, battery rtol
1e-5 atol 0.05, e_total rtol 1e-5 or 2e-3 when shedding, kept fraction
rtol 5e-4, d_isl rtol 1e-6); then the reference's HOST engine against
the port's DEVICE engine on the reference's own batches (the reference's
device engine does not run under this jax, ROADMAP C1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import BatchTable, jax_tree_to_numpy
from repro.core import constellation as jcon
from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import sl_step as jsl
from repro.sim import data as jdata
from repro_torch.core.constellation import (ConstellationConfig,
                                            ConstellationSim)
from repro_torch.core.energy import PassBudget
from repro_torch.core.mission import sweep_revolutions
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter, make_pass_step
from repro_torch.core.train_state import SLTrainState
from repro_torch.launch import device_sim as launch_device_sim
from repro_torch.models.param import from_jax_params
from repro_torch.obs import metrics, sync_budget
from repro_torch.sim import (ACTION_TRAINED, DeviceConstellationSim,
                             DeviceImageryShards, DeviceSimConfig,
                             plan_ring_passes)
from repro_torch.train import optimizer

CPU = "cpu"
SHARDS = DeviceImageryShards(img=32, batch=4, device=CPU)
ADAPTER = autoencoder_adapter(cut=5, img=32)
ENERGY_SKIPS = dict(n_passes=12, battery_j=200.0, recharge_w=0.01,
                    reserve_j=150.0, max_steps_per_pass=4)


def _budget(n_sats=4, n_items=16.0):
    return PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=n_items)


def _pair(budget, **cfg_kw):
    """Two identically-configured sims sharing the traceable provider."""
    def make():
        return ConstellationSim(ADAPTER, budget, SHARDS,
                                ConstellationConfig(**cfg_kw), device=CPU)
    return make(), make()


def _assert_record_parity(host_recs, dev_recs, *, loss_rtol=2e-4,
                          e_rtol=1e-5):
    """``e_rtol`` loosens for shed scenarios: the host bisects the kept
    fraction to 1e-4 while the device uses the closed form, and energy
    scales ~cubically in the kept item count."""
    assert [r.action for r in host_recs] == [r.action for r in dev_recs]
    assert [r.sat_id for r in host_recs] == [r.sat_id for r in dev_recs]
    for h, d in zip(host_recs, dev_recs):
        if h.loss is None:
            assert d.loss is None
        else:
            np.testing.assert_allclose(d.loss, h.loss, rtol=loss_rtol,
                                       atol=1e-5)
        np.testing.assert_allclose(d.battery_j, h.battery_j, rtol=1e-5,
                                   atol=0.05)
        np.testing.assert_allclose(d.e_total_j, h.e_total_j, rtol=e_rtol,
                                   atol=1e-9)
        np.testing.assert_allclose(d.kept_fraction, h.kept_fraction,
                                   rtol=5e-4)
        np.testing.assert_allclose(d.d_isl_bits, h.d_isl_bits, rtol=1e-6)


def test_closed_loop_parity_with_energy_skips():
    """3 revolutions on a 4-sat ring where the ~48 J/pass drain pushes
    batteries below reserve: actions (every skip decision), batteries,
    losses and the energy summary match the host engine."""
    host, dev = _pair(_budget(n_items=4e6), **ENERGY_SKIPS)
    host.run()
    dev.run(engine="device")

    assert len(dev.records) == 12
    actions = [r.action for r in host.records]
    assert "trained" in actions and "skipped_energy" in actions
    _assert_record_parity(host.records, dev.records)

    hs, ds = host.summary(), dev.summary()
    assert ds["trained"] == hs["trained"]
    assert ds["skipped"] == hs["skipped"] > 0
    np.testing.assert_allclose(ds["loss_last"], hs["loss_last"],
                               rtol=2e-4, atol=1e-5)
    for key in ("E_total_J", "E_comm_J", "E_proc_J", "E_isl_J"):
        np.testing.assert_allclose(ds[key], hs[key], rtol=1e-5)
    for hsat, dsat in zip(host.sats, dev.sats):
        np.testing.assert_allclose(dsat.battery_j, hsat.battery_j,
                                   rtol=1e-5, atol=0.05)
        assert dsat.passes_served == hsat.passes_served
    # the flight recorder saw every pass, in order, with its action
    ev = dev.device_engine.recorder.events()
    assert list(ev["t"]) == list(range(12))
    assert list(ev["slot"]) == [k % 4 for k in range(12)]
    assert dev.device_engine.recorder.dropped == 0


def test_loss_parity_two_clean_revolutions():
    host, dev = _pair(_budget(), n_passes=8, max_steps_per_pass=8)
    host.run()
    dev.run(engine="device")
    _assert_record_parity(host.records, dev.records)
    hl = np.array([r.loss for r in host.records])
    assert hl[-1] < hl[0]          # still actually learning
    eng = dev.device_engine
    assert eng.traces == 1
    assert eng.host_syncs <= 2     # <= one per revolution


def test_shedding_parity():
    host, dev = _pair(_budget(n_items=4e7), n_passes=4, max_steps_per_pass=4)
    host.run()
    dev.run(engine="device")
    assert all(r.action == "shed" for r in host.records)
    _assert_record_parity(host.records, dev.records, e_rtol=2e-3)


def test_streamed_telemetry_one_sync_per_revolution():
    eng = DeviceConstellationSim(
        ADAPTER, _budget(), SHARDS,
        DeviceSimConfig(n_revolutions=3, max_steps_per_pass=4), device=CPU)
    with sync_budget(3, registry=eng.metrics):
        res = eng.run(stream_telemetry=True)
    assert res.action.shape == (3, 4)
    assert eng.traces == 1         # one revolution program, reused
    assert eng.device_calls == 3
    assert eng.host_syncs == 3     # exactly one per revolution
    res2 = eng.run(1, stream_telemetry=True)
    assert eng.traces == 1
    assert np.isfinite(res2.loss).all()
    assert res2.loss[0, 0] < res.loss[-1, -1]
    with pytest.raises(metrics.SyncBudgetExceeded):
        with sync_budget(1, registry=eng.metrics):
            eng.run(2, stream_telemetry=True)
    assert len(eng.recorder) == 24


def test_engine_plan_matches_host_planner():
    budget = _budget(n_items=400.0)
    host = ConstellationSim(ADAPTER, budget, SHARDS,
                            ConstellationConfig(n_passes=1), device=CPU)
    host.run()
    entry = host.planner.entry_for(
        0, [0, 1, 2, 3], budget, [host._costs_for(s) for s in range(4)])
    plan = host.as_device_sim(n_revolutions=1).plan
    alloc = entry.shed.report.allocation
    np.testing.assert_allclose(plan.e_total_j[0].item(), alloc.e_total,
                               rtol=1e-5)
    np.testing.assert_allclose(
        plan.drain_j[0].item(),
        alloc.e_proc_sat + alloc.e_comm_down + alloc.e_isl, rtol=1e-5)
    np.testing.assert_allclose(plan.t_total_s[0].item(), alloc.t_total,
                               rtol=1e-5)
    assert plan.e_total_j.dtype == torch.float32
    assert plan.n_steps.dtype == torch.int32


def test_sweep_cell_feeds_whole_revolution():
    budget = _budget()
    eng = DeviceConstellationSim(ADAPTER, budget, SHARDS,
                                 DeviceSimConfig(max_steps_per_pass=8),
                                 device=CPU)
    sweep = sweep_revolutions([4], [eng.costs], [16.0], budget=budget,
                              device=CPU)
    plan = sweep.revolution_plan(batch_size=4, cut=0, max_steps_per_pass=8)
    for field in plan._fields:
        np.testing.assert_allclose(
            getattr(plan, field).numpy(), getattr(eng.plan, field).numpy(),
            rtol=1e-6, atol=1e-12, err_msg=field)
    eng2 = DeviceConstellationSim(ADAPTER, budget, SHARDS,
                                  DeviceSimConfig(max_steps_per_pass=8),
                                  plan=plan, device=CPU)
    res = eng2.run()
    assert (res.action == ACTION_TRAINED).all()
    assert np.isfinite(res.loss).all()


def test_delegation_guards():
    """Static-ring preconditions raise ValueError as in the reference;
    an elastic ring, which the reference hands to its fleet engine, raises
    NotImplementedError naming the fleet slice."""
    budget = _budget()

    def sim(data, **kw):
        return ConstellationSim(ADAPTER, budget, data,
                                ConstellationConfig(**kw), device=CPU)

    with pytest.raises(ValueError, match="traceable"):
        sim(lambda s, i: SHARDS(s, i), n_passes=8).run(engine="device")
    with pytest.raises(NotImplementedError, match="fleet slice"):
        sim(SHARDS, n_passes=8, fail_prob=0.5).run(engine="device")
    with pytest.raises(NotImplementedError, match="fleet slice"):
        sim(SHARDS, n_passes=8, join_events={2: 1}).run(engine="device")
    with pytest.raises(ValueError, match="handoff"):
        sim(SHARDS, n_passes=8, fail_prob=0.5,
            handoff_dir="/nonexistent").run(engine="device")
    s = sim(SHARDS, n_passes=7)
    with pytest.raises(ValueError, match="whole number of revolutions"):
        s.run(engine="device")
    with pytest.raises(ValueError, match="unknown engine"):
        s.run(engine="tpu")
    with pytest.raises(ValueError, match="generates on"):
        DeviceConstellationSim(ADAPTER, budget, SHARDS, device="meta")


def test_1000_sat_revolution_no_per_pass_host_transfers():
    """The reference's scale target, uncut: a 1000-satellite ring runs a
    full closed-loop revolution (planning + masked passes + battery,
    recharge and skip policy) as one program: one build, one dispatch,
    one telemetry read."""
    shards = DeviceImageryShards(img=32, batch=2, device=CPU)
    budget = PassBudget(plane=OrbitalPlane(n_sats=1000), n_items=2.0)
    eng = DeviceConstellationSim(
        ADAPTER, budget, shards,
        DeviceSimConfig(n_revolutions=1, max_steps_per_pass=1), device=CPU)
    assert int(eng.plan.n_steps.max()) == 1
    res = eng.run()
    assert eng.traces == 1
    assert eng.device_calls == 1
    assert eng.host_syncs == 1
    assert res.action.shape == (1, 1000)
    assert (res.action == ACTION_TRAINED).all()
    assert np.isfinite(res.loss).all()
    assert (res.energy.passes_served == 1).all()
    assert (res.energy.battery_j >= 0).all()
    assert int(res.state.step) == 1000


def test_plan_ring_passes_per_sat_heterogeneous():
    costs = dataclasses.replace(ADAPTER.costs(), d_isl_bits=1e6)
    dtx = np.array([1e4, 2e4, 3e4, 4e4])
    plan = plan_ring_passes(_budget(), costs, batch_size=4, dtx_bits=dtx,
                            max_steps_per_pass=8, device=CPU)
    e = plan.e_total_j.numpy()
    assert e.shape == (4,)
    assert (np.diff(e) > 0).all()   # heavier payloads cost more energy


def test_chained_delegation_resumes_data_cursor():
    host, dev = _pair(_budget(), n_passes=8, max_steps_per_pass=8)
    host.run()
    dev.cfg.n_passes = 4
    dev.run(engine="device")
    dev.run(engine="device")
    assert dev._batch_idx == host._batch_idx
    _assert_record_parity(host.records, dev.records)


def test_ring_payloads_are_measured_without_generating_batches():
    calls = []

    class Counting(DeviceImageryShards):
        def __call__(self, sat, idx):
            calls.append((sat, idx))
            return super().__call__(sat, idx)

    shards = Counting(img=32, batch=2, device=CPU)
    sim = ConstellationSim(ADAPTER, _budget(n_sats=300), shards,
                           ConstellationConfig(n_passes=300), device=CPU)
    bits = sim._ring_dtx_bits(300)
    assert calls == [] and bits.shape == (300,)
    assert (bits == bits[0]).all() and bits[0] == ADAPTER.costs().dtx_bits
    sim.as_device_sim()
    assert calls == []


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_masked_step_is_a_bitwise_noop(name):
    """A step masked by a device bool leaves params, optimizer state
    (momentum / Adam moments and their step) and the step counter bit for
    bit as they were, and reports NaN; an unmasked one equals the host
    engine's step exactly."""
    opt = getattr(optimizer, name)(lr=0.1)
    step = make_pass_step(ADAPTER, opt)
    batch = SHARDS(0, 0)

    def fresh():
        return SLTrainState.create(*ADAPTER.init(
            torch.Generator().manual_seed(0)), opt)

    def leaves(st):
        from repro_torch.core.train_state import _leaves
        return [t.clone() for t in _leaves(
            [st.params_a, st.params_b, st.opt_a, st.opt_b, st.step])]

    warm, _ = step(fresh(), batch)          # non-zero momentum / moments
    before = leaves(warm)
    masked, loss = step(warm, SHARDS(1, 0), torch.tensor(False))
    assert torch.isnan(loss) and not masked.consumed
    for a, b in zip(before, leaves(masked)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    host, lh = step(fresh(), batch, True)
    dev, ld = step(fresh(), batch, torch.tensor(True))
    assert torch.equal(lh, ld)
    for a, b in zip(leaves(host), leaves(dev)):
        assert torch.equal(a, b)


def test_launch_device_sim_small_on_cpu():
    out = launch_device_sim.main(["--small", "--device", "cpu"])
    assert out["traces"] == 1 and out["host_syncs"] == 4
    revs = out["revolutions"]
    assert revs[0]["trained"] == revs[1]["trained"] == 64
    assert revs[2]["skipped"] == 64           # batteries below reserve
    with pytest.raises(NotImplementedError, match="fleet slice"):
        launch_device_sim.main(["--planes", "2", "--device", "cpu"])


def test_device_engine_matches_reference_host_engine():
    """The reference's host engine (NumPy planner, its own jax.random
    batches) against the port's device engine fed the same batches from
    a table and started from the same weights, on the energy-skip ring:
    actions and satellite ids equal, batteries, e_total and kept
    fractions at the reference's host-vs-device tolerances, losses within
    1e-3 (the two packages' CPU convolutions)."""
    jshards = jdata.DeviceImageryShards(img=32, batch=4)
    jsim = jcon.ConstellationSim(
        jsl.autoencoder_adapter(cut=5, img=32),
        jenergy.PassBudget(plane=jorbits.OrbitalPlane(n_sats=4),
                           n_items=4e6),
        jshards, jcon.ConstellationConfig(batch_size=4, **ENERGY_SKIPS))
    init = [jax_tree_to_numpy(p) for p in (jsim.state.params_a,
                                           jsim.state.params_b)]
    want = jsim.run()

    # every (sat, idx) the device engine may ask for, masked steps too
    n_idx = ENERGY_SKIPS["n_passes"] * ENERGY_SKIPS["max_steps_per_pass"] + 4
    table = [[jax.tree.map(np.asarray, jshards(s, i)) for i in range(n_idx)]
             for s in range(4)]
    provider = BatchTable(
        torch.from_numpy(np.stack([[b["images"] for b in r] for r in table])),
        torch.from_numpy(np.stack([[b["labels"] for b in r]
                                   for r in table])))
    sim = ConstellationSim(ADAPTER, _budget(n_items=4e6), provider,
                           ConstellationConfig(**ENERGY_SKIPS), device=CPU)
    sim.state = SLTrainState.create(*map(from_jax_params, init),
                                    sim.optimizer)
    got = sim.run(engine="device")

    assert {"trained", "skipped_energy"} <= {r.action for r in want}
    assert [r.action for r in got] == [r.action for r in want]
    assert [r.sat_id for r in got] == [r.sat_id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.battery_j, w.battery_j, rtol=1e-5,
                                   atol=0.05)
        np.testing.assert_allclose(g.e_total_j, w.e_total_j, rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_allclose(g.kept_fraction, w.kept_fraction,
                                   rtol=5e-4)
        if w.loss is None:
            assert g.loss is None
        else:
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-3)
