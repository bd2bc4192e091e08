"""The port's elastic fleet engine (``repro_torch.fleet``) on the CPU.

The reference's own fleet engine does not run under this jax (ROADMAP
C1), so the port is held against what does run: the reference's NumPy
``build_event_schedule`` (every array bit for bit), its scenario helpers,
its ``aggregate_planes`` (1e-6) and its NumPy solver, and, plane by
plane, against the reference's host ``ConstellationSim`` (fed the
reference's batches through a table, from the same weights;
losses within 1e-3, the two packages' CPU convolutions) and the port's
host engine (the reference smoke's tolerances: loss 2e-4·|l| + 2e-5,
battery rtol 1e-5 atol 0.05). Actions and serving slots are equal.
Small sizes only: the 32-px autoencoder, 4 satellites, 2 planes, 2
revolutions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import BatchTable, fleet_host_view, one_torch_thread
from repro.core import constellation as jcon
from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import resource_opt as jro
from repro.core import sl_step as jsl
from repro.core.train_state import SLTrainState as JState
from repro.fleet import events as jevents
from repro.fleet import scenarios as jscn
from repro.sim import data as jdata
from repro_torch.core.constellation import (ConstellationConfig,
                                            ConstellationSim)
from repro_torch.core.energy import PassBudget
from repro_torch.core.mission import sweep_revolutions
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter, ring_boundary_bits
from repro_torch.core.train_state import SLTrainState, _leaves
from repro_torch.fleet import (ByzantineConfig, EclipseConfig, EpidemicConfig,
                               FleetConfig, FleetEngine, ScenarioConfig,
                               aggregate_planes, average_planes,
                               build_event_schedule, build_scenario_schedule,
                               epidemic_oracle, epidemic_step,
                               failure_draws, oracle_actions,
                               static_schedule)
from repro_torch.fleet import __main__ as fleet_main
from repro_torch.isl import ExchangeConfig
from repro_torch.models.param import from_jax_params, to_jax_params
from repro_torch.obs.ring import EV_EXCHANGE, EV_PASS
from repro_torch.sim import DeviceImageryShards, plan_ring_passes
from repro_torch.sim.device_sim import (ACTION_FAILED, ACTION_FAULT,
                                        ACTION_NAMES, ACTION_TRAINED,
                                        meta_batch)
from repro_torch.train.optimizer import resolve_optimizer

CPU = "cpu"
SHARDS = DeviceImageryShards(img=32, batch=4, device=CPU)
ADAPTER = autoencoder_adapter(cut=5, img=32)
# the reference tests' elastic scenario (tests/test_fleet.py): one join,
# one leave, seeded failures, batteries tight enough for reserve skips
ELASTIC = dict(join_events={2: 1}, leave_events={5: 0}, fail_prob=0.3)
ENERGY = dict(battery_j=200.0, recharge_w=0.01, reserve_j=150.0,
              max_steps_per_pass=2)
# the two-plane runs: 175 J batteries, so a satellite's second pass in
# two revolutions is a reserve skip
N, P, R = 4, 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _budget(n_sats=N, n_items=4e6):
    return PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=n_items)


def _init(seed=0):
    return SLTrainState.create(*ADAPTER.init(
        torch.Generator().manual_seed(seed)), resolve_optimizer("sgd"))


def _host_sim(budget, seed=0, data=None, **cfg_kw):
    """The port's host engine; the model init pinned to seed 0 whatever
    the failure seed, as the per-plane oracles (seed + p) need."""
    sim = ConstellationSim(ADAPTER, budget, data or SHARDS,
                           ConstellationConfig(seed=seed, **cfg_kw),
                           device=CPU)
    sim.state = _init()
    return sim


class PlaneEclipse:
    """Plane ``p``'s shadow for a host engine, which asks for plane 0."""

    def __init__(self, eclipse, plane):
        self.eclipse, self.plane = eclipse, plane

    def sunlit(self, k, plane=0):
        return self.eclipse.sunlit(k, self.plane)


def _assert_records(host_recs, dev_recs, loss_rtol=2e-4, loss_atol=1e-5):
    """The port's host engine against a delegated device run, record by
    record, at the reference's host-vs-device tolerances."""
    assert [(r.action, r.sat_id) for r in host_recs] == \
        [(r.action, r.sat_id) for r in dev_recs]
    for h, d in zip(host_recs, dev_recs):
        if h.loss is None:
            assert d.loss is None
        else:
            np.testing.assert_allclose(d.loss, h.loss, rtol=loss_rtol,
                                       atol=loss_atol)
        np.testing.assert_allclose(d.battery_j, h.battery_j, rtol=1e-5,
                                   atol=0.05)
        np.testing.assert_allclose(d.e_total_j, h.e_total_j, rtol=1e-5,
                                   atol=1e-9)


# ---------------------------------------------------------------- events

@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("n_initial,n_passes,joins,leaves,fail_prob,planes", [
    (3, 10, {2: 2, 4: 1}, {1: 4, 4: 5}, 0.0, 1),
    (4, 12, {2: 1}, {5: 0}, 0.3, 2),
    (8, 16, {3: 1}, {5: [1, 2], 9: 30}, 0.2, 3),
    (25, 25, {}, {}, 0.5, 2)])
def test_build_event_schedule_matches_reference(legacy, n_initial, n_passes,
                                                joins, leaves, fail_prob,
                                                planes):
    kw = dict(join_events=joins, leave_events=leaves, fail_prob=fail_prob,
              n_planes=planes, seed=7, legacy_streams=legacy)
    got = build_event_schedule(n_initial, n_passes, **kw)
    want = jevents.build_event_schedule(n_initial, n_passes, **kw)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name
    for k in range(n_passes):
        np.testing.assert_array_equal(got.member_at(k), want.member_at(k))
    failed = np.arange(got.n_slots) % 3 == 0
    np.testing.assert_array_equal(got.member_at(4, failed),
                                  want.member_at(4, failed))
    s, w = static_schedule(5, 6, n_planes=2), jevents.static_schedule(
        5, 6, n_planes=2)
    assert np.array_equal(s.fail_mask, w.fail_mask) and s.n_slots == 5


# ------------------------------------------------------------- scenarios

def test_eclipse_and_scenario_schedule_match_reference():
    for period, duty, stagger, phase in [(4, 0.5, 1, 0), (7, 0.3, 2, 3),
                                         (3, 1.0, 0, 0), (5, 0.0, 1, 1)]:
        got = EclipseConfig(period, duty, stagger, phase)
        want = jscn.EclipseConfig(period, duty, stagger, phase)
        assert got.eclipse_passes == want.eclipse_passes
        for k in range(12):
            for plane in range(3):
                assert bool(got.sunlit(k, plane)) == \
                    bool(want.sunlit(k, plane)), (k, plane)
            planes = torch.arange(3)
            np.testing.assert_array_equal(
                got.sunlit(k, planes).numpy(),
                np.asarray(want.sunlit(k, np.arange(3))))
    with pytest.raises(ValueError, match="period"):
        EclipseConfig(0, 0.5)
    with pytest.raises(ValueError, match="duty"):
        EclipseConfig(4, 1.5)
    scn = ScenarioConfig(
        eclipse=EclipseConfig(4, 0.5),
        byzantine=ByzantineConfig(planes=(1,), slots={0: [2]}),
        epidemic=EpidemicConfig(beta=0.4, ttl=2, init_slots=(0, 3)))
    jscn_cfg = jscn.ScenarioConfig(
        eclipse=jscn.EclipseConfig(4, 0.5),
        byzantine=jscn.ByzantineConfig(planes=(1,), slots={0: [2]}),
        epidemic=jscn.EpidemicConfig(beta=0.4, ttl=2, init_slots=(0, 3)))
    assert scn.degraded and not ScenarioConfig().degraded
    got = build_scenario_schedule(scn, 3, 5, 9, seed=4)
    want = jscn.build_scenario_schedule(jscn_cfg, 3, 5, 9, seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    empty = build_scenario_schedule(None, 2, 5, 9)
    assert empty.spread_draw.shape == (2, 1, 5) and not empty.byz_mask.any()


@pytest.mark.parametrize("mode,n_planes", [("mean", 2), ("mean", 3),
                                           ("median", 2), ("median", 3),
                                           ("trimmed_mean", 3)])
def test_aggregate_planes_matches_reference(mode, n_planes):
    """Float leaves become the planes' center, integer leaves stay per
    plane; each plane gets its own copy."""
    rng = np.random.default_rng(3)
    trees = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
              "opt": (rng.standard_normal(5).astype(np.float32),
                      np.int32(p + 1))} for p in range(n_planes)]
    want = jscn.aggregate_planes(
        jax.tree.map(lambda *xs: jnp.stack(xs), *trees), mode)
    got = aggregate_planes(
        [jax.tree.map(torch.as_tensor, t) for t in trees], mode)
    for p in range(n_planes):
        np.testing.assert_allclose(got[p]["w"].numpy(),
                                   np.asarray(want["w"][p]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[p]["opt"][0].numpy(),
                                   np.asarray(want["opt"][0][p]), rtol=1e-6,
                                   atol=1e-6)
        assert int(got[p]["opt"][1]) == int(want["opt"][1][p]) == p + 1
    assert got[0]["w"].data_ptr() != got[1]["w"].data_ptr()
    if mode == "mean":
        assert all(torch.equal(a["w"], b["w"]) for a, b in zip(
            got, average_planes([jax.tree.map(torch.as_tensor, t)
                                 for t in trees])))
    with pytest.raises(ValueError, match="unknown aggregation"):
        aggregate_planes([], "mode")


# --------------------------------- two planes against the host engines

@pytest.fixture(scope="module")
def two_planes():
    """One 2-plane fleet (joins, leaves, seeded failures, reserve skips,
    eclipses staggered by plane; averaging off) on the reference's own
    batches and weights, and per plane the reference's host engine on
    the same batches and the port's host engine on the same table."""
    jshards = jdata.DeviceImageryShards(img=32, batch=4)
    jad = jsl.autoencoder_adapter(cut=5, img=32)
    # one set of weights for every engine, drawn once (the port's init;
    # the reference's own costs seconds of compilation per draw)
    init = [to_jax_params(t) for t in ADAPTER.init(
        torch.Generator().manual_seed(0))]
    eclipse = EclipseConfig(period=4, duty=0.5, stagger=1)
    energy = dict(ENERGY, battery_j=175.0)
    cfg = FleetConfig(n_planes=P, n_revolutions=R, seed=0, avg_every=0,
                      scenario=ScenarioConfig(eclipse=eclipse), **ELASTIC,
                      **energy)
    M = N + 1
    n_idx = R * N * ENERGY["max_steps_per_pass"] + 2
    # every (sat, idx) batch the fleet may ask for, masked steps too, made
    # by the reference's provider in one vmapped call
    table = jax.tree.map(np.array, jax.jit(jax.vmap(jax.vmap(
        jshards, (None, 0)), (0, None)))(jnp.arange(P * M),
                                          jnp.arange(n_idx)))
    provider = BatchTable(torch.from_numpy(table["images"]),
                          torch.from_numpy(table["labels"]))

    def ref_batch(sat, idx):
        return {k: v[sat, idx] for k, v in table.items()}
    opt = resolve_optimizer("sgd")

    def port_init():
        return SLTrainState.create(*map(from_jax_params, init), opt)

    fleet = FleetEngine(ADAPTER, _budget(), provider, cfg,
                        state=port_init(), device=CPU)
    assert fleet.n_slots == M
    res = fleet.run(stream_telemetry=True)

    ref_hosts, port_hosts = [], []
    # the reference's host engines start from the same weights, not a
    # draw of their own
    jad_init = dataclasses.replace(
        jad, init=lambda key: tuple(jax.tree.map(jnp.asarray, init)))
    for p in range(P):
        jsim = jcon.ConstellationSim(
            jad_init, jenergy.PassBudget(plane=jorbits.OrbitalPlane(n_sats=N),
                                    n_items=4e6),
            lambda s, i, p=p: ref_batch(p * M + s, i),
            jcon.ConstellationConfig(
                n_passes=R * N, batch_size=4, seed=p,
                eclipse=PlaneEclipse(eclipse, p), **ELASTIC, **energy))
        jsim.state = JState.create(*jax.tree.map(jnp.asarray, init),
                                   jsim.optimizer)
        jsim.run()
        ref_hosts.append(jsim)
        host = ConstellationSim(
            ADAPTER, _budget(), lambda s, i, p=p: provider(p * M + s, i),
            ConstellationConfig(n_passes=R * N, seed=p,
                                eclipse=PlaneEclipse(eclipse, p),
                                **ELASTIC, **energy), device=CPU)
        host.state = port_init()
        host.run()
        port_hosts.append(host)
    return fleet, res, ref_hosts, port_hosts


def _plane_parity(hosts, res, loss_tol):
    failures = 0
    for p, host in enumerate(hosts):
        assert [r.action for r in host.records] == \
            [ACTION_NAMES[int(a)] for a in res.action[p]]
        assert [r.sat_id for r in host.records] == res.sat[p].tolist()
        for hr, dl, db in zip(host.records, res.loss[p], res.battery_j[p]):
            if hr.loss is None:
                assert not np.isfinite(dl)
            else:
                assert abs(dl - hr.loss) <= loss_tol(hr.loss), (dl, hr.loss)
            np.testing.assert_allclose(db, hr.battery_j, rtol=1e-5,
                                       atol=0.05)
        failures += sum(r.action == "failed" for r in host.records)
    return failures


def test_two_planes_match_the_reference_host_engine(two_planes):
    fleet, res, ref_hosts, _ = two_planes
    assert res.action.shape == (P, R * N)
    assert fleet.traces == 1 and fleet.host_syncs == R
    failures = _plane_parity(ref_hosts, res, lambda h: 1e-3 * abs(h))
    assert failures > 0 and res.summary()["failed"] == failures
    acts = {r.action for h in ref_hosts for r in h.records}
    assert {"trained", "skipped_energy", "failed"} <= acts
    # joins, leaves and eclipses all happened: a joined slot served, the
    # slot that left never served after its pass, some passes were dark
    assert (res.sat == N).any()
    assert not (res.sat[:, 5:] == 0).any()
    ev = fleet.recorder.events()
    lit = ev["payload"][ev["kind"] == EV_PASS][:, 6]
    assert (lit == 0).any() and (lit == 1).any()
    assert len(ev["kind"]) == P * R * N and fleet.recorder.dropped == 0


def test_two_planes_match_the_port_host_engine(two_planes):
    fleet, res, _, port_hosts = two_planes
    _plane_parity(port_hosts, res, lambda h: 2e-4 * abs(h) + 2e-5)
    for p, host in enumerate(port_hosts):
        left = fleet.schedule.leave_pass < R * N
        np.testing.assert_array_equal(res.failed[p] | left,
                                      [not s.alive for s in host.sats])
        np.testing.assert_allclose(res.energy.battery_j[p],
                                   [s.battery_j for s in host.sats],
                                   rtol=1e-5, atol=0.05)
        assert list(res.energy.passes_served[p]) == \
            [s.passes_served for s in host.sats]
        assert int(fleet._batch_idx[p]) == host._batch_idx
    hs = port_hosts[0].summary()
    assert set(res.summary()) >= set(hs)


# ------------------------------------------------------ inter-plane mean

def test_interplane_averaging_matches_manual_mean():
    """avg_every=1 equals the planes run apart with their states averaged
    by hand at the boundary: the same losses in both revolutions, every
    float leaf (params and momentum) equal across planes after it, one
    EV_EXCHANGE per plane and boundary; avg_every=0 keeps the planes
    apart."""
    budget = _budget(n_items=16.0)
    kw = dict(n_planes=P, n_revolutions=2, max_steps_per_pass=2, seed=0)
    avg = FleetEngine(ADAPTER, budget, SHARDS, FleetConfig(avg_every=1, **kw),
                      state=_init(), device=CPU)
    res = avg.run(stream_telemetry=True)
    apart = FleetEngine(ADAPTER, budget, SHARDS,
                        FleetConfig(avg_every=0, **kw), state=_init(),
                        device=CPU)
    first = apart.run(1)
    leaves = [_leaves(s._fields()) for s in apart.states]
    assert not torch.equal(leaves[0][0], leaves[1][0])    # independent
    manual = average_planes([s._fields() for s in apart.states])
    for col in zip(*[_leaves(t) for t in manual]):
        assert torch.equal(col[0], col[1])
    apart.states = [SLTrainState(*t) for t in manual]
    second = apart.run(1)
    np.testing.assert_allclose(
        res.loss, np.concatenate([first.loss, second.loss], axis=1),
        rtol=1e-6, atol=1e-7)
    for col in zip(*[_leaves(s._fields()) for s in avg.states]):
        if col[0].is_floating_point():
            assert torch.equal(col[0], col[1])
    ev = avg.recorder.events()
    assert (ev["kind"] == EV_EXCHANGE).sum() == 2 * P
    assert not (apart.recorder.events()["kind"] == EV_EXCHANGE).any()


# ----------------------------------------------------------- delegation

def test_seeded_failure_delegation_matches_host():
    """``run(engine="device")`` on an elastic ring runs on the fleet (a
    one-plane fleet) and equals the host run: records, the folded-back
    satellites (joiners appended, failed or left ones dead), the data
    cursor, the summary; one sync per revolution."""
    budget = _budget()
    host, dev = (_host_sim(budget, n_passes=12, **ELASTIC, **ENERGY)
                 for _ in range(2))
    host.run()
    dev.run(engine="device")
    _assert_records(host.records, dev.records)
    assert {"failed", "skipped_energy", "trained"} <= \
        {r.action for r in host.records}
    hs, ds = host.summary(), dev.summary()
    for key in ("passes", "trained", "skipped", "failed"):
        assert hs[key] == ds[key], key
    np.testing.assert_allclose(ds["E_total_J"], hs["E_total_J"], rtol=1e-5)
    assert len(dev.sats) == len(host.sats) == N + 1
    for hsat, dsat in zip(host.sats, dev.sats):
        assert (dsat.alive, dsat.passes_served, dsat.joined_pass) == \
            (hsat.alive, hsat.passes_served, hsat.joined_pass)
        np.testing.assert_allclose(dsat.battery_j, hsat.battery_j,
                                   rtol=1e-5, atol=0.05)
    assert dev._batch_idx == host._batch_idx
    eng = dev.device_engine
    assert eng.traces == 1 and eng.host_syncs == 3
    # the measured per-satellite payloads planned the ring, shape-only
    expect = ring_boundary_bits(ADAPTER, [meta_batch(SHARDS, m, 0)
                                          for m in range(N + 1)]) / 4.0
    np.testing.assert_array_equal(eng.dtx_bits, expect)


@pytest.mark.parametrize("case", ["chained", "ragged", "eclipse"])
def test_elastic_delegation_cases(case):
    """Two chained elastic runs (the second ring carries the first's
    joiner and casualties; one failure stream across both), a ragged run
    (K not a multiple of N: one dispatch) and a static ring with
    eclipses, each equal to the host engine."""
    budget = _budget(n_items=16.0)
    kw = {"chained": dict(n_passes=6, join_events={1: 1}, fail_prob=0.3,
                          max_steps_per_pass=2),
          "ragged": dict(n_passes=7, fail_prob=0.4, max_steps_per_pass=2),
          "eclipse": dict(n_passes=8, max_steps_per_pass=2,
                          eclipse=EclipseConfig(period=3, duty=0.4),
                          **{k: v for k, v in ENERGY.items()
                             if k != "max_steps_per_pass"})}[case]
    host, dev = (_host_sim(budget, **kw) for _ in range(2))
    runs = 2 if case == "chained" else 1
    for _ in range(runs):
        host.run()
        dev.run(engine="device")
    _assert_records(host.records, dev.records)
    assert len(dev.records) == runs * kw["n_passes"]
    assert len(dev.sats) == len(host.sats)
    for hsat, dsat in zip(host.sats, dev.sats):
        assert dsat.alive == hsat.alive
        np.testing.assert_allclose(dsat.battery_j, hsat.battery_j,
                                   rtol=1e-5, atol=0.05)
    assert dev._batch_idx == host._batch_idx
    eng = dev.device_engine
    assert eng.host_syncs == (2 if case == "eclipse" else 1)
    if case == "chained":
        assert eng.n_initial == N + 1          # the first run's joiner
        assert "failed" in {r.action for r in host.records}
    if case == "eclipse":
        assert isinstance(eng.cfg.scenario.eclipse, EclipseConfig)


# ------------------------------------------------------------- planning

def test_fleet_plan_rows_match_the_reference_solver():
    """All P×M instances in one call with per-satellite dtx rows, row by
    row the reference's NumPy shedding solver."""
    costs = dataclasses.replace(ADAPTER.costs(), d_isl_bits=1e6)
    dtx = np.array([[1e4, 2e4, 3e4, 4e4], [4e4, 3e4, 2e4, 1e4]])
    budget = _budget(n_items=4e6)
    plan = plan_ring_passes(budget, costs, batch_size=4, n_sats=(2, 4),
                            ring_n=4, dtx_bits=dtx, max_steps_per_pass=8,
                            device=CPU).to_host()
    assert plan.e_total_j.shape == (2, 4)
    jb = jenergy.PassBudget(plane=jorbits.OrbitalPlane(n_sats=4),
                            n_items=4e6)
    jc = [jenergy.SplitCosts(costs.w1_flops, costs.w2_flops, float(d),
                             1e6) for d in dtx.reshape(-1)]
    want = jro.solve_with_shedding_batch([jb] * 8, jc, backend="numpy")
    np.testing.assert_allclose(plan.e_total_j.reshape(-1),
                               want.report.e_total, rtol=2e-3)
    np.testing.assert_allclose(plan.kept_fraction.reshape(-1),
                               want.kept_fraction, rtol=5e-4)
    np.testing.assert_allclose(plan.e_total_j[1], plan.e_total_j[0, ::-1],
                               rtol=1e-6)


def test_sweep_cell_feeds_the_fleet():
    budget = _budget(n_items=16.0)
    cfg = FleetConfig(n_planes=2, n_revolutions=1, max_steps_per_pass=2,
                      seed=0)
    fleet = FleetEngine(ADAPTER, budget, SHARDS, cfg, device=CPU)
    sweep = sweep_revolutions([N], [fleet.costs], [16.0], budget=budget,
                              device=CPU)
    plan = sweep.fleet_plan(4, 2, cut=0, max_steps_per_pass=2)
    for field in plan._fields:
        np.testing.assert_allclose(
            getattr(plan, field).numpy(), getattr(fleet.plan, field).numpy(),
            rtol=1e-6, atol=1e-12, err_msg=field)
    res = FleetEngine(ADAPTER, budget, SHARDS, cfg, plan=plan,
                      device=CPU).run()
    assert (res.action == ACTION_TRAINED).all()
    assert np.isfinite(res.loss).all()
    with pytest.raises(ValueError, match="fleet layout"):
        FleetEngine(ADAPTER, budget, SHARDS, dataclasses.replace(
            cfg, n_planes=3), plan=plan, device=CPU)


# ----------------------------------------------- chaining, device rules

def test_chaining_counters_and_draws_beyond_the_horizon():
    """Chained runs reuse the program and keep one sync per revolution;
    past the precomputed horizon the failures come from the counter hash,
    deterministic by seed and at fail_prob's rate."""
    budget = _budget(n_items=4.0)
    cfg = FleetConfig(n_planes=2, n_revolutions=1, max_steps_per_pass=1,
                      seed=5, fail_prob=0.3)
    runs = []
    for _ in range(2):
        fleet = FleetEngine(ADAPTER, budget, SHARDS, cfg, device=CPU)
        fleet.run(stream_telemetry=True)
        runs.append(fleet.run(2, stream_telemetry=True))
        assert fleet.traces == 1
        assert fleet.device_calls == fleet.host_syncs == 3
        assert fleet._pass_idx == 3 * N
        assert len(fleet.recorder) == 3 * (N + 1) * P    # + EV_EXCHANGE
    assert np.array_equal(runs[0].action, runs[1].action)
    assert np.array_equal(runs[0].failed, runs[1].failed)
    def draws(seed, n):
        return torch.stack([failure_draws(seed, k, 2, 0.3, CPU)
                            for k in range(N, N + n)])

    many = draws(5, 1000)                     # 2000 draws: sd 0.010
    assert torch.equal(many[:200], draws(5, 200))
    assert not torch.equal(many[:200], draws(6, 200))
    assert abs(many.float().mean().item() - 0.3) < 0.04
    assert not torch.equal(many[:, 0], many[:, 1])


@pytest.mark.parametrize("what", ["exchange", "byzantine", "epidemic",
                                  "smoke"])
def test_next_slice_configs_raise(what, monkeypatch):
    """The configs the fleet refused before the ISL exchange and the
    degraded-ops stressors were ported now construct and run one
    revolution on the CPU (the name and ids are kept): an async exchange
    meters its pushes, a Byzantine plane's checkpoint leaves the honest
    run's, an epidemic faults passes, and ``--scenario degraded`` returns
    its summary with faults."""
    if what == "smoke":
        monkeypatch.setenv("REPRO_FLEET_SMOKE_SATS", "4")
        s = fleet_main.main(["--scenario", "degraded", "--device", CPU])
        assert s["faulted"] > 0 and s["passes"] == 2 * 2 * 4
        return
    cfg = {"exchange": FleetConfig(n_planes=2, avg_every=0,
                                   exchange=ExchangeConfig()),
           "byzantine": FleetConfig(n_planes=2, avg_every=0,
                                    scenario=ScenarioConfig(
                                        byzantine=ByzantineConfig(
                                            planes=(0,)))),
           "epidemic": FleetConfig(scenario=ScenarioConfig(
               epidemic=EpidemicConfig()))}[what]
    cfg = dataclasses.replace(cfg, n_revolutions=1, max_steps_per_pass=2)
    fleet = FleetEngine(ADAPTER, _budget(), SHARDS, cfg, state=_init(),
                        device=CPU)
    expect = oracle_actions(fleet)
    res = fleet.run()
    np.testing.assert_array_equal(res.action, expect)
    assert res.action.shape == (cfg.n_planes, N)
    if what == "exchange":
        assert fleet._ex_on and (res.isl_contacts == N).all()
        assert (res.isl_bits > 0).all() and (res.isl_e_j > 0).all()
    elif what == "byzantine":
        a, b = (_leaves((s.params_a, s.params_b)) for s in res.state)
        assert not any(torch.equal(x, y) for x, y in zip(a, b))
        assert np.isfinite(res.loss).all()
    else:
        assert (res.action == ACTION_FAULT).any()
        assert res.summary()["faulted"] == int((res.action == ACTION_FAULT)
                                               .sum())


# ------------------------------------------- degraded-ops stressors

@pytest.mark.parametrize("beta,ttl,init,start,M", [
    (1.0, 2, (0,), 0, 6), (0.0, 3, (2,), 1, 4), (0.5, 4, (0, 3), 0, 6),
    (0.3, 1, (1,), 2, 5)])
def test_epidemic_matches_reference(beta, ttl, init, start, M):
    """``epidemic_step`` (NumPy and tensors) and ``epidemic_oracle`` equal
    the reference's, bit for bit, on the reference's draws."""
    kw = dict(beta=beta, ttl=ttl, init_slots=init, start=start)
    scn = ScenarioConfig(epidemic=EpidemicConfig(**kw))
    jscn_cfg = jscn.ScenarioConfig(epidemic=jscn.EpidemicConfig(**kw))
    sched = build_scenario_schedule(scn, 3, M, 10, seed=2)
    want = jscn.epidemic_oracle(jscn_cfg, jscn.build_scenario_schedule(
        jscn_cfg, 3, M, 10, seed=2))
    np.testing.assert_array_equal(epidemic_oracle(scn, sched), want)
    ttl_t = torch.zeros((3, M), dtype=torch.int32)
    ttl_j = np.zeros((3, M), np.int64)
    for k in range(10):
        f_t, ttl_t = epidemic_step(ttl_t, torch.from_numpy(
            sched.spread_draw[:, k]), k, scn.epidemic,
            torch.from_numpy(sched.init_mask), xp=torch)
        np.testing.assert_array_equal(f_t.numpy(), want[:, k])
        for p in range(3):
            f_j, ttl_j[p] = jscn.epidemic_step(
                ttl_j[p], sched.spread_draw[p, k], k, jscn_cfg.epidemic,
                sched.init_mask)
            np.testing.assert_array_equal(f_j, want[p, k])
        np.testing.assert_array_equal(ttl_t.numpy(), ttl_j)
    assert not epidemic_oracle(None, sched).any()


def test_epidemic_prefix_parity_and_beyond_horizon():
    """The fleet's actions equal the oracle over the precomputed horizon
    (the port's and the reference's, on the same host arrays); chained
    runs past it keep drawing epidemic spreads and failures (from the
    counter hash)."""
    scn = ScenarioConfig(epidemic=EpidemicConfig(
        beta=0.5, ttl=4, init_slots=(0, 3), start=0))
    fleet = FleetEngine(ADAPTER, _budget(n_sats=6), SHARDS, FleetConfig(
        n_planes=2, n_revolutions=2, max_steps_per_pass=2, seed=3,
        fail_prob=0.1, avg_every=0, scenario=scn), device=CPU)
    expect = oracle_actions(fleet)
    np.testing.assert_array_equal(expect, jscn.oracle_actions(
        fleet_host_view(fleet)))
    res = fleet.run(stream_telemetry=True)
    np.testing.assert_array_equal(res.action, expect)
    assert (res.action == ACTION_FAULT).sum() > 0
    assert res.summary()["faulted"] == (res.action == ACTION_FAULT).sum()
    # every faulted slot is counted, serving or not
    assert (res.n_infected >= (res.action == ACTION_FAULT)).all()
    assert res.n_infected.max() > 1
    ev = fleet.recorder.events()
    pay = ev["payload"][ev["kind"] == EV_PASS]
    np.testing.assert_array_equal(pay[:, 7], res.n_infected.T.reshape(-1))

    res2 = fleet.run(4, stream_telemetry=True)
    assert fleet.traces == 1 and fleet.host_syncs == 6
    assert (res2.action == ACTION_FAULT).sum() > 0, "epidemic froze"
    assert (res2.action == ACTION_FAILED).sum() > 0, "failures froze"
    assert fleet._pass_idx == 36


def test_epidemic_faulted_slot_pays_no_energy():
    """A faulted pass is a masked no-op: no drain, no valid steps, no
    loss; the slot trains again once its ttl has run out."""
    scn = ScenarioConfig(epidemic=EpidemicConfig(
        beta=0.0, ttl=2, init_slots=(1,), start=1))
    fleet = FleetEngine(ADAPTER, _budget(), SHARDS, FleetConfig(
        n_planes=1, n_revolutions=3, max_steps_per_pass=2, seed=0,
        scenario=scn), device=CPU)
    expect = oracle_actions(fleet)
    res = fleet.run()
    np.testing.assert_array_equal(res.action, expect)
    # slot 1 serves passes 1, 5, 9; infected at passes 1-2 only
    assert res.action[0, 1] == ACTION_FAULT
    assert res.n_steps[0, 1] == 0 and not np.isfinite(res.loss[0, 1])
    assert res.action[0, 5] == ACTION_TRAINED
    assert res.action[0, 9] == ACTION_TRAINED
    assert res.energy.passes_served[0, 1] == 2
    assert res.energy.passes_skipped[0, 1] == 0
    assert (res.fault_ttl == 0).all()


@pytest.fixture(scope="module")
def clean_four_planes():
    return _four_planes(None, "mean")


def _four_planes(scenario, aggregate):
    """4 planes x 4 satellites x 4 revolutions, averaged every revolution:
    the mean of the honest planes' (0-2) last losses."""
    fleet = FleetEngine(ADAPTER, _budget(), SHARDS, FleetConfig(
        n_planes=4, n_revolutions=4, max_steps_per_pass=2, seed=0,
        avg_every=1, scenario=scenario, aggregate=aggregate), device=CPU)
    res = fleet.run(stream_telemetry=True)
    assert fleet.traces == 1 and fleet.host_syncs == 4
    return float(np.mean([row[np.isfinite(row)][-1]
                          for row in res.loss[:3]]))


@pytest.mark.parametrize("aggregate,mode,scale", [
    ("trimmed_mean", "sign_flip", 8.0), ("median", "scaled_noise", 5.0)])
def test_robust_aggregation_recovers_from_a_byzantine_plane(
        clean_four_planes, aggregate, mode, scale):
    """One of 4 planes corrupts every update it makes (the reference's
    tests/test_scenarios.py:120,150, at 4 revolutions of 2 steps a pass):
    the robust center recovers the honest planes' last loss to within 10%
    of the clean run, where the plain mean is poisoned (sign_flip)."""
    byz = ScenarioConfig(byzantine=ByzantineConfig(planes=(3,), mode=mode,
                                                   scale=scale))
    clean = clean_four_planes
    assert np.isfinite(clean) and clean > 0
    recovered = _four_planes(byz, aggregate)
    assert abs(recovered - clean) <= 0.10 * clean, (recovered, clean)
    if mode == "sign_flip":
        poisoned = _four_planes(byz, "mean")
        assert poisoned > 10.0 * clean, (poisoned, clean)


def test_fleet_runs_on_cuda_unless_asked(monkeypatch):
    budget = _budget()
    with pytest.raises(ValueError, match="generates on"):
        FleetEngine(ADAPTER, budget, SHARDS, device="meta")
    with pytest.raises(ValueError, match="planes"):
        FleetEngine(ADAPTER, budget, SHARDS, FleetConfig(n_planes=2),
                    schedule=build_event_schedule(N, N), device=CPU)
    with pytest.raises(ValueError, match="aggregation"):
        FleetEngine(ADAPTER, budget, SHARDS, FleetConfig(aggregate="max"),
                    device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FleetEngine(ADAPTER, budget, DeviceImageryShards(img=32, batch=4))


def test_python_m_fleet_smoke_on_cpu(monkeypatch):
    """``python -m repro_torch.fleet --device cpu`` at 4 satellites: the
    reference smoke's config against the port's host engine per plane."""
    monkeypatch.setenv("REPRO_FLEET_SMOKE_SATS", "4")
    s = fleet_main.main(["--device", CPU])
    assert s["passes"] == 2 * 2 * 4
    assert s["failed"] > 0 and s["skipped"] > 0 and s["trained"] > 0
