"""The port's ISL exchange (``repro_torch.isl``) on the CPU.

The reference's fleet engine does not run under this jax (ROADMAP C1), so
the port is held against what does run, on the same NumPy inputs:

* ``ContactConfig`` arithmetic for k in [0, 200), rates, capacities and
  energies, the codec's labels, bits and ``encode_delta``, and
  ``staleness_weight``: exact;
* the reference's ``async_gossip_step`` and ``sync_exchange_step``,
  called directly on a 3-plane reference ``SLTrainState`` (one plane's
  pass FAILED), against the port's steps: meters, batteries, residuals
  and ring rows exact, merged parameters within rtol 1e-6, atol 1e-7;
* the reference's NumPy oracles ``oracle_actions`` and
  ``oracle_exchange`` on a namespace of a fresh port fleet's host arrays:
  equal to the port's copies and to the port fleet's run, bit for bit.

And the port's own behaviour, carried over from the reference's
``tests/test_isl.py``: sync top-k at ratio 1.0 tracks the free average,
an over-capacity payload never transfers, the codec moves the plan,
contacts continue past the horizon; and the three smokes on the CPU.
Small sizes only: the 32-px autoencoder, 4 satellites, 2-3 planes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import fleet_host_view, one_torch_thread
from repro import isl as jisl
from repro.core import linkbudget as jlb
from repro.core.train_state import SLTrainState as JState
from repro.fleet import scenarios as jscn
from repro.isl import exchange as jx
from repro.obs import ring as jring
from repro.sim import energy_state as jes
from repro.train import optimizer as jopt
from repro_torch.core import linkbudget as tlb
from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.core.train_state import SLTrainState, _leaves
from repro_torch.fleet import (ByzantineConfig, EclipseConfig, EpidemicConfig,
                               FleetConfig, FleetEngine, ScenarioConfig,
                               oracle_actions)
from repro_torch.fleet import __main__ as fleet_main
from repro_torch.isl import (CodecConfig, ContactConfig, ExchangeConfig,
                             ExchangeState, async_gossip_step, codec_label,
                             delta_payload_bits, encode_delta,
                             exchange_events, oracle_exchange, residual_init,
                             staleness_weight, sync_exchange_step)
from repro_torch.isl import __main__ as isl_main
from repro_torch.obs.ring import EV_EXCHANGE, ring_init
from repro_torch.sim import DeviceImageryShards
from repro_torch.sim import device_sim
from repro_torch.sim.device_sim import (ACTION_FAILED, ACTION_TRAINED)
from repro_torch.sim.energy_state import EnergyState
from repro_torch.train.optimizer import resolve_optimizer

CPU = "cpu"
SHARDS = DeviceImageryShards(img=32, batch=4, device=CPU)
ADAPTER = autoencoder_adapter(cut=5, img=32)
# batteries tight enough for reserve skips (tests/test_torch_fleet.py)
ENERGY = dict(battery_j=200.0, recharge_w=0.01, reserve_j=150.0)
COLUMNS = ("t", "aggregate", "slot", "bits", "e_isl_j", "staleness",
           "weight")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _budget(n_sats=4):
    return PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=4e6)


def _fleet(budget=None, **cfg_kw):
    kw = dict(n_planes=2, n_revolutions=2, max_steps_per_pass=2, seed=0)
    kw.update(cfg_kw)
    return FleetEngine(ADAPTER, budget or _budget(), SHARDS,
                       FleetConfig(**kw), device=CPU)


# ------------------------------------------------------- contact model

@pytest.mark.parametrize("period,phase,offsets", [
    (1, 0, (1,)), (3, 1, (1, 2)), (4, 3, (2, 1, 3)), (7, 0, (1,))])
def test_contact_schedule_matches_reference(period, phase, offsets):
    got = ContactConfig(period=period, phase=phase, offsets=offsets)
    want = jisl.ContactConfig(period=period, phase=phase, offsets=offsets)
    for k in range(200):
        assert bool(got.open_at(k)) == bool(want.open_at(k))
        assert got.contact_index(k) == want.contact_index(k)
        assert int(got.offset_at(k)) == int(want.offset_at(k))
        assert int(got.partner(2, k, 4)) == int(want.partner(2, k, 4))
    ks = np.arange(200)
    np.testing.assert_array_equal(got.open_at(ks), want.open_at(ks))
    np.testing.assert_array_equal(got.offset_at(ks), want.offset_at(ks))
    for start in (0, 5, 199):
        assert got.contacts_in(37, start) == want.contacts_in(37, start)
    with pytest.raises(ValueError, match="period"):
        ContactConfig(period=0)
    with pytest.raises(ValueError, match="window"):
        ContactConfig(window_s=0.0)
    with pytest.raises(ValueError, match="offset"):
        ContactConfig(offsets=())


def test_contact_rates_capacity_energy_match_reference():
    cases = [(dict(window_s=0.5), None), (dict(), None),
             (dict(window_s=0.5, distance_m=1e6), "link"),
             (dict(window_s=2.0, distance_m=3e6), None)]
    for isl_kw in (dict(rate_bps=1e6, tx_power_w=2.0), dict()):
        for cc_kw, link in cases:
            got, want = ContactConfig(**cc_kw), jisl.ContactConfig(**cc_kw)
            ti, ji = tlb.ISLConfig(**isl_kw), jlb.ISLConfig(**isl_kw)
            tl, jl = ((tlb.LinkConfig(), jlb.LinkConfig()) if link
                      else (None, None))
            assert got.rate_bps(ti, tl) == want.rate_bps(ji, jl)
            assert got.capacity_bits(ti, tl) == want.capacity_bits(ji, jl)
            assert got.tx_energy_j(1.5e6, ti, tl) == \
                want.tx_energy_j(1.5e6, ji, jl)
    isl = tlb.ISLConfig(rate_bps=1e6, tx_power_w=2.0)
    assert ContactConfig(window_s=0.5).capacity_bits(isl) == 5e5
    assert ContactConfig().tx_energy_j(1e6, isl) == pytest.approx(2.0)


# --------------------------------------------------------------- codec

def test_codec_labels_bits_and_validation():
    tree = {"w": torch.zeros((32, 32)), "b": torch.zeros((32,))}
    jtree = {"w": jnp.zeros((32, 32)), "b": jnp.zeros((32,))}
    kws = [dict(scheme="none"), dict(scheme="int8"),
           dict(scheme="topk", topk_ratio=0.10),
           dict(scheme="topk", topk_ratio=0.01),
           dict(scheme="topk", topk_ratio=0.125)]
    for kw in kws:
        got, want = CodecConfig(**kw), jisl.CodecConfig(**kw)
        assert codec_label(got) == jisl.codec_label(want)
        assert delta_payload_bits(tree, got) == \
            jisl.delta_payload_bits(jtree, want)
    bits = [delta_payload_bits(tree, CodecConfig(**kw)) for kw in kws[:4]]
    assert bits == sorted(bits, reverse=True) and bits[-1] > 0
    with pytest.raises(ValueError, match="scheme"):
        CodecConfig("fft")
    with pytest.raises(ValueError, match="ratio"):
        CodecConfig("topk", topk_ratio=0.0)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
def test_encode_delta_matches_reference(scheme):
    rng = np.random.default_rng(5)

    def tree():
        return ({"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                 "b": rng.standard_normal((4,)).astype(np.float32)},
                {"w": rng.standard_normal((6, 5)).astype(np.float32)})
    params, anchor, resid = tree(), tree(), tree()
    got_k, got_r = encode_delta(*[jax.tree.map(torch.from_numpy, t) for t in
                                  (params, anchor, resid)],
                                CodecConfig(scheme, topk_ratio=0.2))
    want_k, want_r = jisl.encode_delta(
        *[jax.tree.map(jnp.asarray, t) for t in (params, anchor, resid)],
        jisl.CodecConfig(scheme, topk_ratio=0.2))
    for g, w in zip(_leaves((got_k, got_r)), jax.tree.leaves((want_k,
                                                              want_r))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    zero = residual_init(jax.tree.map(torch.from_numpy, params))
    assert all(not t.any() and t.dtype == torch.float32
               for t in _leaves(zero))


def test_exchange_config_and_staleness_weight():
    with pytest.raises(ValueError, match="mode"):
        ExchangeConfig(mode="carrier_pigeon")
    with pytest.raises(ValueError, match="mix"):
        ExchangeConfig(mix=0.0)
    with pytest.raises(ValueError, match="staleness"):
        ExchangeConfig(staleness_lam=-1.0)
    for mode, period, L, every in [("async", 4, 8, 1), ("sync", 1, 8, 2),
                                   ("sync", 1, 8, 0), ("async", 3, 5, 0)]:
        got = ExchangeConfig(mode=mode, contact=ContactConfig(period=period))
        want = jisl.ExchangeConfig(mode=mode,
                                   contact=jisl.ContactConfig(period=period))
        assert got.mean_contacts_per_pass(L, every) == \
            want.mean_contacts_per_pass(L, every)
    s = np.arange(0, 300, dtype=np.float32) * np.float32(0.37)
    for mix, lam in [(0.5, 0.1), (0.4, 0.2), (1.0, 0.0), (0.3, 1.7)]:
        want = np.asarray(jisl.staleness_weight(jnp.asarray(s), mix, lam,
                                                xp=jnp))
        got_np = staleness_weight(s, mix, lam)
        got_t = staleness_weight(torch.from_numpy(s), mix, lam, xp=torch)
        assert got_np.dtype == got_t.numpy().dtype == np.float32
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)
    assert staleness_weight(0, 0.5, 0.1) == np.float32(0.5)


# ------------------------- the exchange steps against the reference's

SP, SM, SK_OPEN, SK_SHUT = 3, 4, 6, 5
STEP_CONTACT = dict(period=2, offsets=(1, 2))   # k=6: contact 3, offset 2


def _step_inputs(seed=11):
    """NumPy inputs of one exchange step on 3 planes: params, momentum,
    anchors, residuals, meters, batteries, the serving slots and actions
    (plane 1's pass FAILED; plane 2's slot holds too little charge for
    the push, so its battery clamps at 0)."""
    rng = np.random.default_rng(seed)

    def tree(scale=1.0):
        f = lambda *s: (scale * rng.standard_normal((SP,) + s)  # noqa: E731
                        ).astype(np.float32)
        return ({"b": f(4), "w": f(3, 3, 2, 4)}, {"w": f(6, 5)})
    battery = rng.uniform(60.0, 200.0, (SP, SM)).astype(np.float32)
    battery[2, 0] = 30.0
    return dict(
        params=tree(), momentum=tree(0.1), anchor=tree(),
        residual=tree(0.01), battery=battery,
        spent=rng.uniform(0.0, 50.0, (SP, SM)).astype(np.float32),
        last_k=np.array([0, 2, 4], np.int32),
        bits=np.array([1e6, 2e6, 3e6], np.float32),
        e_j=np.array([0.1, 0.2, 0.3], np.float32),
        n_contacts=np.array([1, 2, 3], np.int32),
        sat=np.array([1, 3, 0], np.int32),
        action=np.array([ACTION_TRAINED, ACTION_FAILED, ACTION_TRAINED],
                        np.int32))


def _reference_side(d):
    j = lambda t: jax.tree.map(jnp.asarray, t)                # noqa: E731
    sgd = jopt.resolve_optimizer("sgd")
    state = jax.vmap(lambda a, b: JState.create(a, b, sgd))(
        *j(d["params"]))
    state = state.replace(
        opt_a=state.opt_a._replace(momentum=j(d["momentum"][0])),
        opt_b=state.opt_b._replace(momentum=j(d["momentum"][1])))
    ex = jx.ExchangeState(
        anchor=j(d["anchor"]), residual=j(d["residual"]),
        last_k=jnp.asarray(d["last_k"]), bits=jnp.asarray(d["bits"]),
        e_j=jnp.asarray(d["e_j"]), n_contacts=jnp.asarray(d["n_contacts"]))
    energy = jes.EnergyState(
        battery_j=jnp.asarray(d["battery"]),
        energy_spent_j=jnp.asarray(d["spent"]),
        passes_served=jnp.zeros((SP, SM), jnp.int32),
        passes_skipped=jnp.zeros((SP, SM), jnp.int32))
    return state, ex, energy, jring.ring_init(8, batch=(SP,))


def _port_side(d):
    sgd = resolve_optimizer("sgd")

    def plane(tree, p):
        return jax.tree.map(lambda a: torch.from_numpy(a[p].copy()), tree)
    states = []
    for p in range(SP):
        st = SLTrainState.create(*plane(d["params"], p), sgd)
        ma, mb = plane(d["momentum"], p)
        states.append(st.replace(opt_a=st.opt_a._replace(momentum=ma),
                                 opt_b=st.opt_b._replace(momentum=mb)))
    t = torch.from_numpy
    ex = ExchangeState(
        anchor=[plane(d["anchor"], p) for p in range(SP)],
        residual=[plane(d["residual"], p) for p in range(SP)],
        last_k=t(d["last_k"]), bits=t(d["bits"]), e_j=t(d["e_j"]),
        n_contacts=t(d["n_contacts"]))
    energy = EnergyState(
        battery_j=t(d["battery"].copy()), energy_spent_j=t(d["spent"].copy()),
        passes_served=torch.zeros((SP, SM), dtype=torch.int32),
        passes_skipped=torch.zeros((SP, SM), dtype=torch.int32))
    return states, ex, energy, [ring_init(8, device=CPU) for _ in range(SP)]


def _close(got_leaves, want_tree, p, exact=False):
    want = jax.tree.leaves(want_tree)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        w = np.asarray(w)[p]
        if exact:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,scheme,aggregate", [
    ("async", "none", "mean"), ("async", "int8", "mean"),
    ("async", "topk", "mean"), ("sync", "none", "mean"),
    ("sync", "int8", "median"), ("sync", "topk", "mean")])
def test_exchange_steps_match_reference(mode, scheme, aggregate):
    d = _step_inputs()
    kw = dict(mode=mode, mix=0.4, staleness_lam=0.2)
    got_cfg = ExchangeConfig(codec=CodecConfig(scheme, topk_ratio=0.2),
                             contact=ContactConfig(**STEP_CONTACT), **kw)
    want_cfg = jisl.ExchangeConfig(
        codec=jisl.CodecConfig(scheme, topk_ratio=0.2),
        contact=jisl.ContactConfig(**STEP_CONTACT), **kw)
    wire = delta_payload_bits(jax.tree.map(
        lambda a: torch.from_numpy(a[0]), d["params"]), got_cfg.codec)
    statics = dict(wire_bits=wire, e_push_j=50.0, battery_cap=200.0,
                   n_planes=SP, action_failed=ACTION_FAILED)
    jstate, jex, jenergy, jrings = _reference_side(d)
    states, ex, energy, rings = _port_side(d)
    sat, act = d["sat"], d["action"]
    k = SK_OPEN
    if mode == "async":
        jstate, jex, jenergy, jrings = jx.async_gossip_step(
            want_cfg, jstate, jex, jenergy, jrings, jnp.int32(k),
            jnp.asarray(sat), jnp.asarray(act), **statics)
        states, ex, energy, rings = async_gossip_step(
            got_cfg, states, ex, energy, rings, k, torch.from_numpy(sat),
            torch.from_numpy(act), **statics)
    else:
        jstate, jex, jenergy, jrings = jx.sync_exchange_step(
            want_cfg, aggregate, jstate, jex, jenergy, jrings, jnp.int32(k),
            jnp.asarray(sat), jnp.asarray(act), jnp.bool_(True), **statics)
        states, ex, energy, rings = sync_exchange_step(
            got_cfg, aggregate, states, ex, energy, rings, k,
            torch.from_numpy(sat), torch.from_numpy(act), True, **statics)

    for name in ("last_k", "bits", "e_j", "n_contacts"):
        np.testing.assert_array_equal(getattr(ex, name).numpy(),
                                      np.asarray(getattr(jex, name)), name)
    for name in ("battery_j", "energy_spent_j"):
        np.testing.assert_array_equal(getattr(energy, name).numpy(),
                                      np.asarray(getattr(jenergy, name)))
    assert energy.battery_j[2, 0] == 0.0 and energy.battery_j[1, 3] == \
        d["battery"][1, 3]                       # clamped; FAILED pays 0
    for p in range(SP):
        st = states[p]
        _close(_leaves((st.params_a, st.params_b)),
               (jstate.params_a, jstate.params_b), p)
        _close(_leaves((st.opt_a.momentum, st.opt_b.momentum)),
               (jstate.opt_a.momentum, jstate.opt_b.momentum), p)
        _close(_leaves(ex.anchor[p]), jex.anchor, p, exact=mode == "async")
        _close(_leaves(ex.residual[p]), jex.residual, p, exact=True)
        for f, w in zip(rings[p], jrings):
            np.testing.assert_array_equal(f.numpy(), np.asarray(w)[p])
    assert int(rings[0].cursor) == 1 and int(rings[0].kind[0]) == EV_EXCHANGE

    # a window that stays shut (async) or a boundary without an exchange
    # (sync): nothing moves, nothing is recorded
    before = [t.clone() for t in _leaves(states[0]._fields())]
    if mode == "async":
        out = async_gossip_step(got_cfg, states, ex, energy, rings, SK_SHUT,
                                torch.from_numpy(sat), torch.from_numpy(act),
                                **statics)
    else:
        out = sync_exchange_step(got_cfg, aggregate, states, ex, energy,
                                 rings, SK_SHUT, torch.from_numpy(sat),
                                 torch.from_numpy(act), False, **statics)
    assert out[1] is ex and out[2] is energy and out[3] is rings
    assert all(torch.equal(a, b) for a, b in
               zip(before, _leaves(states[0]._fields())))


# ----------------------- the oracles: reference's, port's, the fleet's

DEGRADED = ScenarioConfig(
    eclipse=EclipseConfig(period=4, duty=0.5, stagger=1),
    byzantine=ByzantineConfig(slots={0: [1]}, mode="sign_flip", scale=1.0),
    epidemic=EpidemicConfig(beta=0.6, ttl=2, init_slots=(0,), start=0))
ORACLE_CASES = {
    "async_int8": dict(avg_every=0, exchange=ExchangeConfig(
        mode="async", codec=CodecConfig("int8"),
        contact=ContactConfig(period=2, offsets=(1,)), mix=0.4,
        staleness_lam=0.2)),
    "async_topk": dict(avg_every=0, n_planes=3, exchange=ExchangeConfig(
        mode="async", codec=CodecConfig("topk", topk_ratio=0.01),
        contact=ContactConfig(period=3, phase=1, offsets=(1, 2)))),
    "sync_none": dict(avg_every=1, exchange=ExchangeConfig(mode="sync"),
                      **ENERGY),
    "degraded": dict(avg_every=0, scenario=DEGRADED, recharge_w=0.02,
                     battery_j=200.0, reserve_j=180.0,
                     exchange=ExchangeConfig(
                         mode="async", codec=CodecConfig("int8"),
                         contact=ContactConfig(period=4, offsets=(1,)),
                         mix=0.5, staleness_lam=0.1)),
    "chained": dict(avg_every=0, fail_prob=0.3, join_events={2: 1},
                    leave_events={5: 0}, **ENERGY,
                    exchange=ExchangeConfig(
                        mode="async", codec=CodecConfig("int8"),
                        contact=ContactConfig(period=2)))}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracles_match_reference_and_the_fleet(case):
    fleet = _fleet(**ORACLE_CASES[case])
    assert fleet._ex_on and fleet._ex_bits > 0
    ns = fleet_host_view(fleet)
    acts, slots = oracle_actions(fleet, return_slots=True)
    want_acts, want_slots = jscn.oracle_actions(ns, return_slots=True)
    np.testing.assert_array_equal(acts, want_acts)
    np.testing.assert_array_equal(slots, want_slots)
    expect = oracle_exchange(fleet)
    want = jx.oracle_exchange(ns)
    assert set(expect) == set(want)
    for col in want:
        np.testing.assert_array_equal(expect[col], want[col], col)
    if case == "chained":          # one revolution a run, the horizon two
        res = [fleet.run(1, stream_telemetry=True) for _ in range(2)]
        action = np.concatenate([r.action for r in res], axis=1)
        res = res[-1]
    else:
        res = fleet.run(stream_telemetry=True)
        action = res.action
    np.testing.assert_array_equal(action, acts)
    got = exchange_events(fleet.recorder)
    assert got["t"].size == expect["t"].size > 0
    for col in COLUMNS:
        np.testing.assert_array_equal(got[col], expect[col], col)
    assert int(res.isl_contacts.sum()) == expect["t"].size * fleet.n_planes
    np.testing.assert_array_equal(res.isl_bits, expect["bits"].sum(axis=0))
    assert res.isl_e_j.sum() > 0
    finite = res.loss[np.isfinite(res.loss)]
    assert finite.size and np.isfinite(finite).all()
    assert fleet.traces == 1 and fleet.host_syncs == 2
    assert fleet.recorder.dropped == 0
    if case == "degraded":
        assert (action == 4).any()                      # ACTION_FAULT
        assert (res.n_infected > 1).any()
    if case == "chained":
        assert (action == ACTION_FAILED).any()


# --------------------------------------------- the port's own behaviour

def test_sync_topk_full_ratio_tracks_the_free_average():
    """Top-k at ratio 1.0 keeps every entry, so the sync codec exchange is
    the free average up to the reconstruction's rounding (anchor +
    (params - anchor) against params)."""
    legacy = _fleet(n_revolutions=1, avg_every=1)
    res_l = legacy.run()
    f = _fleet(n_revolutions=1, avg_every=1, exchange=ExchangeConfig(
        mode="sync", codec=CodecConfig("topk", topk_ratio=1.0)))
    res_s = f.run()
    np.testing.assert_array_equal(res_l.action, res_s.action)
    for sl, ss in zip(res_l.state, res_s.state):
        for a, b in zip(_leaves((sl.params_a, sl.params_b)),
                        _leaves((ss.params_a, ss.params_b))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
    assert float(res_s.isl_bits.sum()) > res_l.summary()["ISL_exchange_bits"]
    assert res_l.summary()["ISL_exchange_bits"] == 0.0


def test_over_capacity_payload_never_transfers():
    """A payload larger than rate * window_s does not cross the link: the
    exchange is off (no free average either), and the oracle agrees."""
    fleet = _fleet(n_revolutions=1, avg_every=0, exchange=ExchangeConfig(
        mode="async", contact=ContactConfig(window_s=1e-6)))
    assert not fleet._ex_on and fleet._ex_bits > fleet._ex_cap_bits
    assert oracle_exchange(fleet)["t"].size == 0
    assert jx.oracle_exchange(fleet_host_view(fleet))["t"].size == 0
    res = fleet.run()
    ev = fleet.recorder.events()
    assert int((ev["kind"] == EV_EXCHANGE).sum()) == 0
    assert float(res.isl_bits.sum()) == 0.0
    assert (res.action == ACTION_TRAINED).any()


def test_plans_differ_across_codecs():
    """The charged ISL bits are a planner input: the codec changes the
    problem-(13) allocation, not only a counter."""
    plans = {}
    for codec in (CodecConfig("none"), CodecConfig("topk", topk_ratio=0.01)):
        f = _fleet(n_revolutions=1, avg_every=0, exchange=ExchangeConfig(
            mode="async", codec=codec, contact=ContactConfig()))
        plans[codec.scheme] = f._host_plan
    assert (plans["none"].d_isl_bits > plans["topk"].d_isl_bits).all()
    assert (plans["none"].e_isl_j > plans["topk"].e_isl_j).all()
    assert (plans["none"].t_total_s >= plans["topk"].t_total_s).all()
    base = _fleet(n_revolutions=1, avg_every=0)._host_plan
    assert (plans["topk"].d_isl_bits > base.d_isl_bits).all()


def test_contacts_continue_past_the_horizon():
    """Chained runs past the precomputed horizon keep exchanging on
    schedule: the contact model is arithmetic on the absolute pass
    index, not a table."""
    fleet = _fleet(n_revolutions=1, avg_every=0, exchange=ExchangeConfig(
        mode="async", codec=CodecConfig("topk", topk_ratio=0.01),
        contact=ContactConfig(period=2)))
    K = fleet.n_passes
    assert K == fleet.schedule.n_passes
    per_run = fleet.exchange.contact.contacts_in(K)
    res1 = fleet.run()
    assert int(res1.isl_contacts.sum()) == per_run * fleet.n_planes
    res2 = fleet.run()                  # passes [K, 2K): past the horizon
    assert int(res2.isl_contacts.sum()) == (
        per_run + fleet.exchange.contact.contacts_in(K, start=K)
    ) * fleet.n_planes
    assert fleet.traces == 1 and fleet.host_syncs == 2
    ev = fleet.recorder.events()
    t_ex = set(np.unique(ev["t"][ev["kind"] == EV_EXCHANGE]).tolist())
    beyond = {k for k in range(K, 2 * K)
              if fleet.exchange.contact.open_at(k)}
    assert beyond and beyond <= t_ex
    finite = res2.loss[np.isfinite(res2.loss)]
    assert finite.size and np.isfinite(finite).all()


@pytest.mark.parametrize("smoke", ["isl", "degraded", "device_sim"])
def test_smokes_on_cpu(smoke, monkeypatch):
    """``python -m repro_torch.isl``, ``python -m repro_torch.fleet
    --scenario degraded`` (4 satellites) and ``python -m
    repro_torch.sim.device_sim --smoke``, each with ``--device cpu``."""
    if smoke == "isl":
        out = isl_main.main(["--device", CPU])
        assert out["contacts"] > 0
        assert out["sync"]["ISL_exchange_bits"] > \
            out["async"]["ISL_exchange_bits"] > 0
    elif smoke == "degraded":
        monkeypatch.setenv("REPRO_FLEET_SMOKE_SATS", "4")
        s = fleet_main.main(["--scenario", "degraded", "--device", CPU])
        assert s["faulted"] > 0 and s["skipped"] > 0 and s["trained"] > 0
    else:
        out = device_sim._smoke(["--smoke", "--device", CPU])
        assert out["host"]["skipped"] == out["device"]["skipped"] > 0
