"""The port's serving fleet (``repro_torch.serve_fleet``) against the
reference's (``repro.serve_fleet``) on the CPU.

The reference's ``tests/test_serve_fleet.py`` cases one for one on the
port (traffic, routing, FIFO latency, split decode, host parity, the
battery clamp, the reserve gate, contention, chained runs, metrics),
then parity with the reference itself: the intensity (bit for bit in
99% of windows, else within 2 ulp of the peak intensity); the
NumPy and torch router bodies bit for bit; ``apply_serve`` on ``(P, M)``
against the reference's vmapped one; the port's engine, fed the
reference's realized arrivals (the two draw from different random
streams), against the reference's ``FleetServeEngine.run`` (routing and
counts exact, joules at rtol 1e-5 / atol 1e-6); the port's
``host_oracle`` against the reference's bit for bit; the ``EV_SERVE``
tables; and the Granite smoke split engine's greedy tokens from the
reference's weights in f32. The eager loops run with one torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, one_torch_thread
from repro import configs as jconfigs
from repro.fleet import scenarios as jscn
from repro.models import lm as jlm
from repro.serve.engine import Request as JRequest
from repro.serve_fleet import engine as jengine
from repro.serve_fleet import router as jrouter
from repro.serve_fleet import traffic as jtraffic
from repro.sim import energy_state as jes
from repro_torch import configs
from repro_torch.fleet.scenarios import EclipseConfig
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params
from repro_torch.obs.ring import EV_SERVE
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve_fleet import router
from repro_torch.serve_fleet.engine import (FleetServeEngine, ServeCost,
                                            ServeFleetConfig,
                                            SplitDecodeEngine, TrainLoad,
                                            assert_host_parity,
                                            clamp_battery_f32, host_oracle)
from repro_torch.serve_fleet.traffic import PassWindowTraffic, TrafficConfig
from repro_torch.sim import energy_state as es
from repro_torch.utils.treeutil import tree_leaves

CPU = "cpu"
BASE = dict(battery_j=60.0, recharge_w=0.02, reserve_serve_j=5.0,
            reserve_train_j=30.0, window_s=90.0)
COST = dict(tokens_per_s=50.0, e_token_j=0.02, dtx_bits_token=2048.0)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _kw(users=60_000.0, *, train=None, eclipse=None, P=2, M=8, K=24,
        cost=None, seed=2, **cfg_kw):
    """The reference test's ``_fleet`` arguments, as plain data."""
    return dict(users=users, train=train, eclipse=eclipse, P=P, M=M, K=K,
                cost=cost or COST, seed=seed, cfg={**BASE, **cfg_kw})


def _port_fleet(kw):
    ecl = None if kw["eclipse"] is None else EclipseConfig(**kw["eclipse"])
    train = None if kw["train"] is None else TrainLoad(**kw["train"])
    scfg = ServeFleetConfig(n_planes=kw["P"], n_sats=kw["M"],
                            n_windows=kw["K"], eclipse=ecl, **kw["cfg"])
    traffic = TrafficConfig(users_per_day=kw["users"], decode_len=4,
                            seed=kw["seed"])
    return FleetServeEngine(scfg, traffic, ServeCost(**kw["cost"]),
                            train=train, device=CPU), train


def _ref_fleet(kw):
    ecl = (None if kw["eclipse"] is None
           else jscn.EclipseConfig(**kw["eclipse"]))
    train = (None if kw["train"] is None
             else jengine.TrainLoad(**kw["train"]))
    scfg = jengine.ServeFleetConfig(n_planes=kw["P"], n_sats=kw["M"],
                                    n_windows=kw["K"], eclipse=ecl,
                                    **kw["cfg"])
    traffic = jtraffic.TrafficConfig(users_per_day=kw["users"],
                                     decode_len=4, seed=kw["seed"])
    return jengine.FleetServeEngine(scfg, traffic,
                                    jengine.ServeCost(**kw["cost"]),
                                    train=train), train


def _fleet(users=60_000.0, **kw):
    """The reference test's fleet, on the port."""
    return _port_fleet(_kw(users, **kw))


class InjectedTraffic:
    """The port's traffic with the reference's realized arrivals: the
    engine and the oracle read ``realize`` only, so both consume the
    reference's draws (NumPy cannot reproduce ``jax.random``)."""

    def __init__(self, port_traffic, ref_traffic):
        self._port, self._ref = port_traffic, ref_traffic

    def __getattr__(self, name):
        return getattr(self._port, name)

    def realize(self, n_windows, start=0):
        return np.asarray(self._ref.realize(n_windows, start=start))


def _both(kw):
    """(port engine fed the reference's arrivals, port train, reference
    engine, reference train)."""
    eng, train = _port_fleet(kw)
    jeng, jtrain = _ref_fleet(kw)
    eng.traffic = InjectedTraffic(eng.traffic, jeng.traffic)
    return eng, train, jeng, jtrain


# --------------------------------------------------------------------------
# Traffic.
# --------------------------------------------------------------------------

def test_traffic_host_twin_matches_elementwise():
    tw = PassWindowTraffic(TrafficConfig(users_per_day=50_000.0, seed=3),
                           window_s=120.0, n_planes=2)
    grid = tw.realize(6)
    assert grid.shape == (2, 6) and grid.dtype == np.int32
    for p in range(2):
        for k in range(6):
            assert int(tw(p, k)) == grid[p, k]      # same pure function
    # a window offset continues the stream
    np.testing.assert_array_equal(tw.realize(3, start=3), grid[:, 3:])


def test_traffic_diurnal_profile_and_seeding():
    cfg = TrafficConfig(users_per_day=200_000.0, diurnal_amp=0.5,
                        peak_utc_s=0.0, seed=0)
    tw = PassWindowTraffic(cfg, window_s=600.0, n_planes=1)
    peak = float(tw.rate(0))                        # near t=0 (the peak)
    trough = float(tw.rate(43_200 // 600))          # half a day later
    assert peak > 1.8 * trough
    again = PassWindowTraffic(cfg, window_s=600.0, n_planes=1)
    other = PassWindowTraffic(dataclasses.replace(cfg, seed=9),
                              window_s=600.0, n_planes=1)
    assert np.array_equal(tw.realize(8), again.realize(8))
    assert not np.array_equal(tw.realize(8), other.realize(8))


def test_traffic_scales_to_millions():
    tw = PassWindowTraffic(TrafficConfig(users_per_day=2.0e6),
                           window_s=228.0, n_planes=1)
    arr = tw.realize(4)[0]
    assert (arr > 2000).all()               # thousands of requests/window


def test_traffic_config_and_prompts():
    with pytest.raises(ValueError, match="diurnal_amp"):
        TrafficConfig(diurnal_amp=1.5)
    cfg = TrafficConfig(users_per_day=86_400.0, requests_per_user_day=2.0,
                        prompt_len=5)
    assert cfg.mean_rate_per_s(4) == 0.5 and cfg.tokens_per_request == 16.0
    tw = PassWindowTraffic(cfg, window_s=90.0, n_planes=2)
    a = tw.prompts(1, 7, 6, 128)
    assert a.shape == (6, 5) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() < 128
    np.testing.assert_array_equal(a, tw.prompts(1, 7, 6, 128))
    assert not np.array_equal(a, tw.prompts(0, 7, 6, 128))
    assert not np.array_equal(a, tw.prompts(1, 8, 6, 128))


@pytest.mark.parametrize("over", [
    dict(), dict(users_per_day=2.0e6, seed=4),
    dict(users_per_day=25_000.0, peak_utc_s=0.0, diurnal_amp=1.0)])
@pytest.mark.parametrize("window_s,n_planes", [(90.0, 1), (228.0, 4),
                                               (600.0, 2)])
def test_rate_matches_reference(over, window_s, n_planes):
    """The intensity bit for bit in most windows, and elsewhere within 2
    ulp of the day's peak intensity: where XLA's f32 cosine and the
    port's differ by 1 ulp, the sum and the product round once more."""
    ks = np.arange(0, 5000)
    tw = PassWindowTraffic(TrafficConfig(**over), window_s, n_planes)
    got = tw.rate(ks)
    want = np.asarray(jtraffic.PassWindowTraffic(
        jtraffic.TrafficConfig(**over), window_s, n_planes).rate(ks))
    assert got.dtype == np.float32
    peak = np.float32(tw.cfg.mean_rate_per_s(n_planes) * window_s
                      * (1.0 + tw.cfg.diurnal_amp))
    assert np.abs(got - want).max() <= 2 * np.spacing(peak)
    assert (got == want).mean() > 0.99


# --------------------------------------------------------------------------
# Router.
# --------------------------------------------------------------------------

def test_serving_slot_ring_rotation_numpy_vs_torch():
    member = np.array([True, False, True, True, False])
    alive = [0, 2, 3]
    for k in range(7):
        want = alive[k % 3]
        assert int(router.serving_slot(member, k)) == want
        assert int(router.serving_slot_torch(torch.from_numpy(member),
                                             k)) == want
        assert int(jrouter.serving_slot(member, k, xp=np)) == want
    empty = np.zeros((4,), bool)
    assert int(router.serving_slot(empty, 5)) == -1
    assert int(router.serving_slot_torch(torch.from_numpy(empty), 5)) == -1


def test_router_bodies_bitwise():
    """The torch bodies give the NumPy bodies' (and the reference's)
    values bit for bit, plane-batched."""
    rng = np.random.default_rng(3)
    members = rng.random((64, 9)) < 0.6
    members[:4] = False                    # nobody alive
    for k in (0, 1, 5, 17, 1000):
        got = router.serving_slot_torch(torch.from_numpy(members), k)
        want = [int(router.serving_slot(m, k)) for m in members]
        assert got.dtype == torch.int32 and got.tolist() == want
        assert want == [int(jrouter.serving_slot(m, k, xp=np))
                        for m in members]
    f32 = np.float32
    backlog = (rng.random(256) * 300).astype(f32)
    arrivals = rng.integers(0, 200, 256).astype(f32)
    ok = rng.random(256) < 0.7
    for cap in (f32(0.0), f32(37.0), f32(1125.0), f32(3.5e6)):
        s_t, b_t = router.drain_queue_torch(
            torch.from_numpy(backlog), torch.from_numpy(arrivals),
            float(cap), torch.from_numpy(ok))
        for i in range(256):
            s, b = router.drain_queue(backlog[i], arrivals[i], cap, ok[i])
            js, jb = jrouter.drain_queue(backlog[i], arrivals[i], cap, ok[i],
                                         xp=np)
            assert s_t[i].item() == s == js and b_t[i].item() == b == jb


def test_drain_queue_carry_over():
    f32 = np.float32
    served, backlog = router.drain_queue(f32(3.0), f32(5.0), f32(6.0), True)
    assert served == 6.0 and backlog == 2.0          # capacity-capped
    served, backlog = router.drain_queue(f32(2.0), f32(1.0), f32(6.0), False)
    assert served == 0.0 and backlog == 3.0          # gated: all carries


def test_fifo_latency_windows_hand_example():
    # w0: 2 arrive, 1 served; w1: 0 arrive, 1 served; w2: 1 arrive, 1 served
    waits = router.fifo_latency_windows([2, 0, 1], [1, 1, 1])
    assert waits.tolist() == [0, 1, 0]
    assert router.fifo_latency_windows([3, 0], [0, 0]).size == 0
    assert np.isnan(router.latency_quantile_s([3, 0], [0, 0], 90.0))


def test_latency_functions_match_reference():
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 60, 40)
    srv = np.minimum(np.cumsum(arr), np.cumsum(np.full(40, 25)))
    srv = np.diff(np.concatenate([[0], srv]))
    np.testing.assert_array_equal(router.fifo_latency_windows(arr, srv),
                                  jrouter.fifo_latency_windows(arr, srv))
    for q in (0.5, 0.99):
        assert router.latency_quantile_s(arr, srv, 90.0, 0.25, q) == \
            jrouter.latency_quantile_s(arr, srv, 90.0, 0.25, q)


# --------------------------------------------------------------------------
# Split-decode engine.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    jcfg = jconfigs.get_smoke("granite_3_2b")
    jparams = jlm.init(jcfg, jax.random.key(0))
    return (jcfg, jparams, configs.get_smoke("granite_3_2b"),
            from_jax_params(jax_tree_to_numpy(jparams)))


def test_split_decode_engine_matches_full_engine(granite):
    _, _, cfg, params = granite
    rng2 = np.random.default_rng(1)
    prompts = [rng2.integers(0, cfg.vocab, 5).astype(np.int32)
               for _ in range(3)]
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=5)  # noqa: E731
                    for i, p in enumerate(prompts)]
    kw = dict(n_slots=2, s_max=32, act_dtype=torch.float32, device=CPU)
    full = DecodeEngine(cfg, params, **kw).submit_and_run(reqs())
    eng = SplitDecodeEngine(cfg, params, cut_units=1, **kw)
    assert eng.submit_and_run(reqs()) == full
    assert eng.boundary_bits_per_token == cfg.d_model * 32


def test_split_decode_step_boundary_and_parity(granite):
    _, _, cfg, params = granite
    ctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.float32)
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    ref_cache = lm.init_cache(cfg, 2, 16, torch.float32, CPU)
    got_cache = lm.init_cache(cfg, 2, 16, torch.float32, CPU)
    ref, _ = lm.decode_step(cfg, params, ref_cache, toks, pos, ctx=ctx)
    pa, pb = lm.split_serve_params(cfg, params, 1)
    got, _, z = lm.decode_step_split(cfg, pa, pb, got_cache, toks, pos,
                                     ctx=ctx)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert tuple(z.shape) == (2, 1, cfg.d_model)
    for a, b in zip(tree_leaves(ref_cache), tree_leaves(got_cache)):
        assert torch.equal(a, b)


def test_granite_split_engine_gives_reference_tokens(granite):
    """The smoke's first step on the reference's weights in f32: the
    port's split engine generates the reference split engine's greedy
    tokens."""
    jcfg, jparams, cfg, params = granite
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 5).astype(np.int32)
               for _ in range(4)]
    got = SplitDecodeEngine(cfg, params, cut_units=1, n_slots=2, s_max=48,
                            act_dtype=torch.float32, device=CPU) \
        .submit_and_run([Request(rid=i, prompt=p, max_new_tokens=5)
                         for i, p in enumerate(prompts)])
    want = jengine.SplitDecodeEngine(jcfg, jparams, cut_units=1, n_slots=2,
                                     s_max=48, act_dtype=jnp.float32) \
        .submit_and_run([JRequest(rid=i, prompt=p, max_new_tokens=5)
                         for i, p in enumerate(prompts)])
    assert got == want and all(len(v) == 5 for v in got.values())


# --------------------------------------------------------------------------
# Fleet loop vs NumPy oracle.
# --------------------------------------------------------------------------

def test_fleet_scan_host_parity_and_conservation():
    fleet, train = _fleet(train=dict(drain_j=8.0, e_total_j=12.0),
                          eclipse=dict(period=6, duty=0.5))
    res = fleet.run()
    assert_host_parity(res, train)          # exact routing + f32 energy
    assert fleet.traces == 1 and fleet.host_syncs == 1
    assert fleet.device_calls == 1 and fleet.k == 24
    # every arrival is either served or still queued (per plane)
    arrived = res.arrivals.sum(axis=1)
    accounted = res.served.sum(axis=1) + res.backlog[:, -1]
    np.testing.assert_allclose(accounted, arrived, rtol=1e-6)


def test_battery_clamped_to_capacity_range():
    # huge serving drain: batteries must pin at 0, never below, and the
    # recharge clamp must never push past capacity
    cost = dict(tokens_per_s=1e4, e_token_j=5.0, dtx_bits_token=2048.0)
    fleet, _ = _fleet(users=500_000.0, cost=cost, battery_j=40.0,
                      recharge_w=2.0, reserve_serve_j=0.0)
    res = fleet.run()
    assert_host_parity(res, None)
    b = np.asarray(res.energy.battery_j)
    assert res.battery_j.min() >= 0.0 and b.min() >= 0.0
    assert res.battery_j.max() <= 40.0 and b.max() <= 40.0


def test_clamp_battery_f32():
    f32 = np.float32
    assert clamp_battery_f32(f32(-3.0), f32(40.0)) == 0.0
    assert clamp_battery_f32(f32(41.5), f32(40.0)) == 40.0
    assert clamp_battery_f32(f32(12.25), f32(40.0)) == f32(12.25)
    assert clamp_battery_f32(f32(12.25), f32(40.0)).dtype == np.float32


def test_reserve_gate_stops_serving_when_depleted():
    # no recharge at all (permanent eclipse): serving drains the ring to
    # the reserve, after which windows serve nothing and backlog grows
    cost = dict(tokens_per_s=1e4, e_token_j=1.0, dtx_bits_token=2048.0)
    fleet, _ = _fleet(users=500_000.0, cost=cost, P=1, M=2, K=30,
                      battery_j=100.0, reserve_serve_j=50.0,
                      eclipse=dict(period=4, duty=1.0))
    res = fleet.run()
    assert_host_parity(res, None)
    assert res.served[0, -1] == 0.0                  # starved
    assert res.backlog[0, -1] > 0.0
    assert (np.asarray(res.energy.battery_j) >= 0.0).all()


def test_train_vs_serve_contention():
    """Concurrent serving drain must flip trained passes into
    reserve-skips relative to the idle-constellation baseline."""
    cost = dict(tokens_per_s=2000.0, e_token_j=0.5, dtx_bits_token=2048.0)
    kw = dict(cost=cost, train=dict(drain_j=25.0, e_total_j=40.0), P=1, M=4,
              K=40, battery_j=100.0, recharge_w=0.08, reserve_serve_j=0.0,
              reserve_train_j=60.0)
    busy, train = _fleet(users=40_000.0, **kw)
    idle, _ = _fleet(users=0.0, **kw)
    res_busy, res_idle = busy.run(), idle.run()
    assert_host_parity(res_busy, train)
    trained_busy = int(np.asarray(res_busy.energy.passes_served).sum())
    trained_idle = int(np.asarray(res_idle.energy.passes_served).sum())
    skipped_busy = int(np.asarray(res_busy.energy.passes_skipped).sum())
    assert trained_idle == 40                       # idle: trains always
    assert trained_busy < trained_idle
    assert skipped_busy == 40 - trained_busy


def test_chained_runs_continue_the_stream():
    """Two chained runs reproduce one long run exactly: the arrivals are
    drawn at the absolute window index and the state carries over."""
    kw = dict(train=dict(drain_j=8.0, e_total_j=12.0), P=1, M=4, K=12)
    one, _ = _fleet(**kw)
    r_full = one.run(24)
    two, _ = _fleet(**kw)
    r_a, r_b = two.run(12), two.run(12)
    for f in ("arrivals", "served", "backlog", "tokens", "slot", "trained",
              "battery_j"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(r_a, f), getattr(r_b, f)], axis=1),
            getattr(r_full, f))
    np.testing.assert_array_equal(two.energy.battery_j.numpy(),
                                  one.energy.battery_j.numpy())
    assert two.k == one.k == 24
    assert two.traces == 1 and two.host_syncs == 2
    t = two.recorder.events()["t"]
    np.testing.assert_array_equal(t, np.arange(24))


def test_result_latency_and_throughput_metrics():
    fleet, _ = _fleet(users=400_000.0, cost=dict(
        tokens_per_s=2.0, e_token_j=1e-4, dtx_bits_token=2048.0))
    res = fleet.run()
    s = res.summary()
    # capacity 2 tok/s * 90 s / 4 tok = 45 req/window vs >=100 offered
    # per plane even at the diurnal trough: overload -> backlog ->
    # positive queueing delay in the p99
    assert s["final_backlog_requests"] > 0
    assert s["p99_latency_s"] > res.window_s
    assert 0.0 < s["sustained_tokens_per_s"] <= 2.0 * fleet.cfg.n_planes
    assert res.request_service_s() == 2.0
    o = host_oracle(res.cfg, res.traffic, res.cost, None,
                    res.arrivals.shape[1], arrivals=res.arrivals)
    np.testing.assert_array_equal(res.served, o["served"])


def test_engine_refuses_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FleetServeEngine(ServeFleetConfig(), TrafficConfig(),
                         ServeCost(**COST))
    fleet, _ = _fleet()
    with pytest.raises(ValueError, match="window"):
        fleet.run(0)


# --------------------------------------------------------------------------
# Parity with the reference.
# --------------------------------------------------------------------------

def test_apply_serve_plane_batched_matches_reference():
    rng = np.random.default_rng(2)
    P, M = 3, 5
    bat = (rng.random((P, M)) * 60).astype(np.float32)
    spent = (rng.random((P, M)) * 9).astype(np.float32)
    ctr = rng.integers(0, 4, (P, M)).astype(np.int32)
    slot = np.array([4, 0, 2], np.int32)
    drain = np.array([70.5, 0.0, 12.125], np.float32)
    st = es.apply_serve(es.EnergyState(*[torch.from_numpy(a) for a in
                                         (bat, spent, ctr, ctr)]),
                        torch.from_numpy(slot), torch.from_numpy(drain),
                        60.0)
    jst = jax.vmap(jes.apply_serve, in_axes=(0, 0, 0, None))(
        jes.EnergyState(*[jnp.asarray(a) for a in (bat, spent, ctr, ctr)]),
        jnp.asarray(slot), jnp.asarray(drain), 60.0)
    for got, want in zip(st, jst):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the flat form still takes a ring and a scalar slot
    flat = es.apply_serve(es.init_energy_state(M, 60.0, CPU), 3, 12.5, 60.0)
    assert flat.battery_j.tolist() == [60.0, 60.0, 60.0, 47.5, 60.0]


PARITY = {
    "smoke": _kw(train=dict(drain_j=8.0, e_total_j=12.0),
                 eclipse=dict(period=6, duty=0.5)),
    "clamp": _kw(users=500_000.0, cost=dict(
        tokens_per_s=1e4, e_token_j=5.0, dtx_bits_token=2048.0),
        battery_j=40.0, recharge_w=2.0, reserve_serve_j=0.0),
    "starved": _kw(users=500_000.0, cost=dict(
        tokens_per_s=1e4, e_token_j=1.0, dtx_bits_token=2048.0),
        P=1, M=2, K=30, battery_j=100.0, reserve_serve_j=50.0,
        eclipse=dict(period=4, duty=1.0)),
    "contention": _kw(users=40_000.0, cost=dict(
        tokens_per_s=2000.0, e_token_j=0.5, dtx_bits_token=2048.0),
        train=dict(drain_j=25.0, e_total_j=40.0), P=3, M=4, K=40,
        battery_j=100.0, recharge_w=0.08, reserve_serve_j=0.0,
        reserve_train_j=60.0, eclipse=dict(period=5, duty=0.4, stagger=2)),
}
EXACT = ("arrivals", "served", "tokens", "backlog", "slot", "trained")


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's runs of PARITY, computed once per module: its
    result, recorder events and oracle on the same arrivals."""
    out = {}
    for name, kw in PARITY.items():
        jeng, jtrain = _ref_fleet(kw)
        res = jeng.run()
        out[name] = (res, jeng.recorder.events(), jengine.host_oracle(
            res.cfg, res.traffic, res.cost, jtrain, kw["K"],
            arrivals=res.arrivals))
    return out


@pytest.mark.parametrize("name", list(PARITY))
def test_fleet_matches_reference_engine(name, ref_runs):
    kw = PARITY[name]
    eng, train = _port_fleet(kw)
    jres = ref_runs[name][0]
    eng.traffic = InjectedTraffic(eng.traffic, jres.traffic)
    res = eng.run()
    for f in EXACT:
        np.testing.assert_array_equal(getattr(res, f),
                                      np.asarray(getattr(jres, f)), f)
    for f in ("passes_served", "passes_skipped"):
        np.testing.assert_array_equal(getattr(res.energy, f),
                                      np.asarray(getattr(jres.energy, f)))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.battery_j, np.asarray(jres.battery_j),
                               **tol)
    for f in ("battery_j", "energy_spent_j"):
        np.testing.assert_allclose(getattr(res.energy, f),
                                   np.asarray(getattr(jres.energy, f)),
                                   **tol)
    assert_host_parity(res, train)
    s, js = res.summary(), jres.summary()
    for k in ("arrived_requests", "served_requests", "final_backlog_requests",
              "trained_passes", "skipped_passes", "p99_latency_s"):
        assert s[k] == js[k] or (np.isnan(s[k]) and np.isnan(js[k])), k
    assert s["sustained_tokens_per_s"] == pytest.approx(
        js["sustained_tokens_per_s"], rel=1e-6)


@pytest.mark.parametrize("name", list(PARITY))
def test_host_oracle_matches_reference_bitwise(name, ref_runs):
    kw = PARITY[name]
    jres, _, want = ref_runs[name]
    eng, train = _port_fleet(kw)
    got = host_oracle(eng.cfg, eng.traffic, eng.cost, train, kw["K"],
                      arrivals=np.asarray(jres.arrivals))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("name", ["smoke", "contention"])
def test_serve_events_match_reference_recorder(name, ref_runs):
    kw = PARITY[name]
    jres, jev, _ = ref_runs[name]
    eng, _ = _port_fleet(kw)
    eng.traffic = InjectedTraffic(eng.traffic, jres.traffic)
    eng.run()
    ev = eng.recorder.events()
    assert (ev["kind"] == EV_SERVE).sum() == kw["P"] * kw["K"]
    assert eng.recorder.dropped == 0
    for f in ("kind", "t", "slot", "plane"):
        np.testing.assert_array_equal(ev[f], jev[f], f)
    np.testing.assert_allclose(ev["payload"], jev["payload"], rtol=1e-5,
                               atol=1e-6)


def test_chained_runs_match_reference():
    kw = _kw(train=dict(drain_j=8.0, e_total_j=12.0), P=2, M=4, K=12,
             eclipse=dict(period=5, duty=0.4, stagger=1))
    eng, _, jeng, _ = _both(kw)
    for _ in range(2):
        res, jres = eng.run(), jeng.run()
        for f in EXACT:
            np.testing.assert_array_equal(getattr(res, f),
                                          np.asarray(getattr(jres, f)), f)
        np.testing.assert_allclose(res.battery_j, np.asarray(jres.battery_j),
                                   rtol=1e-5, atol=1e-6)
    assert eng.k == jeng.k == 24


def test_serve_fleet_smoke_runs_on_cpu():
    """``python -m repro_torch.serve_fleet --device cpu``: split == full
    greedy tokens, the pass-window traffic served by the split engine,
    and the 2 x 8 fleet held to the oracle with one host sync."""
    from repro_torch.serve_fleet import __main__ as serve_fleet_main

    s = serve_fleet_main.main(["--device", CPU])
    assert s["n_planes"] == 2 and s["n_sats"] == 8 and s["n_windows"] == 24
    assert s["arrived_requests"] > 0 and s["trained_passes"] > 0
