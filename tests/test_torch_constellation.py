"""The port's host constellation ring and its problem-(13) solver
against the JAX reference's NumPy code paths: solver reports at rtol
1e-12, a 4-satellite autoencoder ring over 8 passes (a join, a leave,
random failures restored from the handoff checkpoint, a reserve skip)
with equal actions and satellite ids, energies and batteries within
rtol 1e-9 and losses within rtol 1e-3, and the handoff checkpoint's
round trip and integrity check."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, one_torch_thread
from repro.core import constellation as jcon
from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import resource_opt as jro
from repro.core import sl_step as jsl
from repro.core import splitting as jsplit
from repro_torch import ckpt
from repro_torch.core import constellation, energy, orbits, resource_opt
from repro_torch.core import sl_step, splitting
from repro_torch.core.train_state import SLTrainState
from repro_torch.data.synthetic import ImageryShards
from repro_torch.models.param import from_jax_params, map_tree
from repro_torch.utils.treeutil import (tree_bytes, tree_flatten_with_names,
                                        tree_leaves)

RTOL_SOLVER = 1e-12


def _cases(E, S, P):
    """The same (budget, costs) instances built from both packages: every
    cut of both paper models (incl. the int8 boundary) at several item
    counts and ring sizes, some of them infeasible."""
    budgets, costs = [], []
    plans = [S.resnet18_plan(img=224), S.autoencoder_plan(img=224),
             S.resnet18_plan(img=224).with_boundary_compression(0.25)]
    for n_sats in (4, 25):
        for n_items in (8.0, 400.0, 40_000.0):
            b = E.PassBudget(plane=P.OrbitalPlane(n_sats=n_sats),
                             n_items=n_items)
            for plan in plans:
                for c in plan.enumerate_cuts():
                    budgets.append(b)
                    costs.append(c)
    return budgets, costs


def _assert_reports_equal(got, want):
    for f in ("phase_times", "phase_energy", "lam", "kkt_residual", "e_isl",
              "t_fixed", "e_total", "t_total"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL_SOLVER, err_msg=f)
    np.testing.assert_array_equal(got.feasible, want.feasible)


def test_solver_matches_reference_numpy_backend():
    jb, jc = _cases(jenergy, jsplit, jorbits)
    tb, tc = _cases(energy, splitting, orbits)
    assert len(tb) > 100
    _assert_reports_equal(resource_opt.solve_batch(tb, tc),
                          jro.solve_batch(jb, jc, backend="numpy"))
    got = resource_opt.solve_with_shedding_batch(tb, tc)
    want = jro.solve_with_shedding_batch(jb, jc, backend="numpy")
    np.testing.assert_allclose(got.kept_fraction, want.kept_fraction,
                               rtol=RTOL_SOLVER)
    np.testing.assert_allclose(got.n_items_kept, want.n_items_kept,
                               rtol=RTOL_SOLVER)
    assert 0 < (got.kept_fraction < 1).sum() < len(tb)
    _assert_reports_equal(got.report, want.report)
    # the scalar solve and the cut search on one budget
    s, sw = resource_opt.solve(tb[7], tc[7]), jro.solve(jb[7], jc[7])
    np.testing.assert_allclose(s.allocation.e_total, sw.allocation.e_total,
                               rtol=RTOL_SOLVER)
    cut, rep = resource_opt.best_split_batch(tb[0], tc[:8], backend="numpy")
    jcut, jrep = jro.best_split_batch(jb[0], jc[:8], backend="numpy")
    assert cut.name == jcut.name
    np.testing.assert_allclose(rep.allocation.e_total,
                               jrep.allocation.e_total, rtol=RTOL_SOLVER)


def test_solver_backends():
    b, c = energy.PassBudget(), splitting.resnet18_plan().costs_at(5)
    want = resource_opt.solve_batch(b, c, backend="numpy")
    for ok in (None, "auto", "numpy"):
        resource_opt.solve_batch(b, c, backend=ok)
    # the device solver, on the CPU when asked for
    got = resource_opt.solve_batch(b, c, backend="torch", device="cpu")
    np.testing.assert_allclose(got.e_total, want.e_total, rtol=1e-8)
    shed = resource_opt.solve_with_shedding_batch(b, c, backend="torch",
                                                  device="cpu")
    assert shed.kept_fraction[0] == 1.0
    # "jax" is the reference's name: the message names the port's
    with pytest.raises(ValueError, match="backend='torch'"):
        resource_opt.solve_batch(b, c, backend="jax")
    with pytest.raises(ValueError, match="backend='torch'"):
        resource_opt.solve_with_shedding_batch(b, c, backend="jax")
    with pytest.raises(ValueError, match="unknown"):
        resource_opt.solve_batch(b, c, backend="tpu")


def test_table1_geometry_and_battery_clamp():
    assert orbits.PAPER_PLANE.summary() == jorbits.PAPER_PLANE.summary()
    assert energy.clamp_battery(-3.0, 10.0) == 0.0
    assert energy.clamp_battery(12, 10.0) == 10.0
    np.testing.assert_array_equal(
        energy.clamp_battery(torch.tensor([-1.0, 5.0, 11.0]), 10.0).numpy(),
        np.asarray(jenergy.clamp_battery(jnp.array([-1.0, 5.0, 11.0]), 10.0)))


RING = dict(n_passes=8, quantize_boundary=True,
            fail_prob=0.25, battery_j=1000.0, recharge_w=0.01,
            reserve_j=100.0, join_battery_frac=0.05, seed=1,
            join_events={1: 1}, leave_events={4: 3})


def test_four_satellite_ring_matches_reference(tmp_path):
    shards = ImageryShards(img=32, batch=2, n_shards=8)
    jsim = jcon.ConstellationSim(
        jsl.autoencoder_adapter(img=32),
        jenergy.PassBudget(plane=jorbits.OrbitalPlane(n_sats=4), n_items=8),
        lambda s, i: jax.tree.map(jnp.asarray, shards.batch_at(s, i)),
        jcon.ConstellationConfig(handoff_dir=str(tmp_path / "ref"), **RING))
    init = [jax_tree_to_numpy(p) for p in (jsim.state.params_a,
                                           jsim.state.params_b)]
    want = jsim.run()

    sim = constellation.ConstellationSim(
        sl_step.autoencoder_adapter(img=32),
        energy.PassBudget(plane=orbits.OrbitalPlane(n_sats=4), n_items=8),
        shards.batch_at,
        constellation.ConstellationConfig(handoff_dir=str(tmp_path / "port"),
                                          **RING),
        device="cpu")
    sim.state = SLTrainState.create(*map(from_jax_params, init),
                                    sim.optimizer)
    got = sim.run()

    actions = [r.action for r in want]
    assert {"trained", "failed", "skipped_energy"} <= set(actions)
    assert [r.action for r in got] == actions
    assert [r.sat_id for r in got] == [r.sat_id for r in want]
    for g, w in zip(got, want):
        for f in ("e_total_j", "e_proc_j", "e_comm_j", "e_isl_j",
                  "t_total_s", "d_isl_bits", "n_items", "kept_fraction",
                  "battery_j"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-9, err_msg=f"{f} {g}")
        if w.loss is None:
            assert g.loss is None
        else:
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-3)
    assert [s.alive for s in sim.sats] == [s.alive for s in jsim.sats]
    assert (sim.planner.solve_calls, sim.planner.invalidations) == \
        (jsim.planner.solve_calls, jsim.planner.invalidations)
    assert set(sim.summary()) == set(jsim.summary())
    assert sim.summary()["trained"] == jsim.summary()["trained"]


def test_device_engine_is_not_ported_and_cpu_must_be_asked(monkeypatch):
    """The single-ring device engine takes static rings; an elastic ring
    (failures, joins, leaves) goes to the fleet engine as a one-plane
    fleet, as in the reference; entry points refuse the CPU unless asked.
    """
    from repro_torch.fleet import FleetEngine
    from repro_torch.sim.data import DeviceImageryShards

    adapter = sl_step.autoencoder_adapter(img=32)
    shards = ImageryShards(img=32, batch=2)
    dshards = DeviceImageryShards(img=32, batch=2, device="cpu")
    for kw in (dict(fail_prob=0.1), dict(join_events={1: 1}),
               dict(leave_events={1: 0})):
        sim = constellation.ConstellationSim(
            adapter, energy.PassBudget(plane=orbits.OrbitalPlane(n_sats=4),
                                       n_items=4), dshards,
            constellation.ConstellationConfig(n_passes=3, **kw),
            device="cpu")
        with pytest.raises(ValueError, match="static steady-state"):
            sim.as_device_sim()
        with one_torch_thread():
            recs = sim.run(engine="device")
        assert isinstance(sim.device_engine, FleetEngine)
        assert [r.pass_idx for r in recs] == [0, 1, 2]
        assert sim.device_engine.n_planes == 1
    sim = constellation.ConstellationSim(
        adapter, energy.PassBudget(n_items=4), shards.batch_at,
        constellation.ConstellationConfig(n_passes=25), device="cpu")
    with pytest.raises(ValueError, match="traceable"):
        sim.run(engine="device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        constellation.ConstellationSim(adapter, energy.PassBudget(),
                                       shards.batch_at)
    from repro_torch.sim.device_sim import DeviceConstellationSim
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceConstellationSim(adapter, energy.PassBudget(),
                               DeviceImageryShards(img=32, batch=2))


def test_config_takes_the_references_fields():
    """``ConstellationConfig(batch_size=..., items_per_pass=...)``, as the
    reference declares them (and its fleet smoke passes batch_size=4):
    accepted, and read by nothing, so the run is the same without them."""
    adapter = sl_step.autoencoder_adapter(img=32)
    shards = ImageryShards(img=32, batch=2)
    want = jcon.ConstellationConfig(n_passes=2, batch_size=4,
                                    items_per_pass=100.0)
    runs = []
    for kw in (dict(batch_size=4, items_per_pass=100.0), {}):
        cfg = constellation.ConstellationConfig(n_passes=2, **kw)
        if kw:
            assert (cfg.batch_size, cfg.items_per_pass) == \
                (want.batch_size, want.items_per_pass)
        sim = constellation.ConstellationSim(
            adapter, energy.PassBudget(plane=orbits.OrbitalPlane(n_sats=2),
                                       n_items=4), shards.batch_at, cfg,
            device="cpu")
        with one_torch_thread():
            runs.append(sim.run())
    assert [(r.action, r.loss, r.battery_j) for r in runs[0]] == \
        [(r.action, r.loss, r.battery_j) for r in runs[1]]
    defaults = constellation.ConstellationConfig()
    assert (defaults.batch_size, defaults.items_per_pass) == (8, 400.0)


def test_host_engine_plans_with_numpy_at_any_ring_size(monkeypatch):
    """The host engine is the oracle: at 512 satellites and more (where
    resource_opt's "auto" takes the torch solver) None and "auto" still
    plan with NumPy; only "torch" solves with the torch solver, on the
    sim's device."""
    from repro_torch.core import resource_opt_torch

    adapter = sl_step.autoencoder_adapter(img=32)
    shards = ImageryShards(img=32, batch=2)
    budget = energy.PassBudget(plane=orbits.OrbitalPlane(n_sats=600),
                               n_items=4)

    def refuse(*a, **k):
        raise AssertionError("the host engine planned with the torch solver")

    monkeypatch.setattr(resource_opt_torch, "solve_batch_torch", refuse)
    monkeypatch.setattr(resource_opt_torch, "shed_and_solve_coeffs", refuse)
    for backend in (None, "auto"):
        sim = constellation.ConstellationSim(
            adapter, budget, shards.batch_at, constellation.ConstellationConfig(
                n_passes=1, solver_backend=backend), device="cpu")
        assert (sim.planner.backend, sim.planner.device) == ("numpy", None)
        rec, = sim.run()
        assert rec.action == "trained" and sim.planner.solve_calls == 1
    sim = constellation.ConstellationSim(
        adapter, budget, shards.batch_at, constellation.ConstellationConfig(
            n_passes=1, solver_backend="torch"), device="cpu")
    assert sim.planner.backend == "torch"
    assert sim.planner.device == torch.device("cpu")


def test_handoff_round_trip_and_tamper_detection(tmp_path):
    adapter = sl_step.resnet18_adapter(img=32)
    pa, _ = adapter.init(torch.Generator().manual_seed(0))
    d = str(tmp_path)
    path, nbytes = ckpt.save_handoff(d, 3, pa, meta={"pass": 3})
    assert nbytes == tree_bytes(pa) == 4 * sum(
        t.numel() for t in tree_leaves(pa))
    later = map_tree(lambda t: t + 1, pa)
    ckpt.save_handoff(d, 5, later)
    tree, meta, step = ckpt.restore_handoff(d, pa)       # the latest
    assert step == 5 and meta["payload_bytes"] == nbytes
    got, want = tree_flatten_with_names(tree), tree_flatten_with_names(later)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    tree, meta, _ = ckpt.restore_handoff(d, pa, pass_idx=3)
    assert meta["pass"] == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                 tree_leaves(pa)))
    # a flipped byte in the payload fails the integrity check
    arr = os.path.join(path, "arrays.npz")
    data = bytearray(open(arr, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(arr, "wb").write(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore_handoff(d, pa, pass_idx=3)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_handoff(str(tmp_path / "empty"), pa)
