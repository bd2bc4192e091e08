"""The port's float64 problem-(13) solver on tensors
(``repro_torch.core.resource_opt_torch``) on the CPU, against the
reference's NumPy solver and its scalar oracle ``solve_reference``, on
the instance grid of ``tests/test_resource_opt_jax.py`` and at that
file's tolerances: phase times and energies rtol 1e-6 (atol 1e-12),
feasibility equal, finite duals rtol 1e-4, e_total and t_total within
1e-6 of the oracle, shed fractions within 2e-4 of the NumPy bisection.
Also the backend selector, the revolution sweep against per-cell host
solves, and the bisection's freezing of a converged instance. The
reference's own device solver does not run under this jax (ROADMAP C1)
and is not called."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import resource_opt as jro
from repro.core import splitting as jsplit
from repro_torch.core import energy, mission, orbits, resource_opt
from repro_torch.core import resource_opt_torch as rot
from repro_torch.core import splitting

CPU = "cpu"


def _grid(E):
    """test_resource_opt_jax.py's grid, built from package ``E``'s
    energy module: feasible, comm/proc-heavy, phase-absent, infeasible
    and Lambert-W branch-point instances and a random cloud."""
    budget = E.PassBudget()
    w_max = budget.sat_device.peak_flops * budget.plane.pass_duration_s \
        / budget.n_items
    S = E.SplitCosts
    cases = [
        S(1e9, 1e9, 1e4, 1e6), S(3e11, 1e11, 1e6, 1e8), S(0.0, 1e9, 1e5, 0.0),
        S(1e9, 1e9, 0.0, 1e6), S(0.0, 1e6, 0.0, 0.0),
        S(w_max * 0.9, 1e6, 1e3, 0.0), S(w_max * 1000, 1e6, 1e3, 0.0),
        S(1e9, 1e9, 5e9, 1e6), E.direct_download_costs(1.605e6, 3.4e9),
        S(0.0, 0.0, 1.0, 0.0), S(0.0, 0.0, 1e-3, 0.0), S(1e9, 1e9, 1.0, 1e6),
    ]
    rng = np.random.default_rng(11)
    for _ in range(28):
        cases.append(S(w1_flops=float(rng.uniform(0, 5e11)),
                       w2_flops=float(rng.uniform(1e6, 5e11)),
                       dtx_bits=float(10.0 ** rng.uniform(-3, 7)),
                       d_isl_bits=float(rng.uniform(0, 1e9))))
    return budget, cases, w_max


def _shed_grid(E):
    budget, _, w_max = _grid(E)
    S = E.SplitCosts
    return budget, [S(1e9, 1e9, 1e4, 1e6), S(w_max * 2, 1e6, 1e3, 0.0),
                    S(w_max * 1000, 1e6, 1e3, 0.0), S(1e9, 1e9, 5e9, 1e6),
                    S(0.0, 1e6, 0.0, 0.0)]


def test_torch_solver_matches_numpy_reference_phase_times():
    tb, tc, _ = _grid(energy)
    jb, jc, _ = _grid(jenergy)
    rt = resource_opt.solve_batch(tb, tc, backend="torch", device=CPU)
    rn = jro.solve_batch(jb, jc, backend="numpy")
    assert rt.n == len(tc)
    np.testing.assert_allclose(rt.phase_times, rn.phase_times, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(rt.phase_energy, rn.phase_energy, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(rt.feasible, rn.feasible)
    fin = np.isfinite(rn.lam) & (rn.lam > 0)
    np.testing.assert_allclose(rt.lam[fin], rn.lam[fin], rtol=1e-4)
    assert np.array_equal(np.isinf(rt.lam), np.isinf(rn.lam))


def test_torch_solver_matches_scalar_oracle_elementwise():
    tb, tc, _ = _grid(energy)
    jb, jc, _ = _grid(jenergy)
    rep = resource_opt.solve_batch(tb, tc, backend="torch", device=CPU)
    for i, c in enumerate(jc):
        ref = jro.solve_reference(jb, c)
        assert bool(rep.feasible[i]) == ref.allocation.feasible, c
        assert rep.e_total[i] == pytest.approx(ref.allocation.e_total,
                                               rel=1e-6, abs=1e-12), c
        assert rep.t_total[i] == pytest.approx(ref.allocation.t_total,
                                               rel=1e-6, abs=1e-12), c
        if ref.allocation.feasible:
            assert rep.kkt_residual[i] < 1e-6


def test_shedding_backend_parity_and_closed_form():
    tb, tgrid = _shed_grid(energy)
    jb, jgrid = _shed_grid(jenergy)
    st = resource_opt.solve_with_shedding_batch(tb, tgrid, backend="torch",
                                                device=CPU)
    sn = jro.solve_with_shedding_batch(jb, jgrid, backend="numpy")
    np.testing.assert_allclose(st.kept_fraction, sn.kept_fraction, atol=2e-4)
    np.testing.assert_allclose(st.report.e_total, sn.report.e_total,
                               rtol=1e-8)
    coeffs = rot._coeffs_from_instances(
        *resource_opt._broadcast_instances(tb, tgrid), CPU)
    rep, frac = rot.shed_and_solve_coeffs(coeffs)
    np.testing.assert_allclose(frac.numpy(), sn.kept_fraction, atol=2e-4)
    assert rep.phase_times.dtype == torch.float64


def test_best_split_and_planner_backend_parity():
    cands = splitting.resnet18_plan().enumerate_cuts()
    jcands = jsplit.resnet18_plan().enumerate_cuts()
    ct, rt = resource_opt.best_split_batch(energy.PassBudget(), cands,
                                           backend="torch", device=CPU)
    cn, rn = jro.best_split_batch(jenergy.PassBudget(), jcands,
                                  backend="numpy")
    assert ct.name == cn.name
    assert rt.allocation.e_total == pytest.approx(rn.allocation.e_total,
                                                  rel=1e-8)
    ring = list(range(8))
    tplan = mission.RevolutionPlanner(backend="torch", device=CPU)
    et = tplan.plan_revolution(
        ring, [energy.PassBudget(n_items=100.0 + 150.0 * s) for s in ring],
        [energy.SplitCosts(1e9 * (s + 1), 1e9, 1e4 * (s + 1), 1e6)
         for s in ring])
    en = jro.solve_with_shedding_batch(
        [jenergy.PassBudget(n_items=100.0 + 150.0 * s) for s in ring],
        [jenergy.SplitCosts(1e9 * (s + 1), 1e9, 1e4 * (s + 1), 1e6)
         for s in ring], backend="numpy")
    for s in ring:
        assert et[s].allocation.e_total == pytest.approx(
            en.at(s).report.allocation.e_total, rel=1e-8)
        assert et[s].shed.kept_fraction == pytest.approx(
            en.kept_fraction[s], abs=2e-4)


def test_backend_selector(monkeypatch):
    b, c = energy.PassBudget(), splitting.resnet18_plan().costs_at(5)
    assert resource_opt._resolve_backend(None, 1) == ("numpy", None)
    assert resource_opt._resolve_backend("auto", 511) == ("numpy", None)
    assert resource_opt._resolve_backend("auto", 4, "cuda") == ("torch",
                                                                  "cuda")
    assert resource_opt._resolve_backend("auto", 4, "cpu") == ("numpy", None)
    assert resource_opt._resolve_backend("torch", 4) == ("torch", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resource_opt._resolve_backend("auto", 512) == ("torch", "cpu")
    # the torch backend runs on the card unless the CPU is asked for
    with pytest.raises(RuntimeError, match="cuda"):
        resource_opt.solve_batch(b, c, backend="torch")
    big = resource_opt.solve_batch(b, [c] * 512)            # auto -> torch
    small = resource_opt.solve_batch(b, [c] * 4)            # auto -> numpy
    np.testing.assert_allclose(big.e_total[:4], small.e_total, rtol=1e-8)
    for call in (resource_opt.solve_batch,
                 resource_opt.solve_with_shedding_batch):
        with pytest.raises(ValueError, match="'torch'"):
            call(b, c, backend="jax")
        with pytest.raises(ValueError, match="unknown"):
            call(b, c, backend="tpu")


def test_converged_instance_stays_frozen_while_others_iterate():
    """The masked bisection freezes an instance once its bracket closes,
    as the reference's while_loop under vmap does: its dual never moves
    again while a slower instance in the same batch keeps bisecting."""
    tb, tc, _ = _grid(energy)
    pair = [tc[0], tc[1]]                  # different bracket widths
    coeffs = rot._coeffs_from_instances(
        *resource_opt._broadcast_instances(tb, pair), CPU)
    lam = np.stack([rot.solve_coeffs(coeffs, tol=1e-10,
                                     max_iters=j).lam.numpy()
                    for j in range(1, 81)])

    def settled_from(col):
        """The first iteration count from which the dual never moves."""
        moved = np.flatnonzero(col != col[-1])
        return 0 if moved.size == 0 else int(moved[-1]) + 1

    fast, slow = sorted(range(2), key=lambda i: settled_from(lam[:, i]))
    # without the freeze the fast instance would keep bisecting (and its
    # dual keep moving) for as long as the slow one does
    assert settled_from(lam[:, fast]) < settled_from(lam[:, slow])
    assert len(np.unique(lam[settled_from(lam[:, fast]):, slow])) > 1


def test_sweep_revolutions_matches_per_cell_host_solves():
    w_max = _grid(energy)[2]
    ring_sizes = [4, 25, 1000]
    cuts = [energy.SplitCosts(1e9, 1e9, 1e4, 1e6, name="light"),
            energy.SplitCosts(3e11, 1e11, 1e6, 1e8, name="paper"),
            energy.SplitCosts(w_max * 3, 1e6, 1e3, 0.0, name="shed")]
    n_items = [100.0, 400.0]
    sweep = mission.sweep_revolutions(ring_sizes, cuts, n_items, device=CPU)
    assert sweep.shape == (3, 3, 2)
    host = sweep.to_host()
    for i, N in enumerate(ring_sizes):
        for j, c in enumerate(cuts):
            for b, n in enumerate(n_items):
                shed = jro.solve_with_shedding(
                    jenergy.PassBudget(plane=jorbits.OrbitalPlane(n_sats=N),
                                       n_items=n),
                    jenergy.SplitCosts(**{k: getattr(c, k) for k in (
                        "w1_flops", "w2_flops", "dtx_bits", "d_isl_bits")}))
                ref = shed.report.allocation
                assert bool(host["feasible"][i, j, b]) == ref.feasible
                assert host["kept_fraction"][i, j, b] == pytest.approx(
                    shed.kept_fraction, abs=2e-4)
                rel = 1e-2 if shed.kept_fraction < 1.0 else 1e-6
                assert host["e_pass"][i, j, b] == pytest.approx(
                    ref.e_total, rel=rel)
                assert host["t_pass"][i, j, b] == pytest.approx(
                    ref.t_total, rel=1e-6)
    np.testing.assert_allclose(
        host["e_revolution"],
        host["e_pass"] * np.asarray(ring_sizes)[:, None, None], rtol=1e-12)
    e = np.where(host["feasible"], host["e_pass"], np.inf)
    np.testing.assert_array_equal(host["best_cut"], np.argmin(e, axis=1))
    steps = sweep.steps_for(4)
    assert steps.dtype == torch.int32 and steps.shape == (3, 3, 2)
    with pytest.raises(NotImplementedError, match="fleet slice"):
        sweep.fleet_plan(4, 2)


def test_sweep_sentinel_and_measured_dtx_override():
    w_max = _grid(energy)[2]
    hopeless = energy.SplitCosts(w_max * 1e6, 1e6, 1e3, 0.0, name="hopeless")
    host = mission.sweep_revolutions([25], [hopeless], [400.0],
                                     device=CPU).to_host()
    assert not host["feasible"].any() and (host["best_cut"] == -1).all()
    cuts = [energy.SplitCosts(1e9, 1e9, 1e4, 1e6, name="a"),
            energy.SplitCosts(1e9, 1e9, 1e4, 1e6, name="b")]
    h0 = mission.sweep_revolutions([25], cuts, [400.0], device=CPU).to_host()
    h1 = mission.sweep_revolutions([25], cuts, [400.0], dtx_bits=[1e4, 5e6],
                                   device=CPU).to_host()
    np.testing.assert_allclose(h1["e_pass"][0, 0], h0["e_pass"][0, 0],
                               rtol=1e-9)
    assert h1["e_pass"][0, 1, 0] > h0["e_pass"][0, 1, 0]


def test_ring_pass_coeffs_match_the_host_gather():
    """The per-satellite device rows equal the NumPy solver's gather of
    the same instances, element for element."""
    plane = orbits.OrbitalPlane(n_sats=6)
    budget = energy.PassBudget(plane=plane, n_items=250.0)
    costs = energy.SplitCosts(2e9, 3e9, 5e4, 1e6)
    dtx = np.array([1e4, 2e4, 3e4, 4e4, 5e4, 6e4])
    sc = rot.grid_scalars(plane, budget.link, budget.isl, budget.sat_device,
                          budget.gs_device, device=CPU)
    got = rot.ring_pass_coeffs(sc, 6, costs.w1_flops, costs.w2_flops, dtx,
                               costs.d_isl_bits, budget.n_items)
    want = resource_opt._gather_coeff_arrays(
        [budget] * 6, [dataclasses.replace(costs, dtx_bits=d) for d in dtx])
    for k, v in want.items():
        np.testing.assert_allclose(getattr(got, k).numpy(), v, rtol=1e-12,
                                   err_msg=k)
