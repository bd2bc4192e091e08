"""Problem (13) on the device: the batched float64 solver on tensors (the
port of ``repro/core/resource_opt_jax.py``).

The same dual-waterfilling algorithm as the NumPy
:func:`~repro_torch.core.resource_opt.solve_batch`: the Lambert-W closed
form for the comm phases, the cube-root closed form for the processing
phases and one geometric bisection on the dual λ, written over a leading
batch axis of tensors on an explicit device. Every tensor here is
float64, made so explicitly: the λ bracket spans hundreds of decades. No
global default dtype is set, so the SL stack stays float32; the plan is
cast to float32 at the planning/training boundary
(:func:`repro_torch.sim.device_sim.plan_from_report`).

The reference's bisection is a ``lax.while_loop`` under ``vmap``: a lane
whose bracket has closed (``lam_hi <= lam_lo * (1 + tol)``) keeps its
carry while the others go on. Here the loop runs ``max_iters`` masked
iterations and freezes each instance the same way, so the result does
not depend on the other instances and nothing is read back to the host
to decide when to stop.

The Lambert-W branch point gets the same series guard as the NumPy path:
for λ·g̃ below ~1e-6 the argument (λ·g̃ − 1)/e rounds into the branch
point where W₀ loses all precision, and the series x ≈ √(2·λ·g̃) of
``e^x (x−1) + 1 = λ·g̃`` is exact; two Newton polish steps on the
cancellation-free residual restore double precision elsewhere.

Phases are laid out [sat_proc, downlink, gs_proc, uplink] with liveness
masks, as in the reference. The reference pads batches to bucketed
sizes to bound its recompiles; eager PyTorch compiles nothing, so the
port does not pad.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.orbits import C_LIGHT, R_EARTH_M

_EPS = 1e-12
_LN2 = math.log(2.0)
F64 = torch.float64


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=F64, device=device)


# --------------------------------------------------------------------------
# Elementwise building blocks (float64).
# --------------------------------------------------------------------------

def _lambert_w0(z):
    """Principal-branch Lambert W for z >= -1/e, elementwise: the
    branch-point series init below zero, log init above, then 5 Halley
    steps (the solver's Newton polish finishes the job)."""
    w = torch.where(z < 0.0,
                    -1.0 + torch.sqrt(torch.clamp(2.0 * (1.0 + math.e * z),
                                                  min=0.0)),
                    torch.log1p(torch.clamp(z, min=0.0)))
    big = z > math.e
    lz = torch.log(torch.where(big, z, math.e))
    w = torch.where(big, lz - torch.log(lz), w)
    for _ in range(5):
        w = torch.clamp(w, min=-1.0 + 1e-12)     # keep 2w+2 away from zero
        ew = torch.exp(torch.clamp(w, max=700.0))
        f = w * ew - z
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w = w - f / torch.where(denom != 0.0, denom, 1.0)
    return torch.clamp(w, min=-1.0)


def _comm_neg_deriv_vec(c, gain, t):
    """−E'(t) of a comm phase, cancellation-free (see resource_opt)."""
    x = torch.where(t > 0.0, c * _LN2 / torch.clamp(t, min=1e-300),
                    math.inf)
    xs = torch.clamp(x, max=500.0)
    e = torch.expm1(xs)
    nd = (e * xs - (e - xs)) / gain
    return torch.where(x > 500.0, math.inf, nd)


def _comm_t_of_lambda_vec(c, gain, lam, t_min, t_hi):
    """Closed-form t(λ) for the comm phases via Lambert W:
    −E'(t) = λ  ⟺  e^x (x−1) + 1 = λ·g̃  with x = c·ln2/t, so
    x = 1 + W₀((λ·g̃ − 1)/e); series guard at the branch point, two
    Newton polish steps on the stable residual."""
    lg = lam * gain
    z = torch.clamp((lg - 1.0) / math.e, min=-1.0 / math.e)
    x = 1.0 + _lambert_w0(z)
    x = torch.where(lg < 1e-6, torch.sqrt(torch.clamp(2.0 * lg, min=0.0)),
                    x)
    x = torch.clamp(x, min=1e-300)
    for _ in range(2):
        xs = torch.clamp(x, max=500.0)
        em = torch.expm1(xs)
        f = em * xs - (em - xs) - lg
        fp = (em + 1.0) * xs
        x = torch.clamp(x - f / torch.clamp(fp, min=1e-300), min=1e-300)
    t = c * _LN2 / x
    return torch.minimum(torch.maximum(t, t_min), t_hi)


def _proc_t_of_lambda_vec(k, lam, t_min, t_hi):
    """Closed-form t(λ) = (2k/λ)^{1/3} for the processing phases (the
    argument is >= 0, so a power of 1/3 is the cube root)."""
    t = (2.0 * k / torch.clamp(lam, min=1e-300)) ** (1.0 / 3.0)
    return torch.minimum(torch.maximum(t, t_min), t_hi)


# --------------------------------------------------------------------------
# The batched solver.
# --------------------------------------------------------------------------

class CoeffArrays(NamedTuple):
    """Problem-(13) coefficients as float64 tensors.

    ``k``/``tmin_p`` are (..., 2) for [sat_proc, gs_proc]; ``cc``/
    ``tmin_c`` (..., 2) for [downlink, uplink] (bits/Hz); the rest
    (...,). Any leading batch shape works. A phase with ``k``/``cc``
    equal to 0 is absent.
    """

    k: torch.Tensor
    tmin_p: torch.Tensor
    cc: torch.Tensor
    tmin_c: torch.Tensor
    gain: torch.Tensor
    t_budget: torch.Tensor
    e_isl: torch.Tensor
    t_fixed: torch.Tensor

    def scaled_items(self, frac) -> "CoeffArrays":
        """Coefficients at a per-instance kept item fraction ``frac``:
        every t_min and the comm payload scale linearly with n_items, the
        processing constant k cubically; the budget and the ISL terms do
        not depend on it."""
        f1 = torch.as_tensor(frac, dtype=F64, device=self.k.device)[..., None]
        return self._replace(k=self.k * f1 ** 3, tmin_p=self.tmin_p * f1,
                             cc=self.cc * f1, tmin_c=self.tmin_c * f1)


class ArraySolveReport(NamedTuple):
    """Tensor solution of problem (13); see BatchSolveReport."""

    phase_times: torch.Tensor     # (..., 4) seconds
    phase_energy: torch.Tensor    # (..., 4) joules
    lam: torch.Tensor             # (...,)  dual (inf if infeasible)
    kkt_residual: torch.Tensor    # (...,)
    feasible: torch.Tensor        # (...,)  bool
    e_isl: torch.Tensor           # (...,)  joules
    t_fixed: torch.Tensor         # (...,)  seconds

    @property
    def e_total(self):
        """eq. (11) per instance, including the constant E_ISL."""
        return self.phase_energy.sum(dim=-1) + self.e_isl

    @property
    def t_total(self):
        """eq. (12) per instance, including the fixed overhead."""
        return self.phase_times.sum(dim=-1) + self.t_fixed


def _solve(k, tmin_p, cc, tmin_c, gain, t_budget, *, tol, max_iters):
    """The per-instance solve of the reference's ``_solve_one`` over a
    leading batch axis: (B, 2) and (B,) float64 inputs."""
    live_p = k > 0.0
    live_c = cc > 0.0
    tmin_p = torch.where(live_p, tmin_p, 0.0)
    tmin_c = torch.where(live_c, tmin_c, 0.0)
    g2 = gain[:, None]

    t_min_sum = tmin_p.sum(-1) + tmin_c.sum(-1)
    any_live = live_p.any(-1) | live_c.any(-1)
    infeasible = any_live & ((t_budget <= 0.0) | (t_min_sum > t_budget))
    active = any_live & ~infeasible
    t_hi = torch.clamp(t_budget, min=0.0)[:, None]

    # ---- analytic λ bracket: total_time(λ) is decreasing in λ ----------
    nd_p_lo = 2.0 * k / torch.clamp(tmin_p, min=1e-300) ** 3
    nd_p_hi = 2.0 * k / torch.clamp(t_hi, min=1e-300) ** 3
    nd_c_lo = _comm_neg_deriv_vec(cc, g2, torch.clamp(tmin_c, min=1e-300))
    nd_c_hi = _comm_neg_deriv_vec(cc, g2, torch.clamp(t_hi, min=1e-300))
    nd_lo = torch.cat([torch.where(live_p, nd_p_lo, -math.inf),
                       torch.where(live_c, nd_c_lo, -math.inf)], dim=-1)
    nd_hi = torch.cat([torch.where(live_p, nd_p_hi, math.inf),
                       torch.where(live_c, nd_c_hi, math.inf)], dim=-1)
    lam_hi = torch.clamp(torch.nan_to_num(nd_lo.amax(-1), nan=0.0,
                                          neginf=1.0, posinf=1e300),
                         min=1e-300)
    lam_lo = torch.minimum(torch.clamp(torch.nan_to_num(
        nd_hi.amin(-1), nan=0.0, posinf=1.0), min=1e-300), lam_hi)

    def times_at(lam):
        l2 = lam[:, None]
        tp = torch.where(live_p,
                         _proc_t_of_lambda_vec(k, l2, tmin_p, t_hi), 0.0)
        tc = torch.where(live_c,
                         _comm_t_of_lambda_vec(cc, g2, l2, tmin_c, t_hi),
                         0.0)
        return tp, tc

    # ---- geometric bisection on λ: max_iters masked iterations ---------
    for _ in range(max_iters):
        go = active & (lam_hi > lam_lo * (1.0 + tol))
        lam = torch.sqrt(lam_lo * lam_hi)      # geometric mid: λ spans decades
        tp, tc = times_at(lam)
        over = (tp.sum(-1) + tc.sum(-1)) > t_budget
        lam_lo = torch.where(go & over, lam, lam_lo)
        lam_hi = torch.where(go & ~over, lam, lam_hi)
    lam = torch.sqrt(lam_lo * lam_hi)
    tp, tc = times_at(lam)

    # ---- slack redistribution (t_min-clamped phases leave headroom) ----
    slack = t_budget - (tp.sum(-1) + tc.sum(-1))
    int_p = live_p & (tp > tmin_p * (1.0 + 1e-9))
    int_c = live_c & (tc > tmin_c * (1.0 + 1e-9))
    n_int = int_p.sum(-1) + int_c.sum(-1)
    bump = torch.where(active & (slack > 1e-9 * t_budget) & (n_int > 0),
                       slack / torch.clamp(n_int, min=1), 0.0)[:, None]
    tp = torch.where(int_p, tp + bump, tp)
    tc = torch.where(int_c, tc + bump, tc)

    # ---- infeasible / no-phase instances -------------------------------
    tp = torch.where(infeasible[:, None], tmin_p, tp)
    tc = torch.where(infeasible[:, None], tmin_c, tc)
    tp = torch.where(any_live[:, None], tp, 0.0)
    tc = torch.where(any_live[:, None], tc, 0.0)

    # ---- energies at the final times -----------------------------------
    e_p = torch.where(live_p & (tp > 0.0),
                      k / torch.clamp(tp, min=1e-300) ** 2, 0.0)
    xc = cc * _LN2 / torch.clamp(tc, min=1e-300)
    e_c = torch.where(live_c & (tc > 0.0),
                      tc * torch.expm1(torch.clamp(xc, max=700.0)) / g2, 0.0)
    e_c = torch.where(live_c & (xc > 700.0), math.inf, e_c)

    # ---- KKT residual: spread of marginals among interior phases -------
    nd_p = 2.0 * k / torch.clamp(tp, min=1e-300) ** 3
    nd_c = _comm_neg_deriv_vec(cc, g2, torch.clamp(tc, min=1e-300))
    io_p = live_p & (tp > tmin_p * (1.0 + 1e-6)) & (tp < t_hi * (1.0 - 1e-6))
    io_c = live_c & (tc > tmin_c * (1.0 + 1e-6)) & (tc < t_hi * (1.0 - 1e-6))
    marg = torch.cat([torch.where(io_p, nd_p, math.nan),
                      torch.where(io_c, nd_c, math.nan)], dim=-1)
    n_io = io_p.sum(-1) + io_c.sum(-1)
    filled = torch.where(n_io[:, None] >= 2, marg, 1.0)
    nan = torch.isnan(filled)
    mmax = torch.where(nan, -math.inf, filled).amax(-1)
    mmin = torch.where(nan, math.inf, filled).amin(-1)
    kkt = torch.where(n_io >= 2, (mmax - mmin) / torch.clamp(mmax, min=_EPS),
                      0.0)
    kkt = torch.where(infeasible, math.inf, kkt)

    lam_out = torch.where(infeasible, math.inf,
                          torch.where(any_live, lam, 0.0))
    phase_times = torch.stack([tp[:, 0], tc[:, 0], tp[:, 1], tc[:, 1]], -1)
    phase_energy = torch.stack([e_p[:, 0], e_c[:, 0], e_p[:, 1], e_c[:, 1]],
                               -1)
    return phase_times, phase_energy, lam_out, kkt, ~infeasible


def solve_coeffs(coeffs: CoeffArrays, tol: float = 1e-10,
                 max_iters: int = 80) -> ArraySolveReport:
    """Solve problem (13) for a tensor of instances on their device.

    ``coeffs`` may carry any leading batch shape; it is flattened for
    the solve and restored on the outputs. Nothing is read back to the
    host.
    """
    lead = tuple(coeffs.gain.shape)
    flat = [a.reshape((-1,) + tuple(a.shape[len(lead):])) for a in coeffs]
    pt, pe, lam, kkt, feas = _solve(*flat[:6], tol=tol, max_iters=max_iters)
    return ArraySolveReport(
        phase_times=pt.reshape(lead + (4,)),
        phase_energy=pe.reshape(lead + (4,)),
        lam=lam.reshape(lead), kkt_residual=kkt.reshape(lead),
        feasible=feas.reshape(lead),
        e_isl=coeffs.e_isl, t_fixed=coeffs.t_fixed)


def shed_fractions(coeffs: CoeffArrays,
                   min_fraction: float = 0.05) -> torch.Tensor:
    """Per-instance kept fraction restoring feasibility, closed form.

    Every phase's t_min scales linearly with n_items while the time
    budget does not, so the largest feasible fraction is
    T_budget / Σ t_min (the NumPy path bisects to the same value within
    its tolerance). Clamped to [min_fraction, 1]; instances with no
    budget sit at the floor, instances with no live phase keep 1.
    """
    tmin_sum = (torch.where(coeffs.k > 0.0, coeffs.tmin_p, 0.0).sum(-1)
                + torch.where(coeffs.cc > 0.0, coeffs.tmin_c, 0.0).sum(-1))
    no_phase = tmin_sum == 0.0
    feas_full = no_phase | ((coeffs.t_budget > 0.0)
                            & (tmin_sum <= coeffs.t_budget))
    # one-ulp shave keeps the scaled Σ t_min on the feasible side
    fit = (coeffs.t_budget / torch.clamp(tmin_sum, min=1e-300)) \
        * (1.0 - 1e-12)
    frac = torch.where(feas_full, 1.0,
                       torch.clamp(fit, min=min_fraction, max=1.0))
    return torch.where(no_phase | (coeffs.t_budget > 0.0), frac,
                       min_fraction)


def shed_and_solve_coeffs(coeffs: CoeffArrays, min_fraction: float = 0.05,
                          tol: float = 1e-10, max_iters: int = 80
                          ) -> Tuple[ArraySolveReport, torch.Tensor]:
    """Closed-form shedding, then the solve at the kept item counts."""
    frac = shed_fractions(coeffs, min_fraction)
    return solve_coeffs(coeffs.scaled_items(frac), tol, max_iters), frac


# --------------------------------------------------------------------------
# The batch API over (PassBudget, SplitCosts) instances.
# --------------------------------------------------------------------------

def _coeffs_from_instances(blist, clist, device) -> CoeffArrays:
    """The host gather of the NumPy solver (``_gather_coeff_arrays``),
    moved to ``device`` in float64."""
    from repro_torch.core import resource_opt

    arrs = resource_opt._gather_coeff_arrays(blist, clist)
    return CoeffArrays(**{k: _f64(a, device) for k, a in arrs.items()})


def solve_batch_torch(budgets, costs, tol: float = 1e-10,
                      max_iters: int = 80, device="cuda"):
    """The tensor twin of :func:`resource_opt.solve_batch`, same report.

    Takes the same (budget | sequence, costs | sequence) broadcasting,
    solves on ``device`` (the card unless the caller asks for the CPU)
    and returns a host :class:`~repro_torch.core.resource_opt.
    BatchSolveReport`. For a pipeline that stays on the device use
    :func:`solve_coeffs`.
    """
    from repro_torch import resolve_device
    from repro_torch.core import resource_opt

    dev = resolve_device(device)
    blist, clist = resource_opt._broadcast_instances(budgets, costs)
    rep = solve_coeffs(_coeffs_from_instances(blist, clist, dev), tol=tol,
                       max_iters=max_iters)
    out = [a.cpu().numpy() for a in rep]
    return resource_opt.BatchSolveReport(
        *out, budgets=tuple(blist), costs=tuple(clist))


# --------------------------------------------------------------------------
# Coefficient grids on the device (ring size × cut point × item budget).
# --------------------------------------------------------------------------

class GridScalars(NamedTuple):
    """Scenario constants of a revolution sweep, as 0-d float64 tensors
    on the sweep's device."""

    pass_duration_s: torch.Tensor
    t_prop_s: torch.Tensor
    gain: torch.Tensor                  # g̃ at the mean slant range
    r_max_bps: torch.Tensor             # link rate at P_max
    bandwidth_hz: torch.Tensor
    isl_rate_bps: torch.Tensor
    isl_tx_power_w: torch.Tensor
    orbit_radius_m: torch.Tensor        # R_earth + altitude
    sat_k_const: torch.Tensor           # P_p / (f_max³ · (N_c·N_F)³)
    sat_t_const: torch.Tensor           # 1 / (N_c·N_F·f_max)
    gs_k_const: torch.Tensor
    gs_t_const: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.gain.device


def grid_scalars(plane, link, isl, sat_device, gs_device,
                 device="cuda") -> GridScalars:
    """Fold the scenario dataclasses into :class:`GridScalars` on
    ``device`` (the card unless the caller asks for the CPU)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    d = plane.mean_slant_range_m()
    f64 = functools.partial(_f64, device=dev)

    def dev_consts(hw):
        nc = hw.n_cores * hw.flops_per_cycle
        return (f64(hw.power_max_w / (hw.f_max_hz ** 3 * nc ** 3)),
                f64(1.0 / (nc * hw.f_max_hz)))

    sat_k, sat_t = dev_consts(sat_device)
    gs_k, gs_t = dev_consts(gs_device)
    return GridScalars(
        pass_duration_s=f64(plane.pass_duration_s),
        t_prop_s=f64(plane.mean_prop_delay_s),
        gain=f64(link.channel_gain(d)),
        r_max_bps=f64(link.rate_bps(link.max_tx_power_w, d)),
        bandwidth_hz=f64(link.bandwidth_hz),
        isl_rate_bps=f64(isl.rate_bps),
        isl_tx_power_w=f64(isl.tx_power_w),
        orbit_radius_m=f64(R_EARTH_M + plane.altitude_m),
        sat_k_const=sat_k, sat_t_const=sat_t,
        gs_k_const=gs_k, gs_t_const=gs_t)


def _coeffs(sc: GridScalars, isl_dist, w1, w2, dtx, disl, n, shape
            ) -> CoeffArrays:
    """The coefficients of ``resource_opt._phase_coeffs``, elementwise,
    broadcast to ``shape``."""
    t_fixed = (2.0 * sc.t_prop_s + disl / sc.isl_rate_bps
               + isl_dist / C_LIGHT)
    t_budget = sc.pass_duration_s - t_fixed
    e_isl = sc.isl_tx_power_w * disl / sc.isl_rate_bps
    bits = n * dtx
    c_comm = bits / sc.bandwidth_hz
    tmin_comm = torch.where(bits > 0.0, bits / sc.r_max_bps, 0.0)
    b = lambda a: torch.broadcast_to(a, shape)           # noqa: E731
    pair = lambda x, y: torch.stack([b(x), b(y)], dim=-1)  # noqa: E731
    return CoeffArrays(
        k=pair(sc.sat_k_const * (n * w1) ** 3, sc.gs_k_const * (n * w2) ** 3),
        tmin_p=pair(sc.sat_t_const * n * w1, sc.gs_t_const * n * w2),
        cc=pair(c_comm, c_comm), tmin_c=pair(tmin_comm, tmin_comm),
        gain=b(sc.gain), t_budget=b(t_budget), e_isl=b(e_isl),
        t_fixed=b(t_fixed))


def ring_grid_coeffs(sc: GridScalars, ring_sizes, w1, w2, dtx, disl,
                     n_items) -> CoeffArrays:
    """The (R, C, B) coefficient grid: ``ring_sizes`` (R,) enter through
    the ISL hop distance (eq. 5), the cut arrays ``w1``/``w2``/``dtx``/
    ``disl`` (C,) carry the split plan, ``n_items`` (B,) the per-pass
    item budgets. Mirrors ``resource_opt._phase_coeffs`` element for
    element, on the device."""
    dev = sc.device
    N = _f64(ring_sizes, dev)[:, None, None]                     # (R,1,1)
    cut = lambda a: _f64(a, dev)[None, :, None]                  # noqa: E731
    n = _f64(n_items, dev)[None, None, :]                        # (1,1,B)
    shape = torch.broadcast_shapes(N.shape, (1, len(w1), 1), n.shape)
    isl_dist = 2.0 * sc.orbit_radius_m * torch.sin(math.pi / N)
    return _coeffs(sc, isl_dist, cut(w1), cut(w2), cut(dtx), cut(disl), n,
                   shape)


def ring_pass_coeffs(sc: GridScalars, n_sats, w1, w2, dtx, disl, n_items,
                     *, ring_n: Optional[int] = None) -> CoeffArrays:
    """One ring revolution's problem-(13) instances as ``(N,)`` rows.

    Every coefficient input may be a scalar (broadcast ring-wide) or an
    ``(N,)`` array (per-satellite measured boundary payloads,
    heterogeneous item budgets). ``n_sats`` may also be a shape tuple;
    ``ring_n`` then gives the orbital population of the ISL hop distance
    (default: the last dimension).
    """
    shape = (tuple(int(s) for s in n_sats)
             if isinstance(n_sats, (tuple, list)) else (int(n_sats),))
    ring_n = shape[-1] if ring_n is None else int(ring_n)
    dev = sc.device
    b = lambda a: torch.broadcast_to(_f64(a, dev), shape)   # noqa: E731
    isl_dist = 2.0 * sc.orbit_radius_m * math.sin(math.pi / float(ring_n))
    return _coeffs(sc, isl_dist, b(w1), b(w2), b(dtx), b(disl), b(n_items),
                   shape)


def sweep_grid(sc: GridScalars, ring_sizes, w1, w2, dtx, disl, n_items,
               min_fraction: float = 0.05, tol: float = 1e-10,
               max_iters: int = 80):
    """Plan a whole (ring × cut × budget) grid on ``sc``'s device: grid
    build, closed-form shedding and the solve, with no host read.
    Returns ``(ArraySolveReport, kept fractions)``."""
    coeffs = ring_grid_coeffs(sc, ring_sizes, w1, w2, dtx, disl, n_items)
    return shed_and_solve_coeffs(coeffs, min_fraction, tol, max_iters)
