"""Problem (13): per-pass energy minimization — exact solver.

The paper observes problem (13) is quasiconvex and solves it "with the
bisection method".  We make that exact (DESIGN.md §3): substituting the
per-phase *times* as decision variables turns (13) into a separable
convex resource-allocation problem

    min   Σᵢ Eᵢ(tᵢ)
    s.t.  Σᵢ tᵢ ≤ T_budget        (= T_pass − 2·T_prop − T_ISL)
          tᵢ ≥ tᵢ_min             (from f ≤ f_max and p ≤ P_max)

with every Eᵢ convex and strictly decreasing, so the deadline binds at
the optimum and the KKT conditions reduce to the classic waterfilling
form  −Eᵢ'(tᵢ) = λ  (or tᵢ = tᵢ_min where the bound binds).  We bisect
on the dual λ — *this is the paper's bisection, applied to the dual* —
with closed-form tᵢ(λ) for the processing phases and a scalar inner
bisection for the Shannon-rate comm phases.

Phases (i):
    0: sat processing   E(t) = k/t²,  k = (P_p/f_max³)(nW₁/(N_c N_F))³
    1: downlink comm    E(t) = t·(2^{c/t} − 1)/g̃,  c = n·D_tx/B
    2: gs processing    (as 0 with W₂)
    3: uplink comm      (as 1 — same payload per the paper)

Infeasibility (Σ tᵢ_min > T_budget) is reported, and
:func:`solve_with_shedding_batch` implements the straggler-mitigation policy:
shed the smallest batch fraction that restores feasibility.

Batched solver (the constellation-scale hot path)
-------------------------------------------------
:func:`solve_batch` solves problem (13) for an *array* of
(budget, costs) instances at once.  The dual-λ bisection is vectorized
across instances with NumPy, and the scalar inner bisection for the
comm phases disappears entirely: the comm-phase stationarity condition
``−E'(t) = λ`` is, in ``x = c·ln2/t``,

    e^x (x − 1) + 1 = λ·g̃      ⟹      x = 1 + W₀((λ·g̃ − 1)/e)

a closed form in the principal Lambert-W branch (two stable Newton
polish steps recover full precision near the branch point).  One
geometric λ-bisection with analytic brackets — λ_hi = maxᵢ −Eᵢ'(tᵢ_min),
λ_lo = minᵢ −Eᵢ'(T_budget) — then solves every instance simultaneously
in ~50 vectorized iterations.

The scalar :func:`solve` is a thin wrapper over a 1-instance batch.
:func:`best_split_batch` runs the cut-point sweep through one batched
call.

This is the port's copy of the reference's NumPy solver
(``repro/core/resource_opt.py``), held against it in the tests. The
reference's JAX backend has a tensor counterpart,
:mod:`repro_torch.core.resource_opt_torch`: every batch entry point takes
``backend="numpy" | "torch" | "auto"`` and a ``device`` for the torch
backend (the card unless the caller asks for the CPU). ``"jax"`` raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.energy import (Allocation, PassBudget, SplitCosts,
                               allocation_from_times)

_EPS = 1e-12
_LN2 = math.log(2.0)

try:
    from scipy.special import lambertw as _scipy_lambertw
except ModuleNotFoundError:                     # pragma: no cover
    _scipy_lambertw = None


# --------------------------------------------------------------------------
# Per-phase convex models in the time domain.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Phase:
    """One separable term: energy(t), its negated derivative, and t_min."""

    name: str
    t_min: float
    energy: Callable[[float], float]
    neg_deriv: Callable[[float], float]   # −E'(t): positive, decreasing in t

    def t_of_lambda(self, lam: float, t_hi: float) -> float:
        """Solve −E'(t) = lam for t ∈ [t_min, t_hi] (monotone bisection)."""
        lo, hi = self.t_min, t_hi
        if self.neg_deriv(lo) <= lam:     # marginal already below λ at the bound
            return lo
        if self.neg_deriv(hi) >= lam:     # even at t_hi the marginal exceeds λ
            return hi
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if self.neg_deriv(mid) > lam:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-12 * max(1.0, hi):
                break
        return 0.5 * (lo + hi)


def _proc_phase(name: str, k: float, t_min: float) -> Optional[_Phase]:
    """E(t) = k / t², −E'(t) = 2k/t³; closed-form t(λ) = (2k/λ)^{1/3}."""
    if k <= 0.0:
        return None

    phase = _Phase(
        name=name,
        t_min=t_min,
        energy=lambda t: k / (t * t),
        neg_deriv=lambda t: 2.0 * k / (t * t * t),
    )

    # closed form overrides the generic bisection
    def t_of_lambda(lam: float, t_hi: float, _k=k, _tmin=t_min) -> float:
        t = (2.0 * _k / max(lam, 1e-300)) ** (1.0 / 3.0)
        return min(max(t, _tmin), t_hi)

    object.__setattr__(phase, "t_of_lambda", t_of_lambda)
    return phase


def _comm_phase(name: str, c_bits_per_hz: float, gain: float,
                t_min: float) -> Optional[_Phase]:
    """E(t) = t (2^{c/t} − 1)/g̃ with c = bits/B.

    −E'(t) = [2^{c/t}((c ln2)/t − 1) + 1]/g̃, positive and decreasing.
    Evaluated via expm1 to avoid catastrophic cancellation for small
    c/t (the naive form loses ~1e-3 relative accuracy at u ~ 1e-6,
    which corrupts the dual bisection — caught by the KKT-residual
    hypothesis test).
    """
    if c_bits_per_hz <= 0.0:
        return None
    ln2 = math.log(2.0)

    def energy(t: float, c=c_bits_per_hz, g=gain) -> float:
        return t * math.expm1((c / t) * ln2) / g

    def neg_deriv(t: float, c=c_bits_per_hz, g=gain) -> float:
        u = c / t
        ul = u * ln2
        if ul > 500.0:                     # avoid overflow: exp regime
            return math.exp(500.0) / g     # effectively +inf marginal
        e = math.expm1(ul)
        # 1 + (1+e)(ul - 1) = e*ul - (e - ul); both terms O(u^2), stable
        return (e * ul - (e - ul)) / g

    return _Phase(name=name, t_min=t_min, energy=energy, neg_deriv=neg_deriv)


@dataclasses.dataclass(frozen=True)
class _PhaseCoeffs:
    """Raw per-instance coefficients of the four canonical phases.

    The single source of truth shared by the scalar phase objects
    (:func:`_build_phases`) and the vectorized batch arrays
    (:func:`solve_batch`): ``k`` for the two processing phases
    (E = k/t²), ``c`` (bits/Hz) and ``gain`` for the two comm phases,
    plus every phase's t_min.
    """

    k_sat: float
    t_min_sat: float
    c_down: float
    t_min_down: float
    k_gs: float
    t_min_gs: float
    c_up: float
    t_min_up: float
    gain: float


def _phase_coeffs(budget: PassBudget, costs: SplitCosts) -> _PhaseCoeffs:
    n = budget.n_items
    d = budget.mean_distance_m
    link = budget.link
    gain = link.channel_gain(d)

    def proc_k(dev, w):
        nw = n * w / (dev.n_cores * dev.flops_per_cycle)
        return dev.power_max_w / dev.f_max_hz**3 * nw**3

    down_bits = n * costs.dtx_bits
    up_bits = n * costs.dtx_bits
    r_max = link.rate_bps(link.max_tx_power_w, d)

    return _PhaseCoeffs(
        k_sat=proc_k(budget.sat_device, costs.w1_flops),
        t_min_sat=budget.sat_device.min_proc_time_s(costs.w1_flops, n),
        c_down=down_bits / link.bandwidth_hz,
        t_min_down=down_bits / r_max if down_bits > 0 else 0.0,
        k_gs=proc_k(budget.gs_device, costs.w2_flops),
        t_min_gs=budget.gs_device.min_proc_time_s(costs.w2_flops, n),
        c_up=up_bits / link.bandwidth_hz,
        t_min_up=up_bits / r_max if up_bits > 0 else 0.0,
        gain=gain,
    )


def _build_phases(budget: PassBudget, costs: SplitCosts) -> List[Optional[_Phase]]:
    """Phases in canonical order [sat_proc, down, gs_proc, up]; None = absent."""
    cf = _phase_coeffs(budget, costs)
    return [
        _proc_phase("sat_proc", cf.k_sat, cf.t_min_sat),
        _comm_phase("downlink", cf.c_down, cf.gain, cf.t_min_down),
        _proc_phase("gs_proc", cf.k_gs, cf.t_min_gs),
        _comm_phase("uplink", cf.c_up, cf.gain, cf.t_min_up),
    ]


# --------------------------------------------------------------------------
# The dual-bisection (waterfilling) solver.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolveReport:
    allocation: Allocation
    lam: float
    kkt_residual: float
    iterations: int
    phase_times: dict


def _alloc_from_phase_times(budget, costs, phases, times, feasible):
    def t_of(idx, name):
        p = phases[idx]
        return times.get(name, 0.0) if p is not None else 0.0
    return allocation_from_times(
        budget, costs,
        t_proc_sat=t_of(0, "sat_proc"),
        t_comm_down=t_of(1, "downlink"),
        t_proc_gs=t_of(2, "gs_proc"),
        t_comm_up=t_of(3, "uplink"),
        feasible=feasible,
    )


# --------------------------------------------------------------------------
# Vectorized (batched) solver: problem (13) over an array of instances.
# --------------------------------------------------------------------------

def _lambert_w0(z: np.ndarray) -> np.ndarray:
    """Principal-branch Lambert W, vectorized; z >= -1/e elementwise."""
    if _scipy_lambertw is not None:
        return np.real(_scipy_lambertw(z))
    # Halley fallback (no scipy): branch-point init for z < 0, log init above.
    z = np.asarray(z, dtype=np.float64)
    w = np.where(z < 0.0,
                 -1.0 + np.sqrt(np.maximum(2.0 * (1.0 + math.e * z), 0.0)),
                 np.log1p(np.maximum(z, 0.0)))
    with np.errstate(divide="ignore", invalid="ignore"):
        big = z > math.e
        lz = np.log(np.where(big, z, math.e))
        w = np.where(big, lz - np.log(lz), w)
    for _ in range(20):
        w = np.maximum(w, -1.0 + 1e-12)     # keep 2w+2 away from zero
        ew = np.exp(np.minimum(w, 700.0))
        f = w * ew - z
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w = w - f / np.where(denom != 0.0, denom, 1.0)
    return np.maximum(w, -1.0)


def _comm_neg_deriv_vec(c, gain, t):
    """−E'(t) of a comm phase, elementwise-stable (see _comm_phase)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x = np.where(t > 0.0, c * _LN2 / np.maximum(t, 1e-300), np.inf)
        xs = np.minimum(x, 500.0)
        e = np.expm1(xs)
        nd = (e * xs - (e - xs)) / gain
        return np.where(x > 500.0, np.inf, nd)


def _comm_t_of_lambda_vec(c, gain, lam, t_min, t_hi):
    """Closed-form t(λ) for the comm phases via Lambert W.

    −E'(t) = λ  ⟺  e^x (x−1) + 1 = λ·g̃  with x = c·ln2/t, so
    x = 1 + W₀((λ·g̃ − 1)/e).  Two Newton steps on the cancellation-free
    residual  expm1(x)·x − (expm1(x) − x) − λ·g̃  restore full precision
    near the branch point (small λ·g̃  ⟹  x ≈ √(2λg̃)).
    """
    lg = lam * gain
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        z = np.maximum((lg - 1.0) / math.e, -1.0 / math.e)
        x = 1.0 + _lambert_w0(z)
        # Branch-point underflow: for λ·g̃ ≲ 2.2e-16 the argument rounds
        # to exactly −1/e and W₀ returns NaN; the series x ≈ √(2·λg̃) of
        # e^x(x−1)+1 = λg̃ is exact there (and the Newton polish below
        # removes its O(x²) error for the rest of the small-λ range).
        small = lg < 1e-6
        x = np.where(small, np.sqrt(2.0 * np.maximum(lg, 0.0)), x)
        x = np.maximum(x, 1e-300)
        for _ in range(2):
            xs = np.minimum(x, 500.0)
            em = np.expm1(xs)
            f = em * xs - (em - xs) - lg
            fp = (em + 1.0) * xs
            x = np.maximum(x - f / np.maximum(fp, 1e-300), 1e-300)
        t = c * _LN2 / x
    return np.clip(t, t_min, t_hi)


def _proc_t_of_lambda_vec(k, lam, t_min, t_hi):
    """Closed-form t(λ) = (2k/λ)^{1/3} for the processing phases."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        t = np.cbrt(2.0 * k / np.maximum(lam, 1e-300))
    return np.clip(t, t_min, t_hi)


@dataclasses.dataclass(frozen=True)
class BatchSolveReport:
    """Vectorized solution of problem (13) for B instances.

    Arrays are NumPy, shape (B,) or (B, 4); the phase axis is the
    canonical order [sat_proc, downlink, gs_proc, uplink] with zeros
    where a phase is absent.  :meth:`report_at` materializes the full
    scalar :class:`SolveReport` (with the implied (f, p) allocation)
    for one instance.
    """

    phase_times: np.ndarray       # (B, 4) seconds
    phase_energy: np.ndarray      # (B, 4) joules
    lam: np.ndarray               # (B,) dual variable (inf if infeasible)
    kkt_residual: np.ndarray      # (B,)
    feasible: np.ndarray          # (B,) bool
    e_isl: np.ndarray             # (B,) joules (constant term of eq. 11)
    t_fixed: np.ndarray           # (B,) seconds (constant term of eq. 12)
    budgets: Tuple[PassBudget, ...] = dataclasses.field(repr=False,
                                                        default=())
    costs: Tuple[SplitCosts, ...] = dataclasses.field(repr=False,
                                                      default=())

    @property
    def n(self) -> int:
        return self.phase_times.shape[0]

    @property
    def e_total(self) -> np.ndarray:
        """eq. (11) per instance, including the constant E_ISL."""
        return self.phase_energy.sum(axis=1) + self.e_isl

    @property
    def t_total(self) -> np.ndarray:
        """eq. (12) per instance, including the fixed overhead."""
        return self.phase_times.sum(axis=1) + self.t_fixed

    def report_at(self, i: int) -> SolveReport:
        names = ("sat_proc", "downlink", "gs_proc", "uplink")
        budget, costs = self.budgets[i], self.costs[i]
        phases = _build_phases(budget, costs)
        times = {nm: float(self.phase_times[i, j])
                 for j, nm in enumerate(names) if phases[j] is not None}
        alloc = _alloc_from_phase_times(budget, costs, phases, times,
                                        feasible=bool(self.feasible[i]))
        return SolveReport(alloc, float(self.lam[i]),
                           float(self.kkt_residual[i]), 0, times)


# "auto" picks the torch backend at this batch size (the reference's
# crossover for its JAX backend, ``_AUTO_MIN_JAX_BATCH``), or whenever a
# CUDA device is asked for.
_AUTO_MIN_TORCH_BATCH = 512


def _resolve_backend(backend: Optional[str], n_instances: int,
                     device=None) -> Tuple[str, Optional[str]]:
    """The user's backend choice (or "auto") as ``("numpy", None)`` or
    ``("torch", device)``. An explicit ``"torch"`` runs on ``device``,
    the card by default; "auto" runs the torch backend on the device
    asked for, else on the card where there is one."""
    if backend == "jax":
        raise ValueError(
            "backend='jax' is the reference's; the port's device solver "
            "is backend='torch' (repro_torch.core.resource_opt_torch)")
    if backend not in (None, "auto", "numpy", "torch"):
        raise ValueError(f"unknown solver backend {backend!r}; expected "
                         "'numpy', 'torch' or 'auto'")
    if backend == "numpy":
        return "numpy", None
    if backend == "torch":
        return "torch", "cuda" if device is None else device
    import torch
    if device is not None and torch.device(device).type == "cuda":
        return "torch", device
    if n_instances >= _AUTO_MIN_TORCH_BATCH:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        return "torch", device
    return "numpy", None


def _gather_coeff_arrays(blist: Sequence[PassBudget],
                         clist: Sequence[SplitCosts]) -> Dict[str, np.ndarray]:
    """Per-instance coefficient arrays, vectorized over the batch.

    Only the per-instance *scalars* (n_items and the four cost terms)
    are pulled out of the dataclasses; the scenario constants (orbit
    geometry, link budget, device DVFS constants) are computed once per
    distinct (plane, link, isl, devices) tuple — typically once per
    batch — and every coefficient is plain NumPy array math.
    """
    B = len(blist)
    n = np.fromiter((b.n_items for b in blist), np.float64, B)
    w1 = np.fromiter((c.w1_flops for c in clist), np.float64, B)
    w2 = np.fromiter((c.w2_flops for c in clist), np.float64, B)
    dtx = np.fromiter((c.dtx_bits for c in clist), np.float64, B)
    disl = np.fromiter((c.d_isl_bits for c in clist), np.float64, B)

    # scenario constants, one row per unique (plane, link, isl, devices)
    scen_idx = np.empty(B, np.int64)
    rows: Dict[Tuple, int] = {}
    consts: List[Tuple[float, ...]] = []
    for i, b in enumerate(blist):
        key = (b.plane, b.link, b.isl, b.sat_device, b.gs_device)
        j = rows.get(key)
        if j is None:
            j = rows[key] = len(consts)
            d = b.plane.mean_slant_range_m()
            sd, gd = b.sat_device, b.gs_device
            nc_s = sd.n_cores * sd.flops_per_cycle
            nc_g = gd.n_cores * gd.flops_per_cycle
            consts.append((
                b.link.channel_gain(d),
                b.link.rate_bps(b.link.max_tx_power_w, d),
                b.link.bandwidth_hz,
                sd.power_max_w / sd.f_max_hz ** 3 / nc_s ** 3,
                1.0 / (nc_s * sd.f_max_hz),
                gd.power_max_w / gd.f_max_hz ** 3 / nc_g ** 3,
                1.0 / (nc_g * gd.f_max_hz),
                b.plane.pass_duration_s,
                2.0 * b.plane.mean_prop_delay_s + b.plane.isl_prop_delay_s,
                b.isl.rate_bps,
                b.isl.tx_power_w,
            ))
        scen_idx[i] = j
    (gain, r_max, bw, ksat_c, tsat_c, kgs_c, tgs_c, pass_s, prop_s,
     isl_rate, isl_pw) = np.asarray(consts, np.float64)[scen_idx].T

    k = np.stack([ksat_c * (n * w1) ** 3, kgs_c * (n * w2) ** 3], axis=1)
    tmin_p = np.stack([tsat_c * n * w1, tgs_c * n * w2], axis=1)
    bits = n * dtx                      # one-way boundary payload
    c_comm = bits / bw
    tmin_comm = np.where(bits > 0.0, bits / r_max, 0.0)
    t_fixed = prop_s + disl / isl_rate
    return dict(
        k=k, tmin_p=tmin_p,
        cc=np.stack([c_comm, c_comm], axis=1),
        tmin_c=np.stack([tmin_comm, tmin_comm], axis=1),
        gain=gain, t_budget=pass_s - t_fixed,
        e_isl=isl_pw * disl / isl_rate, t_fixed=t_fixed)


def solve_batch(budgets: Union[PassBudget, Sequence[PassBudget]],
                costs: Union[SplitCosts, Sequence[SplitCosts]],
                tol: float = 1e-10, max_iters: int = 80,
                backend: Optional[str] = None,
                device=None) -> BatchSolveReport:
    """Solve problem (13) for B (budget, costs) instances at once.

    ``budgets`` and ``costs`` may each be a single object or a sequence;
    a single object is broadcast against the other argument.  All B
    dual bisections run simultaneously as NumPy array ops — the comm
    phases use the Lambert-W closed form instead of an inner bisection —
    so the cost is O(iterations) vector ops total, not O(B · iterations)
    Python arithmetic.

    ``backend``: ``"numpy"`` (this module), ``"torch"`` (float64 on
    ``device``, :mod:`repro_torch.core.resource_opt_torch`) or
    ``"auto"``/None (see :func:`_resolve_backend`).
    """
    blist, clist = _broadcast_instances(budgets, costs)
    B = len(blist)
    backend, device = _resolve_backend(backend, B, device)
    if backend == "torch":
        from repro_torch.core import resource_opt_torch
        return resource_opt_torch.solve_batch_torch(
            blist, clist, tol=tol, max_iters=max_iters, device=device)

    # ---- gather per-instance coefficients (cheap Python setup loop) ----
    arrs = _gather_coeff_arrays(blist, clist)
    k, tmin_p = arrs["k"], arrs["tmin_p"]
    cc, tmin_c = arrs["cc"], arrs["tmin_c"]
    gain, t_budget = arrs["gain"], arrs["t_budget"]
    e_isl, t_fixed = arrs["e_isl"], arrs["t_fixed"]

    live_p = k > 0.0
    live_c = cc > 0.0
    tmin_p = np.where(live_p, tmin_p, 0.0)
    tmin_c = np.where(live_c, tmin_c, 0.0)
    g2 = gain[:, None]

    t_min_sum = tmin_p.sum(axis=1) + tmin_c.sum(axis=1)
    any_live = live_p.any(axis=1) | live_c.any(axis=1)
    infeasible = any_live & ((t_budget <= 0.0) | (t_min_sum > t_budget))
    active = any_live & ~infeasible

    t_hi = np.maximum(t_budget, 0.0)[:, None]

    # ---- analytic λ bracket: total_time(λ) is decreasing in λ ----------
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        nd_p_lo = 2.0 * k / np.maximum(tmin_p, 1e-300) ** 3
        nd_p_hi = 2.0 * k / np.maximum(t_hi, 1e-300) ** 3
    nd_c_lo = _comm_neg_deriv_vec(cc, g2, np.maximum(tmin_c, 1e-300))
    nd_c_hi = _comm_neg_deriv_vec(cc, g2, np.maximum(t_hi, 1e-300))
    nd_lo = np.concatenate([np.where(live_p, nd_p_lo, -np.inf),
                            np.where(live_c, nd_c_lo, -np.inf)], axis=1)
    nd_hi = np.concatenate([np.where(live_p, nd_p_hi, np.inf),
                            np.where(live_c, nd_c_hi, np.inf)], axis=1)
    lam_hi = np.maximum(np.nan_to_num(nd_lo.max(axis=1), neginf=1.0,
                                      posinf=1e300), 1e-300)
    lam_lo = np.clip(np.nan_to_num(nd_hi.min(axis=1), posinf=1.0),
                     1e-300, lam_hi)

    def times_at(lam):
        l2 = lam[:, None]
        tp = np.where(live_p, _proc_t_of_lambda_vec(k, l2, tmin_p, t_hi), 0.0)
        tc = np.where(live_c,
                      _comm_t_of_lambda_vec(cc, g2, l2, tmin_c, t_hi), 0.0)
        return tp, tc

    # ---- geometric bisection on λ, all instances in lockstep -----------
    for _ in range(max_iters):
        if np.all(~active | (lam_hi <= lam_lo * (1.0 + tol))):
            break
        lam = np.sqrt(lam_lo * lam_hi)
        tp, tc = times_at(lam)
        over = (tp.sum(axis=1) + tc.sum(axis=1)) > t_budget
        lam_lo = np.where(active & over, lam, lam_lo)
        lam_hi = np.where(active & ~over, lam, lam_hi)
    lam = np.sqrt(lam_lo * lam_hi)
    tp, tc = times_at(lam)

    # ---- slack redistribution (t_min-clamped phases leave headroom) ----
    slack = t_budget - (tp.sum(axis=1) + tc.sum(axis=1))
    int_p = live_p & (tp > tmin_p * (1.0 + 1e-9))
    int_c = live_c & (tc > tmin_c * (1.0 + 1e-9))
    n_int = int_p.sum(axis=1) + int_c.sum(axis=1)
    bump = np.where(active & (slack > 1e-9 * t_budget) & (n_int > 0),
                    slack / np.maximum(n_int, 1), 0.0)[:, None]
    tp = np.where(int_p, tp + bump, tp)
    tc = np.where(int_c, tc + bump, tc)

    # ---- infeasible / no-phase instances -------------------------------
    tp = np.where(infeasible[:, None], tmin_p, tp)
    tc = np.where(infeasible[:, None], tmin_c, tc)
    tp = np.where(any_live[:, None], tp, 0.0)
    tc = np.where(any_live[:, None], tc, 0.0)

    # ---- energies at the final times -----------------------------------
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        e_p = np.where(live_p & (tp > 0.0),
                       k / np.maximum(tp, 1e-300) ** 2, 0.0)
        xc = cc * _LN2 / np.maximum(tc, 1e-300)
        e_c = np.where(live_c & (tc > 0.0),
                       tc * np.expm1(np.minimum(xc, 700.0)) / g2, 0.0)
        e_c = np.where(live_c & (xc > 700.0), np.inf, e_c)

    # ---- KKT residual: spread of marginals among interior phases -------
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        nd_p = 2.0 * k / np.maximum(tp, 1e-300) ** 3
    nd_c = _comm_neg_deriv_vec(cc, g2, np.maximum(tc, 1e-300))
    io_p = live_p & (tp > tmin_p * (1.0 + 1e-6)) & (tp < t_hi * (1.0 - 1e-6))
    io_c = live_c & (tc > tmin_c * (1.0 + 1e-6)) & (tc < t_hi * (1.0 - 1e-6))
    marg = np.concatenate([np.where(io_p, nd_p, np.nan),
                           np.where(io_c, nd_c, np.nan)], axis=1)
    n_io = io_p.sum(axis=1) + io_c.sum(axis=1)
    with np.errstate(invalid="ignore"):
        mmax = np.nanmax(np.where(n_io[:, None] >= 2, marg, 1.0), axis=1)
        mmin = np.nanmin(np.where(n_io[:, None] >= 2, marg, 1.0), axis=1)
    kkt = np.where(n_io >= 2, (mmax - mmin) / np.maximum(mmax, _EPS), 0.0)
    kkt = np.where(infeasible, np.inf, kkt)

    phase_times = np.stack([tp[:, 0], tc[:, 0], tp[:, 1], tc[:, 1]], axis=1)
    phase_energy = np.stack([e_p[:, 0], e_c[:, 0], e_p[:, 1], e_c[:, 1]],
                            axis=1)
    lam_out = np.where(infeasible, np.inf, np.where(any_live, lam, 0.0))

    return BatchSolveReport(
        phase_times=phase_times, phase_energy=phase_energy, lam=lam_out,
        kkt_residual=kkt, feasible=~infeasible, e_isl=e_isl,
        t_fixed=t_fixed, budgets=tuple(blist), costs=tuple(clist))


def solve(budget: PassBudget, costs: SplitCosts,
          tol: float = 1e-10) -> SolveReport:
    """Exact solution of problem (13) — thin wrapper over solve_batch."""
    return solve_batch(budget, costs, tol=tol).report_at(0)


# --------------------------------------------------------------------------
# Straggler mitigation: shed batch fraction until the deadline is met.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SheddingReport:
    report: SolveReport
    kept_fraction: float
    n_items_kept: float


def _broadcast_instances(budgets, costs):
    """(budget|seq, costs|seq) -> equal-length lists (shared helper)."""
    blist = [budgets] if isinstance(budgets, PassBudget) else list(budgets)
    clist = [costs] if isinstance(costs, SplitCosts) else list(costs)
    B = max(len(blist), len(clist))
    if len(blist) == 1:
        blist = blist * B
    if len(clist) == 1:
        clist = clist * B
    if len(blist) != B or len(clist) != B:
        raise ValueError(f"length mismatch: {len(blist)} budgets vs "
                         f"{len(clist)} costs")
    return blist, clist


@dataclasses.dataclass(frozen=True)
class BatchSheddingReport:
    """Vectorized shedding solution for B instances.

    ``report`` is the :class:`BatchSolveReport` solved at the *kept*
    item counts; ``at(i)`` materializes the scalar
    :class:`SheddingReport` for one instance.
    """

    report: BatchSolveReport
    kept_fraction: np.ndarray      # (B,)
    n_items_kept: np.ndarray       # (B,)

    @property
    def n(self) -> int:
        return len(self.kept_fraction)

    def at(self, i: int) -> SheddingReport:
        return SheddingReport(self.report.report_at(i),
                              float(self.kept_fraction[i]),
                              float(self.n_items_kept[i]))


def solve_with_shedding_batch(
        budgets: Union[PassBudget, Sequence[PassBudget]],
        costs: Union[SplitCosts, Sequence[SplitCosts]],
        min_fraction: float = 0.05,
        tol: float = 1e-4,
        backend: Optional[str] = None,
        device=None) -> BatchSheddingReport:
    """If (13) is infeasible, the largest batch fraction that fits, for
    B instances at once.

    Every phase's t_min scales linearly with n_items while the time
    budget does not depend on it, so feasibility at fraction f reduces
    to ``f · Σ t_min ≤ T_budget`` — the kept-fraction bisection runs in
    lockstep across all instances as array arithmetic (no inner solves),
    then ONE :func:`solve_batch` call allocates every instance at its
    kept item count.  This is the planner-scale path: a whole ring
    revolution's shedding decisions cost one batched solve.  ``backend``
    and ``device`` select that solve's implementation (see
    :func:`solve_batch`); the shedding that stays on the device is
    :func:`repro_torch.core.resource_opt_torch.shed_and_solve_coeffs`.
    """
    blist, clist = _broadcast_instances(budgets, costs)
    B = len(blist)
    _resolve_backend(backend, B, device)          # validate before work

    arrs = _gather_coeff_arrays(blist, clist)
    t_min_sum = arrs["tmin_p"].sum(axis=1) + arrs["tmin_c"].sum(axis=1)
    t_budget = arrs["t_budget"]

    # No live phase => solve() reports feasible regardless of budget.
    no_phase = t_min_sum == 0.0
    feas_full = no_phase | ((t_budget > 0.0) & (t_min_sum <= t_budget))
    feas_floor = (t_budget > 0.0) & (min_fraction * t_min_sum <= t_budget)

    frac = np.ones(B)
    frac = np.where(feas_full, 1.0, np.where(feas_floor, frac,
                                             min_fraction))
    active = ~feas_full & feas_floor
    lo = np.full(B, min_fraction)
    hi = np.ones(B)
    while np.any(active & (hi - lo > tol)):
        mid = 0.5 * (lo + hi)
        ok = mid * t_min_sum <= t_budget
        lo = np.where(active & ok, mid, lo)
        hi = np.where(active & ~ok, mid, hi)
    frac = np.where(active, lo, frac)

    scaled = [b if f == 1.0 else dataclasses.replace(b,
                                                     n_items=b.n_items * f)
              for b, f in zip(blist, frac)]
    rep = solve_batch(scaled, clist, backend=backend, device=device)
    n_kept = np.array([b.n_items for b in blist]) * frac
    return BatchSheddingReport(rep, frac, n_kept)


# --------------------------------------------------------------------------
# Split-point search (beyond-paper: the paper hand-picks ℓ).
# --------------------------------------------------------------------------

def best_split_batch(budget: PassBudget,
                     candidates: Sequence[SplitCosts],
                     backend: Optional[str] = None, device=None
                     ) -> Tuple[SplitCosts, SolveReport]:
    """Jointly pick the cut point ℓ and the allocation — one batched solve.

    All candidate cuts go through a single :func:`solve_batch` call; the
    feasible minimum-energy instance wins (ties break to the shallower
    cut, matching the scalar sweep's first-strict-minimum rule).
    """
    cands = list(candidates)
    if not cands:
        raise ValueError("no split candidates")
    rep = solve_batch(budget, cands, backend=backend, device=device)
    e = np.where(rep.feasible, rep.e_total, np.inf)
    i = int(np.argmin(e))
    if np.isfinite(e[i]):
        return cands[i], rep.report_at(i)
    # nothing feasible: fall back to max shedding on the least-bad plan —
    # one vectorized kept-fraction bisection + solve across all cuts
    shed = solve_with_shedding_batch(budget, cands, backend=backend,
                                     device=device)
    j = int(np.argmax(shed.kept_fraction))
    return cands[j], shed.at(j).report


