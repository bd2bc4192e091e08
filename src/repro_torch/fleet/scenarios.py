"""Degraded-operations scenarios of the fleet engine (the port of the
baseline part of ``repro/fleet/scenarios.py``).

* **Eclipse windows** (:class:`EclipseConfig`): periodic shadow intervals
  per plane. ``sunlit(k, plane)`` is modular arithmetic on the pass index,
  on Python ints and on tensors alike, so the host engine and the fleet
  engine gate solar recharge with the same expression, at any pass index.
  An eclipsed pass harvests nothing, which is how shadow reaches the
  reserve-skip policy.
* **Robust inter-plane aggregation** (:func:`aggregate_planes`):
  coordinate-wise ``mean`` (the default, the reference's parity mode),
  ``median`` or ``trimmed_mean`` over the planes' state trees.
* **Byzantine satellites** (:class:`ByzantineConfig`) and **epidemic
  faults** (:class:`EpidemicConfig`) are ported as data: the fleet engine
  refuses a scenario that sets either, since their dynamics
  (``epidemic_step``, the corrupted pass update, ``oracle_actions``) are
  the next slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.train_state import _leaves, _rebuild

#: entropy tag appended to the run seed, so the epidemic streams never
#: collide with the membership and failure streams of the same seed
_EPIDEMIC_TAG = 0xEC1D

#: the modes of :func:`aggregate_planes` (and ``FleetConfig.aggregate``)
AGGREGATION_MODES = ("mean", "median", "trimmed_mean")


@dataclasses.dataclass(frozen=True)
class EclipseConfig:
    """Periodic orbital shadow windows, per plane.

    Pass ``k`` of plane ``p`` is in eclipse iff ``(k + phase + p *
    stagger) % period < round(duty * period)``: the shadow opens each
    ``period``-pass cycle. ``stagger`` offsets the planes against each
    other; ``duty`` is the shadowed fraction of a cycle (1: recharge
    never fires).
    """

    period: int                 # eclipse cycle length, in passes
    duty: float                 # fraction of the cycle spent in shadow
    stagger: int = 0            # per-plane phase offset, in passes
    phase: int = 0              # global phase offset, in passes

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"eclipse period must be >= 1, got {self.period}")
        if not 0.0 <= self.duty <= 1.0:
            raise ValueError(f"eclipse duty must be in [0, 1], got {self.duty}")

    @property
    def eclipse_passes(self) -> int:
        return int(round(self.duty * self.period))

    def sunlit(self, k, plane=0):
        """Is plane ``plane`` in sunlight at pass ``k``? ``k`` and
        ``plane`` may be Python ints, NumPy arrays or integer tensors (the
        fleet engine passes its ``(P,)`` plane ids)."""
        pos = (k + self.phase + plane * self.stagger) % self.period
        return pos >= self.eclipse_passes


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Which slots lie, and how (``"sign_flip"``: the pass update Δ
    becomes -scale·Δ; ``"scaled_noise"``: scale·N(0, 1) is added to every
    float parameter). ``planes`` marks whole planes, ``slots`` single
    ``plane -> [slot, ...]`` entries. Data only in this port: the fleet
    engine refuses it."""

    planes: Tuple[int, ...] = ()
    slots: Mapping[int, Sequence[int]] = dataclasses.field(
        default_factory=dict)
    mode: str = "sign_flip"
    scale: float = 1.0

    def __post_init__(self):
        if self.mode not in ("sign_flip", "scaled_noise"):
            raise ValueError(f"unknown Byzantine mode {self.mode!r}; "
                             "expected 'sign_flip' or 'scaled_noise'")

    def mask(self, n_planes: int, n_slots: int) -> np.ndarray:
        """The static ``(P, M)`` corruption mask."""
        byz = np.zeros((n_planes, n_slots), bool)
        for p in self.planes:
            byz[int(p) % n_planes, :] = True
        for p, ms in self.slots.items():
            for m in ([ms] if isinstance(ms, (int, np.integer)) else ms):
                byz[int(p) % n_planes, int(m) % n_slots] = True
        return byz


@dataclasses.dataclass(frozen=True)
class EpidemicConfig:
    """Transient faults spreading along the slot ring: at pass ``start``
    the ``init_slots`` of every plane fault for ``ttl`` passes, and each
    pass a healthy neighbour of a faulted slot catches it with
    probability ``beta``. Data only in this port: the fleet engine
    refuses it."""

    beta: float = 0.3
    ttl: int = 3
    init_slots: Tuple[int, ...] = (0,)
    start: int = 0

    def __post_init__(self):
        if not 0.0 <= self.beta <= 1.0:
            raise ValueError(f"beta must be in [0, 1], got {self.beta}")
        if self.ttl < 1:
            raise ValueError(f"ttl must be >= 1, got {self.ttl}")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Any subset of the three stressors."""

    eclipse: Optional[EclipseConfig] = None
    byzantine: Optional[ByzantineConfig] = None
    epidemic: Optional[EpidemicConfig] = None

    @property
    def degraded(self) -> bool:
        return (self.eclipse is not None or self.byzantine is not None
                or self.epidemic is not None)


class ScenarioSchedule(NamedTuple):
    """The scenario's draws for one horizon, made on the host:
    ``spread_draw[p, k, m]`` the epidemic's Bernoulli draws (per-plane
    streams of ``np.random.SeedSequence([seed, tag])``; ``(P, 1, M)``
    all False without an epidemic), ``byz_mask[p, m]`` the Byzantine
    mask, ``init_mask[m]`` the epidemic's first slots."""

    spread_draw: np.ndarray       # (P, K, M) bool
    byz_mask: np.ndarray          # (P, M) bool
    init_mask: np.ndarray         # (M,) bool


def build_scenario_schedule(scn: Optional[ScenarioConfig], n_planes: int,
                            n_slots: int, n_passes: int,
                            seed: int = 0) -> ScenarioSchedule:
    """Precompute the scenario's host-side draws for ``n_passes``."""
    P, M, K = int(n_planes), int(n_slots), int(n_passes)
    byz = np.zeros((P, M), bool)
    init = np.zeros((M,), bool)
    spread = np.zeros((P, 1, M), bool)
    if scn is not None:
        if scn.byzantine is not None:
            byz = scn.byzantine.mask(P, M)
        if scn.epidemic is not None:
            ep = scn.epidemic
            for m in ep.init_slots:
                init[int(m) % M] = True
            streams = np.random.SeedSequence(
                [int(seed), _EPIDEMIC_TAG]).spawn(P)
            spread = np.stack([
                np.random.default_rng(s).random((K, M)) < ep.beta
                for s in streams])
    return ScenarioSchedule(spread_draw=spread, byz_mask=byz,
                            init_mask=init)


def plane_center(x: torch.Tensor, mode: str = "mean",
                 trim: int = 1) -> torch.Tensor:
    """The coordinate-wise center of ``x`` over its leading plane axis
    (the axis is dropped): the mean, the median (the mean of the two
    middle values for an even count, as ``jnp.median``) or the mean
    with the ``trim`` largest and smallest values of each coordinate
    left out."""
    if mode not in AGGREGATION_MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}; expected "
                         f"one of {AGGREGATION_MODES}")
    P = x.shape[0]
    if mode == "mean":
        return x.mean(dim=0)
    s = torch.sort(x, dim=0).values
    if mode == "median":
        if P % 2:
            return s[P // 2]
        return (s[P // 2 - 1] + s[P // 2]) / 2
    if P <= 2 * trim:
        raise ValueError(f"trimmed_mean(trim={trim}) needs more than "
                         f"{2 * trim} planes, got {P}")
    return s[trim:P - trim].mean(dim=0)


def aggregate_planes(trees: Sequence, mode: str = "mean",
                     trim: int = 1) -> List:
    """Inter-plane aggregation over a list of P per-plane trees (dicts,
    tuples and NamedTuples of tensors, one structure): every floating
    leaf becomes its coordinate-wise :func:`plane_center` over the
    planes, in every plane's tree (its own copy); integer leaves (step
    counters) stay per plane. Modes: ``"mean"`` (the parity default),
    ``"median"`` (robust to fewer than P/2 corrupted planes),
    ``"trimmed_mean"`` (needs P > 2·trim)."""
    if mode not in AGGREGATION_MODES:
        raise ValueError(f"unknown aggregation mode {mode!r}; expected "
                         f"one of {AGGREGATION_MODES}")
    out = [[] for _ in trees]
    for col in zip(*[_leaves(t) for t in trees]):
        if col[0].is_floating_point():
            c = plane_center(torch.stack(col), mode, trim)
            for o in out:
                o.append(c.clone())
        else:
            for o, x in zip(out, col):
                o.append(x)
    return [_rebuild(t, iter(o)) for t, o in zip(trees, out)]
