"""Seeded synthetic ground traffic for the serving fleet (the port of
``repro/serve_fleet/traffic.py``).

Millions of users hitting a ground terminal are modeled as Poisson
request arrivals with a diurnal (24 h sinusoid) intensity profile,
realized PER PASS WINDOW: window ``k`` of plane ``p`` receives
``Poisson(lam_p(k))`` requests, where ``lam_p(k)`` follows the daily
cycle at the window's wall-clock time. The load is given in users/day
with a per-user daily request rate; the fleet splits it evenly across
its planes (one ground terminal per plane, each seeing whichever
satellite of its plane is overhead).

A draw is a pure function of ``(seed, plane, window)``: the Poisson
count comes from ``np.random.default_rng((seed, plane, k))`` and a
window's prompts from ``default_rng((seed, plane, k, 0xB0B))``, so
chained runs continue one stream. The reference draws from
``jax.random``, whose streams NumPy cannot reproduce: the port's counts
have the reference's distribution, not its values (tests that compare
the two engines hand the port the reference's realized arrivals). The
intensity :meth:`PassWindowTraffic.rate` is the reference's f32
arithmetic in its order of operations.

:meth:`PassWindowTraffic.realize` returns the counts as a host array:
the serving fleet copies it to the device once per run and its NumPy
oracle replays the same array, so both consume the same draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

#: stream tag of a window's prompt draws (the reference's)
PROMPT_TAG = 0xB0B


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Offered load: ``users_per_day`` users, each issuing
    ``requests_per_user_day`` requests/day on average, with requests of
    ``prompt_len`` prompt tokens decoding ``decode_len`` new tokens."""

    users_per_day: float = 1.0e6
    requests_per_user_day: float = 1.0
    prompt_len: int = 8
    decode_len: int = 16
    diurnal_amp: float = 0.5        # peak deviation from the mean rate
    peak_utc_s: float = 43_200.0    # daily peak (noon by default)
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.diurnal_amp <= 1.0:
            raise ValueError(f"diurnal_amp must be in [0, 1], "
                             f"got {self.diurnal_amp}")

    @property
    def tokens_per_request(self) -> float:
        return float(self.decode_len)

    def mean_rate_per_s(self, n_planes: int = 1) -> float:
        """Mean fleet arrival rate split over ``n_planes`` terminals."""
        return (self.users_per_day * self.requests_per_user_day
                / 86_400.0 / n_planes)


@dataclasses.dataclass(frozen=True)
class PassWindowTraffic:
    """``(plane, k) -> arrival count`` for pass window ``k``.

    ``window_s`` is the pass-window duration (the plane's
    ``pass_duration_s``); ``n_planes`` divides the configured offered
    load across terminals.
    """

    cfg: TrafficConfig = TrafficConfig()
    window_s: float = 228.0
    n_planes: int = 1

    # ------------------------------------------------------------- intensity
    def rate(self, k):
        """Mean arrivals in window ``k`` (an int or an integer array), in
        f32: ``base * (1 + amp * cos(2 pi (t - peak) / 86400))`` at the
        window's midpoint ``t = (k + 0.5) * window_s``, each operation
        rounded to f32 as the reference's. The cosine is taken in f64 and
        rounded once to f32: that agrees with XLA's f32 cosine in ~99% of
        windows, NumPy's f32 cosine in ~84%."""
        c = self.cfg
        f32 = np.float32
        base = f32(c.mean_rate_per_s(self.n_planes) * self.window_s)
        t = (np.asarray(k, f32) + f32(0.5)) * f32(self.window_s)
        day = f32(2.0 * math.pi) * (t - f32(c.peak_utc_s)) / f32(86_400.0)
        cos = np.cos(day.astype(np.float64)).astype(f32)
        return base * (f32(1.0) + f32(c.diurnal_amp) * cos)

    # -------------------------------------------------------------- arrivals
    def __call__(self, plane, k) -> np.int32:
        """Poisson arrival count for ``(plane, window k)``."""
        rng = np.random.default_rng((self.cfg.seed, int(plane), int(k)))
        return np.int32(rng.poisson(float(self.rate(k))))

    def realize(self, n_windows: int, start: int = 0) -> np.ndarray:
        """Arrival counts for windows ``[start, start + n_windows)`` of
        every plane, a ``(n_planes, n_windows)`` int32 array: the serving
        fleet's traffic, which the engine and the oracle both consume."""
        ks = range(start, start + n_windows)
        return np.array([[self(p, k) for k in ks]
                         for p in range(self.n_planes)],
                        np.int32).reshape(self.n_planes, n_windows)

    # --------------------------------------------------------------- prompts
    def prompts(self, plane: int, k: int, n: int, vocab: int) -> np.ndarray:
        """``(n, prompt_len)`` int32 prompt batch for window ``k``, from
        the window's own stream (tagged ``PROMPT_TAG``)."""
        rng = np.random.default_rng((self.cfg.seed, int(plane), int(k),
                                     PROMPT_TAG))
        return rng.integers(0, vocab, (n, self.cfg.prompt_len),
                            dtype=np.int32)
