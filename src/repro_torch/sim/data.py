"""Batches generated on the device, inside the closed loop (the port of
``repro/sim/data.py``).

The host scheduler takes its batches from any Python callback
``data_for_sat(sat_id, batch_idx) -> batch``. The device engine calls
its provider inside the revolution with ``sat`` and ``idx`` as device
tensors, so a batch must be a pure function of (seed, sat, idx) that
never reads the host. :class:`DeviceImageryShards` is such a function:
the counterpart of the reference's ``jax.random`` provider, with the
same contract and the same recipe (per-satellite Dirichlet(0.5) class
priors, Gaussian blobs with the same width, phase and noise scale
0.05), drawn from a counter-based generator instead of ``jax.random``,
whose streams torch cannot reproduce:

* every random number is a 32-bit integer hash of (seed, sat, idx,
  element index), made into a uniform in (0, 1);
* normals come from the uniforms by Box–Muller;
* a Gamma(1/2) draw is Z²/2 for a standard normal Z, so the
  Dirichlet(0.5) prior is the normalized Z²/2 over the classes;
* labels are categorical draws by the inverse CDF of the prior.

A ``torch.Generator`` is stateful and cannot be indexed this way. The
same object serves the host engine (:meth:`batch_at` with Python ints)
and the device engine (tensors): both get the same values on one device,
which is what makes the host-vs-device parity tests exact about data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B          # < 2**27: x * _MUL < 2**59 never overflows int64


def _hash32(x):
    """A 32-bit integer hash (Mueller's xorshift-multiply) of Python ints
    or int64 tensors holding values in [0, 2**32): ten operations."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def uniforms(key, n: int, device, base=None) -> torch.Tensor:
    """``n`` float64 uniforms in (0, 1): element i is a hash of (key, i),
    so any element can be drawn without the others. ``base`` is
    ``_hash32(arange(n))``, which does not depend on the key."""
    if base is None:
        base = _hash32(torch.arange(n, dtype=torch.int64, device=device))
    h = _hash32((base + key) & _M32)
    return (h.to(torch.float64) + 0.5) * 2.0 ** -32


def box_muller(u) -> torch.Tensor:
    """Standard normals from an even number of uniforms, pairwise (both
    outputs of each pair), float64."""
    u = u.reshape(-1, 2)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0]))
    th = 2.0 * math.pi * u[:, 1]
    return torch.stack([r * torch.cos(th), r * torch.sin(th)],
                       dim=-1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class DeviceImageryShards:
    """Non-IID synthetic imagery as a pure ``(sat, idx) -> batch``.

    Returns ``{"images": (batch, img, img, channels) f32, "labels":
    (batch,) int32}`` on ``device`` (the card unless the caller asks for
    the CPU), the contract of ``ImageryShards.batch_at``, for the
    autoencoder and ResNet split adapters. ``sat`` and ``idx`` may be
    Python ints or integer tensors on ``device``.

    One batch draws all its uniforms at once: the labels, the blob
    centers, then the noise, from the key of (seed, sat, idx); the
    satellite's prior from the key of (seed, sat). The key-independent
    half of the hash (``_hash32`` of the element indices) is computed
    once per length and kept.
    """

    img: int = 32
    channels: int = 3
    n_classes: int = 10
    batch: int = 4
    seed: int = 0
    device: str = "cuda"
    _bases: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    traceable = True

    def _key(self, v, dev) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.int64).reshape(())
        return torch.full((), int(v) & _M32, dtype=torch.int64, device=dev)

    def _uniforms(self, key, n: int, dev) -> torch.Tensor:
        base = self._bases.get(n)
        if base is None:
            base = self._bases[n] = _hash32(
                torch.arange(n, dtype=torch.int64, device=dev))
        return uniforms(key, n, dev, base)

    def _prior(self, kshard, dev) -> torch.Tensor:
        z = box_muller(self._uniforms(kshard, 2 * (self.n_classes // 2 + 1),
                                      dev))[:self.n_classes]
        g = 0.5 * z * z                      # Gamma(1/2, 1) draws
        return g / g.sum()

    def _shard_key(self, sat, dev):
        return _hash32(self._key(sat, dev) ^ _hash32(self.seed & _M32))

    def prior(self, sat) -> torch.Tensor:
        """Satellite ``sat``'s class prior, a Dirichlet(0.5) draw."""
        dev = torch.device(self.device)
        return self._prior(self._shard_key(sat, dev), dev)

    def __call__(self, sat, idx) -> Dict[str, torch.Tensor]:
        dev = torch.device(self.device)
        B, n, C = self.batch, self.img, self.channels
        kshard = self._shard_key(sat, dev)
        kbatch = _hash32((kshard + _hash32(self._key(idx, dev))) & _M32)
        n_noise = B * n * n * C
        u = self._uniforms(kbatch, 3 * B + n_noise + n_noise % 2, dev)

        cdf = torch.cumsum(self._prior(kshard, dev) + 1e-9, 0)
        labels = torch.clamp(torch.searchsorted(cdf, u[:B] * cdf[-1]),
                             max=self.n_classes - 1).to(torch.int32)
        cxy = (u[B:3 * B] - 0.5).to(torch.float32).reshape(B, 2)
        xs = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=dev)
        xx, yy = torch.meshgrid(xs, xs, indexing="xy")
        sx = 0.15 + 0.04 * (labels % 5).to(torch.float32)
        d2 = ((xx - cxy[:, 0, None, None]) ** 2
              + (yy - cxy[:, 1, None, None]) ** 2)
        blob = torch.exp(-(d2 / (2.0 * sx * sx)[:, None, None]))
        phase = 2.0 * math.pi * labels.to(torch.float32) / self.n_classes
        chans = torch.arange(C, dtype=torch.float32, device=dev)
        images = blob[..., None] * torch.cos(phase[:, None, None, None]
                                             + chans)
        noise = box_muller(u[3 * B:])[:n_noise].to(torch.float32)
        images = images + 0.05 * noise.reshape(B, n, n, C)
        return {"images": images, "labels": labels}

    def meta_batch(self, sat=0, idx=0) -> Dict[str, torch.Tensor]:
        """The batch's shapes and dtypes as meta tensors (nothing is
        generated): what the engines measure the boundary payload on."""
        n = self.img
        return {"images": torch.empty((self.batch, n, n, self.channels),
                                      dtype=torch.float32, device="meta"),
                "labels": torch.empty((self.batch,), dtype=torch.int32,
                                      device="meta")}

    def batch_at(self, sat: int, idx: int) -> Dict[str, torch.Tensor]:
        """The host engine's view of the same pure function."""
        return self(sat, idx)
