"""Deterministic synthetic data shards: the port's copy of
``repro/data/synthetic.py::ImageryShards`` (pure NumPy, so its batches
are bit-identical to the reference's).

The Native-SMEC setting (paper §II) has each satellite capturing a
*local, non-IID* shard: per-satellite seeded generators whose class
distributions differ by shard, so the constellation's round-robin SL
training sees genuine data heterogeneity. Everything is reproducible
from (seed, shard_id, batch_idx).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageryShards:
    """Synthetic "satellite imagery": gaussian blobs + per-shard class
    prior tilt (non-IID across the orbital ring)."""

    img: int = 224
    channels: int = 3
    n_classes: int = 10
    batch: int = 16
    n_shards: int = 25
    seed: int = 0

    def _class_prior(self, shard: int) -> np.ndarray:
        g = np.random.default_rng(np.random.SeedSequence([self.seed, shard]))
        alpha = g.dirichlet(np.full(self.n_classes, 0.5))
        return alpha

    def batch_at(self, shard: int, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, shard, idx]))
        labels = rng.choice(self.n_classes, size=self.batch,
                            p=self._class_prior(shard)).astype(np.int32)
        xs = np.linspace(-1, 1, self.img, dtype=np.float32)
        xx, yy = np.meshgrid(xs, xs)
        imgs = np.empty((self.batch, self.img, self.img, self.channels),
                        np.float32)
        for i, lab in enumerate(labels):
            g = np.random.default_rng(
                np.random.SeedSequence([self.seed, shard, idx, i]))
            cx, cy = g.uniform(-0.5, 0.5, 2)
            sx = 0.15 + 0.04 * (lab % 5)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sx ** 2)))
            phase = 2 * math.pi * lab / self.n_classes
            for c in range(self.channels):
                imgs[i, :, :, c] = blob * math.cos(phase + c) \
                    + 0.05 * g.standard_normal((self.img, self.img))
        return {"images": imgs, "labels": labels}

