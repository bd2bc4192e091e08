"""Deterministic synthetic data shards: the port's copy of
``repro/data/synthetic.py`` (``TokenShards`` and ``ImageryShards`` are
pure NumPy, so their batches are bit-identical to the reference's), and
``prefetch``, which double-buffers host batches onto the card.

The Native-SMEC setting (paper §II) has each satellite capturing a
*local, non-IID* shard: per-satellite seeded generators whose class
distributions differ by shard, so the constellation's round-robin SL
training sees genuine data heterogeneity. Everything is reproducible
from (seed, shard_id, batch_idx).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenShards:
    """Zipf-ish token streams; shard-dependent unigram tilt => non-IID."""

    vocab: int
    seq_len: int
    batch: int
    n_shards: int = 1
    seed: int = 0

    def _rng(self, shard: int, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, shard, idx]))

    def batch_at(self, shard: int, idx: int) -> Dict[str, np.ndarray]:
        rng = self._rng(shard, idx)
        # shard-tilted zipf: rank permutation differs per shard
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        perm = np.random.default_rng(
            np.random.SeedSequence([self.seed, shard])).permutation(self.vocab)
        p = p[np.argsort(perm)]
        p /= p.sum()
        toks = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1),
                          p=p).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, shard: int = 0, start: int = 0) -> Iterator[Dict]:
        idx = start
        while True:
            yield self.batch_at(shard, idx)
            idx += 1


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

    def iterate(self, shard: int = 0, start: int = 0) -> Iterator[Dict]:
        idx = start
        while True:
            yield self.batch_at(shard, idx)
            idx += 1


def prefetch(it: Iterator[Dict], size: int = 2, sharding=None,
             device="cuda") -> Iterator[Dict]:
    """Double-buffer host batches onto ``device`` ahead of compute, in
    order: each array is copied into pinned host memory and then to the
    card with a ``non_blocking`` copy on the current stream, ``size``
    batches ahead; a finite iterator's batches all come out (the
    reference's loop drops the one it holds when the iterator ends). The
    reference's ``sharding`` (a ``jax.sharding`` placement) is not
    ported: it must be None."""
    if sharding is not None:
        raise ValueError("prefetch(sharding=...) is not ported: one device")
    dev = resolve_device(device)

    def put(b):
        out = {}
        for k, a in b.items():
            t = torch.as_tensor(np.ascontiguousarray(a))
            out[k] = (t.pin_memory().to(dev, non_blocking=True)
                      if dev.type == "cuda" else t.to(dev))
        return out

    buf = collections.deque()
    for b in it:
        buf.append(put(b))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
