"""Split-model serving (the port of the decode half of
``repro/serve_fleet/engine.py``).

:class:`SplitDecodeEngine` runs continuous-batching greedy decode with
the model cut at a unit boundary: the satellite half (embedding + units
``[0, cut)``) runs per-token decode and the boundary activation
``(B, 1, d_model)`` crosses the downlink every generated token; the
ground half (units ``[cut, U)``, final norm, head) finishes the step.
Slot mechanics and bulk prefill are inherited from
:class:`repro_torch.serve.engine.DecodeEngine`; only the decode body
changes. The fleet-scale serving scan is not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request


class SplitDecodeEngine(DecodeEngine):
    """Greedy decode of the split model; token-identical to the unsplit
    :class:`DecodeEngine` (the same blocks run in the same order)."""

    def __init__(self, cfg, params, *, cut_units: int, **kw):
        self.cut_units = int(cut_units)
        lm.split_serve_params(cfg, params, self.cut_units)   # validate early
        super().__init__(cfg, params, **kw)
        self.params_sat, self.params_gnd = lm.split_serve_params(
            cfg, self.params, self.cut_units)

    def _decode_fn(self, tokens, positions):
        logits, _, _boundary = lm.decode_step_split(
            self.cfg, self.params_sat, self.params_gnd, self.cache, tokens,
            positions, ctx=self.ctx)
        return logits

    @property
    def boundary_bits_per_token(self) -> float:
        """Downlink payload per generated token per request: the boundary
        activation ``(d_model,)`` at the engine's activation dtype."""
        return float(self.cfg.d_model * self.act_dtype.itemsize * 8)


def measure_decode_rate(engine: DecodeEngine, *, n_requests: int = 32,
                        prompt_len: int = 6, new_tokens: int = 12,
                        vocab: Optional[int] = None, seed: int = 0,
                        warmup: bool = True) -> float:
    """Sustained generated-tokens/sec of one engine, wall clock over a
    continuous-batching run (prefill included), synchronized with the
    device at both ends."""
    vocab = engine.cfg.vocab if vocab is None else vocab
    rng = np.random.default_rng(seed)

    def batch(n, rid0):
        return [Request(rid=rid0 + i,
                        prompt=rng.integers(0, vocab, prompt_len)
                        .astype(np.int32),
                        max_new_tokens=new_tokens) for i in range(n)]

    if warmup:                      # first kernel launches build and load
        engine.submit_and_run(batch(min(2, n_requests), 10_000_000))
    reqs = batch(n_requests, 0)
    _sync(engine.device)
    t0 = time.perf_counter()
    out = engine.submit_and_run(reqs)
    _sync(engine.device)
    dt = time.perf_counter() - t0
    return sum(len(v) for v in out.values()) / dt


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
