"""Split-model serving (the port of the decode half of
``repro/serve_fleet/engine.py``).

:class:`SplitDecodeEngine` runs continuous-batching greedy decode with
the model cut at a unit boundary: the satellite half (embedding + units
``[0, cut)``) runs per-token decode and the boundary activation
``(B, 1, d_model)`` crosses the downlink every generated token; the
ground half (units ``[cut, U)``, final norm, head) finishes the step.
Slot mechanics and bulk prefill are inherited from
:class:`repro_torch.serve.engine.DecodeEngine`; only the decode body
changes.

The serving cost model (:class:`ServeCost`, :func:`serve_cost`,
:class:`TrainLoad`) prices a generated token in the satellite's joules.
The fleet-scale serving scan is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.energy import PassBudget
from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.utils.treeutil import tree_leaves


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


# --------------------------------------------------------------------------
# Serving cost model (per generated token, satellite side).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeCost:
    """What one generated token costs the serving satellite.

    ``tokens_per_s`` is the measured (or assumed) sustained decode rate
    of one satellite, which caps each pass window's service;
    ``e_token_j`` is the battery draw per token (eq.-(7) DVFS compute
    of the satellite half + eq.-(9) downlink energy of the boundary
    activation); ``dtx_bits_token`` is that boundary payload.
    """

    tokens_per_s: float
    e_token_j: float
    dtx_bits_token: float

    def window_capacity_requests(self, window_s: float,
                                 tokens_per_request: float) -> float:
        """Whole requests one pass window can serve (the reference's f32
        floor)."""
        toks = np.float32(self.tokens_per_s) * np.float32(window_s)
        return float(np.floor(toks / np.float32(tokens_per_request)))


def serve_cost(cfg, params, cut_units: int, *, tokens_per_s: float,
               budget: Optional[PassBudget] = None,
               tx_power_w: float = 2.0,
               act_bits: Optional[int] = None) -> ServeCost:
    """Analytic per-token satellite cost of the split model.

    The satellite half's decode FLOPs per token are ``2 x`` its unit
    parameter count (``units`` plus Zamba2's ``shared`` block; the
    embedding gather is free); compute energy follows the paper's DVFS
    model at ``f_max``, downlink energy the Shannon link at
    ``tx_power_w`` over the mean slant range.
    """
    budget = PassBudget() if budget is None else budget
    pa, _ = lm.split_serve_params(cfg, params, cut_units)
    n_params = sum(t.numel() for t in tree_leaves(pa["units"]))
    if "shared" in pa:
        n_params += sum(t.numel() for t in tree_leaves(pa["shared"]))
    flops_tok = 2.0 * n_params
    e_proc = budget.sat_device.proc_energy_j(
        flops_tok, budget.sat_device.f_max_hz, 1.0)
    bits = float(cfg.d_model * (32 if act_bits is None else act_bits))
    e_comm = budget.link.comm_energy_j(bits, tx_power_w,
                                       budget.mean_distance_m)
    return ServeCost(tokens_per_s=float(tokens_per_s),
                     e_token_j=float(e_proc + e_comm),
                     dtx_bits_token=bits)


@dataclasses.dataclass(frozen=True)
class TrainLoad:
    """One planned training pass per serving window, energy only: the
    drain the planner priced for the training fleet."""

    drain_j: float       # satellite-side battery draw per training pass
    e_total_j: float     # full eq.-(11) cost recorded per pass

    @classmethod
    def from_plan(cls, plan) -> "TrainLoad":
        """Mean per-satellite load of a ``DevicePassPlan`` (or anything
        with ``drain_j`` / ``e_total_j`` tensors or arrays)."""
        mean = lambda a: float(np.mean(a.cpu().numpy()  # noqa: E731
                                       if isinstance(a, torch.Tensor)
                                       else np.asarray(a)))
        return cls(drain_j=mean(plan.drain_j), e_total_j=mean(plan.e_total_j))
