"""Continuous-batching greedy decode over the LM's KV cache (the port of
``repro/serve/engine.py``).

Slots hold independent requests; finished slots are refilled from the
queue without stopping the batch. Prefill is BULK by default: the prompt
runs through ``forward`` in prefill mode, its cache is converted with
``cache_from_prefill`` and spliced into the slot's batch row. The
token-by-token loop (``prefill="loop"``) is kept as the parity reference.

On a CUDA device every attention call goes through the hand-written
kernels (prefill: ``flash_attn_fwd``, decode: ``decode_attn``), on the
CPU through their plain versions; Mamba-2 prefill goes through the
chunked-scan kernel (``mamba_scan``), its decode step through plain
PyTorch as in the reference. xLSTM's mLSTM prefill goes through the
mLSTM chunkwise-scan kernel (``mlstm_scan``); its decode step and the
sLSTM recurrence are plain PyTorch, as in the reference. The engine
casts the matmul weights to the activation dtype once at construction.
The reference casts them inside each matmul, which gives the same
values; the leaves the reference reads in f32 stay f32 (``F32_LEAVES``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import Ctx


# Leaves the reference reads with ``.astype(float32)``: rounding them to
# the activation dtype first would change what the model computes. A
# name matches that leaf in any block; a (block, name) pair only inside
# that block's sub-tree (sLSTM's recurrence is all f32, but a ``bias``
# elsewhere is not).
F32_LEAVES = ("scale", "conv_w", "dt_bias", "a_log", "b_if",
              ("slstm", "w_x"), ("slstm", "w_h"), ("slstm", "bias"))


def _cast_matmul_weights(tree, act_dtype, device, path=()):
    """``tree`` on ``device`` with every weight in ``act_dtype`` except
    the leaves named in ``F32_LEAVES``, which stay f32."""
    if isinstance(tree, dict):
        return {k: _cast_matmul_weights(v, act_dtype, device, path + (k,))
                for k, v in tree.items()}
    f32 = path[-1] in F32_LEAVES or path[-2:] in F32_LEAVES
    return tree.to(device, torch.float32 if f32 else act_dtype)


def _splice(full, one, slot: int):
    """Write the batch-1 cache ``one`` into batch row ``slot`` of
    ``full``, leaf by leaf (every leaf is (n_units, batch, ...)), cast to
    the destination's dtype."""
    if isinstance(full, dict):
        for k in full:
            _splice(full[k], one[k], slot)
    elif isinstance(full, tuple):
        for f, o in zip(full, one):
            _splice(f, o, slot)
    else:
        full[:, slot] = one[:, 0].to(full.dtype)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class DecodeEngine:
    """Greedy decoding over ``n_slots`` concurrent requests on ``device``.
    ``use_pallas`` (the reference's TPU-kernel switch) is accepted and
    ignored: the card always takes the Hopper kernels. An enc-dec config
    (Whisper) is refused: its requests carry encoder frames that a
    prompt of tokens has not, and the reference serves it only through
    ``lm.forward(mode="prefill")`` + ``lm.decode_step``."""

    def __init__(self, cfg, params, *, n_slots: int = 4, s_max: int = 512,
                 act_dtype=torch.bfloat16, use_pallas: bool = False,
                 prefill: str = "bulk", device="cuda"):
        if cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: the serving engines do not cover enc-dec "
                f"(whisper) architectures; serve it with lm.forward(mode="
                f"'prefill', enc_frames=...), lm.cache_from_prefill and "
                f"lm.decode_step")
        if prefill not in ("bulk", "loop"):
            raise ValueError(f"prefill must be 'bulk' or 'loop', "
                             f"got {prefill!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _cast_matmul_weights(params, act_dtype, self.device)
        self.n_slots = n_slots
        self.s_max = s_max
        self.act_dtype = act_dtype
        self.prefill_mode = prefill
        self.ctx = Ctx(cfg=cfg, mode="decode", act_dtype=act_dtype)
        self.cache = lm.init_cache(cfg, n_slots, s_max, act_dtype,
                                   self.device)
        self.positions = np.zeros((n_slots,), np.int32)
        self.budget = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.live: List[Optional[Request]] = [None] * n_slots

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    # --------------------------------------------------------------- model
    def _decode_fn(self, tokens, positions):
        """One batched decode step -> logits (B, 1, V); updates the cache
        in place. Subclasses (the split-serving engine) override this to
        change the model path while keeping all slot mechanics."""
        logits, _ = lm.decode_step(self.cfg, self.params, self.cache, tokens,
                                   positions, ctx=self.ctx)
        return logits

    @torch.no_grad()
    def _step(self, tokens, positions) -> np.ndarray:
        logits = self._decode_fn(self._tensor(tokens), self._tensor(positions))
        return logits[:, 0, :].argmax(dim=-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, prompt):
        """Bulk prefill of one prompt -> (next_token, decode cache of
        batch 1)."""
        pctx = dataclasses.replace(self.ctx, mode="prefill")
        logits, _, caches = lm.forward(self.cfg, self.params,
                                       self._tensor(prompt)[None, :], ctx=pctx)
        cache1 = lm.cache_from_prefill(self.cfg, caches, self.s_max,
                                       self.act_dtype)
        return int(logits[0, -1].argmax()), cache1

    # ---------------------------------------------------------------- slots
    def _prefill_into_slot(self, slot: int, req: Request):
        req.out_tokens = []
        self.live[slot] = req
        self.budget[slot] = req.max_new_tokens
        if self.prefill_mode == "loop":
            self._prefill_into_slot_loop(slot, req)
            return
        nxt, cache1 = self._prefill(req.prompt)
        _splice(self.cache, cache1, slot)
        self.positions[slot] = len(req.prompt)
        self.last_tok[slot] = nxt

    def _prefill_into_slot_loop(self, slot: int, req: Request):
        """Token-by-token prefill, the parity reference only: one
        full-batch decode step per prompt token, pushing a zero token
        through every other live slot. Its attention row is overwritten
        at that slot's next real write, but its recurrent (mamba) state
        advances, and a refilled slot starts from its last request's
        state. On Zamba2 it is the reference's loop, not a prefill."""
        pos = 0
        for t in req.prompt:
            toks = np.zeros((self.n_slots, 1), np.int32)
            toks[slot, 0] = int(t)
            posv = self.positions.copy()
            posv[slot] = pos
            nxt = self._step(toks, posv)
            pos += 1
        self.positions[slot] = pos
        self.last_tok[slot] = int(nxt[slot])

    # ------------------------------------------------------------------ run
    def submit_and_run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests to completion; returns rid -> generated ids.

        Requests are served FIFO (slot refill order = submission order).
        ``max_new_tokens <= 0`` completes immediately with ``[]``; a
        prompt of length >= ``s_max`` cannot fit the cache alongside a
        generated token and raises ``ValueError`` up front.
        """
        done: Dict[int, List[int]] = {}
        queue: List[Request] = []
        for req in requests:
            if len(req.prompt) >= self.s_max:
                raise ValueError(
                    f"request {req.rid}: prompt length {len(req.prompt)} "
                    f">= s_max={self.s_max} (no cache room to decode)")
            if req.max_new_tokens <= 0:
                req.out_tokens = []
                done[req.rid] = req.out_tokens
            else:
                queue.append(req)

        for slot in range(self.n_slots):
            if queue:
                self._prefill_into_slot(slot, queue.pop(0))

        while any(r is not None for r in self.live):
            toks = self.last_tok.reshape(-1, 1).astype(np.int32)
            nxt = self._step(toks, self.positions)
            for slot, req in enumerate(self.live):
                if req is None:
                    continue
                req.out_tokens.append(int(toks[slot, 0]))
                self.positions[slot] += 1
                self.budget[slot] -= 1
                self.last_tok[slot] = int(nxt[slot])
                if self.budget[slot] <= 0 or \
                        self.positions[slot] >= self.s_max - 1:
                    done[req.rid] = req.out_tokens
                    self.live[slot] = None
                    if queue:                    # continuous batching refill
                        self._prefill_into_slot(slot, queue.pop(0))
        return done
