"""The LM train step and the serving steps (the port of
``repro/train/step.py``).

``make_train_step`` returns the reference's 4-tuple, ``(train_step,
None, None, init_state)``: ``train_step(state, batch) -> (state,
metrics)`` takes loss and gradients (``lm.loss`` under the configured
remat), optionally compresses the gradients with error feedback
(``train.compression``: int8 runs on kernel B1 on the card), clips them
to a global norm and applies AdamW. The state is updated in place, as
the reference's jitted step donates it.

Not ported: pjit and buffer donation, ``ShardingRules``,
``partition_specs``, ``adamw_state_specs``, ``zero_partition_specs``
and ``cache_shardings`` (the reference's multi-device placement; the
port trains on one card). The ``mesh``/``rules`` arguments and
``TrainConfig``'s TPU fields (``use_pallas``, ``block_q``, ``block_k``,
``scan_unroll``, ``attn_compute_dtype``) are accepted and ignored, as
:class:`repro_torch.models.layers.Ctx` ignores them; ``moe_dispatch``
picks the MoE layout (``global`` or ``batch_local``).
``make_prefill_step`` and ``make_decode_step`` are thin wrappers over
``lm.forward`` and ``lm.decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import map_tree
from repro_torch.train import compression
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update)
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    remat: str = "full"                  # none | dots | full
    compression: str = "none"            # none | topk | int8
    topk_ratio: float = 0.01
    act_dtype: Any = torch.bfloat16
    aux_weight: float = 0.01
    use_pallas: Optional[bool] = False
    block_q: int = 512
    block_k: int = 512
    scan_unroll: int = 1
    attn_compute_dtype: Any = torch.float32
    mamba_chunk: int = 128
    mlstm_chunk: int = 256
    moe_dispatch: str = "global"


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any                              # error-feedback residuals or None


def loss_and_grads(cfg, tcfg: TrainConfig, params, batch):
    """(loss, metrics {"ce", "aux", "ntok"}, grads shaped like ``params``)
    of ``lm.loss`` on ``batch`` (a dict of tensors on the params' device),
    in the block context ``tcfg`` sets, as the reference's step builds it."""
    ctx = Ctx(cfg=cfg, mode="train", act_dtype=tcfg.act_dtype,
              use_pallas=tcfg.use_pallas, block_q=tcfg.block_q,
              block_k=tcfg.block_k,
              attn_compute_dtype=tcfg.attn_compute_dtype,
              mamba_chunk=tcfg.mamba_chunk, mlstm_chunk=tcfg.mlstm_chunk,
              moe_dispatch=tcfg.moe_dispatch)
    p = map_tree(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        lv, metrics = lm.loss(cfg, p, batch["tokens"], batch["labels"],
                              ctx=ctx,
                              frontend_embed=batch.get("frontend_embed"),
                              enc_frames=batch.get("enc_frames"),
                              remat=tcfg.remat, aux_weight=tcfg.aux_weight,
                              unroll=tcfg.scan_unroll)
        grads = torch.autograd.grad(lv, tree_leaves(p))
    return lv.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg, mesh=None, rules=None,
                    tcfg: TrainConfig = TrainConfig(), *, device="cuda"):
    """Returns (train_step, None, None, init_state).

    ``train_step(state, batch) -> (state, metrics)``; ``batch`` is a dict
    of ``tokens``/``labels`` (NumPy arrays or tensors). The state's
    tensors are updated in place and returned. ``init_state(seed)``
    draws the weights from ``torch.Generator(device).manual_seed(seed)``
    (or from a given generator).
    """
    dev = resolve_device(device)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        lv, metrics, grads = loss_and_grads(cfg, tcfg, state.params, batch)
        ef = state.ef
        if tcfg.compression != "none":
            grads, ef_state, cm = compression.compress(
                grads, compression.ErrorFeedbackState(ef),
                scheme=tcfg.compression, topk_ratio=tcfg.topk_ratio)
            ef = ef_state.residual
            metrics.update(cm)
        with torch.no_grad():
            params, opt, om = adamw_update(tcfg.adamw, grads, state.opt,
                                           state.params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = lv
        return TrainState(params, opt, ef), metrics

    def init_state(seed=0) -> TrainState:
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(seed)))
        params = lm.init(cfg, gen)
        ef = (compression.ef_init(params).residual
              if tcfg.compression != "none" else None)
        return TrainState(params, adamw_init(params), ef)

    return train_step, None, None, init_state


# --------------------------------------------------------------------------
# Serving steps.
# --------------------------------------------------------------------------

def make_prefill_step(cfg, mesh=None, rules=None, act_dtype=torch.bfloat16,
                      use_pallas=False, block_q: int = 512,
                      block_k: int = 512, unroll: int = 1):
    """Returns (prefill_step, None); ``prefill_step(params, batch) ->
    (logits of the last position, caches)``."""
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=act_dtype)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, cache = lm.forward(
            cfg, params, batch["tokens"], ctx=ctx,
            frontend_embed=batch.get("frontend_embed"),
            enc_frames=batch.get("enc_frames"), remat="none")
        return logits[:, -1:], cache

    return prefill_step, None


def make_decode_step(cfg, mesh=None, rules=None, batch: Optional[int] = None,
                     s_max: Optional[int] = None, act_dtype=torch.bfloat16,
                     use_pallas=False, unroll: int = 1, *, device="cuda"):
    """Returns (serve_step, None, None, cache): ``serve_step(params,
    cache, tokens, positions) -> (logits, cache)`` (the cache updated in
    place) and a zero decode cache of ``batch`` slots and ``s_max``
    positions on ``device`` (the reference returns its shape)."""
    if batch is None or s_max is None:
        raise TypeError("make_decode_step needs batch and s_max")
    ctx = Ctx(cfg=cfg, mode="decode", act_dtype=act_dtype)
    cache = lm.init_cache(cfg, batch, s_max, act_dtype, resolve_device(device))

    @torch.no_grad()
    def serve_step(params, cache, tokens, positions):
        return lm.decode_step(cfg, params, cache, tokens, positions, ctx=ctx)

    return serve_step, None, None, cache
