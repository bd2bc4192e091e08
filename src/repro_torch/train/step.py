"""The LM train step and the serving steps (the port of
``repro/train/step.py``).

``make_train_step`` returns the reference's 4-tuple, ``(train_step,
state_specs, batch_specs, init_state)``: ``train_step(state, batch) ->
(state, metrics)`` takes loss and gradients (``lm.loss`` under the
configured remat), optionally compresses the gradients with error
feedback (``train.compression``: int8 runs on kernel B1 on the card),
clips them to a global norm and applies AdamW. The state is updated in
place, as the reference's jitted step donates it.

With a ``mesh`` (a ``(data, model)`` ``DeviceMesh``,
:func:`repro_torch.launch.mesh.make_host_mesh`) the step is the
reference's pjit placement run by hand: each rank holds its shard of the
parameters (``ShardingRules``, :func:`~repro_torch.models.parallel.
placement`) and its ZeRO slice of mu and nu
(:func:`~repro_torch.train.optimizer.adamw_state_specs`), takes its data
rank's rows of the global batch, runs the layers tensor-parallel
(:mod:`repro_torch.models.parallel`), sums the gradients over ``data``
and applies :func:`~repro_torch.train.optimizer.zero_adamw_update`. The
result is one process's step, to rounding. Without a mesh the step runs
on one device and the two specs are None.

Not ported: ``cache_shardings`` and sharded serving (the serving steps
take no mesh). ``TrainConfig``'s TPU fields (``use_pallas``,
``block_q``, ``block_k``, ``scan_unroll``, ``attn_compute_dtype``) are
accepted and ignored, as :class:`repro_torch.models.layers.Ctx` ignores
them; ``moe_dispatch`` picks the MoE layout (``global`` or
``batch_local``). ``make_prefill_step`` and ``make_decode_step`` are
thin wrappers over ``lm.forward`` and ``lm.decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models import parallel as par
from repro_torch.models.layers import Ctx
from repro_torch.models.param import ShardingRules, map_tree
from repro_torch.train import compression
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update, zero_adamw_update)
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


def loss_and_grads(cfg, tcfg: TrainConfig, params, batch, mesh=None,
                   rules: ShardingRules = ShardingRules()):
    """(loss, metrics {"ce", "aux", "ntok"}, grads shaped like ``params``)
    of ``lm.loss`` on ``batch`` (a dict of tensors on the params' device),
    in the block context ``tcfg`` sets, as the reference's step builds it.
    With a ``mesh``: this rank's shards and rows, the loss over the
    global batch, the gradients of this rank's part (not yet summed over
    ``data``)."""
    ctx = Ctx(cfg=cfg, mesh=mesh, rules=rules, mode="train",
              act_dtype=tcfg.act_dtype,
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
    """Returns (train_step, state_specs, batch_specs, init_state).

    ``train_step(state, batch) -> (state, metrics)``; ``batch`` is a dict
    of ``tokens``/``labels`` (NumPy arrays or tensors). The state's
    tensors are updated in place and returned. ``init_state(seed)``
    draws the weights from ``torch.Generator(device).manual_seed(seed)``
    (or from a given generator). Without a mesh ``state_specs`` and
    ``batch_specs`` are None; with one, see :func:`_make_sharded_step`.
    """
    dev = resolve_device(device)
    if mesh is not None:
        return _make_sharded_step(cfg, mesh, rules or ShardingRules(), tcfg,
                                  dev)

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


def _make_sharded_step(cfg, mesh, rules: ShardingRules, tcfg: TrainConfig,
                       dev):
    """The step on a ``(data, model)`` mesh (module docstring).

    ``batch`` is the global batch, the same on every rank; each takes its
    data rank's rows (``rules.batch`` resolved on the batch dim).
    ``state_specs`` is a ``TrainState`` of the specs the state is held
    by: each parameter's placement spec, mu's and nu's ZeRO specs, ``()``
    for the step counter. ``batch_specs(batch)`` gives each input's.
    ``init_state(seed)`` draws the whole model as one process does and
    keeps this rank's shard, so the values equal one process's."""
    par.check_supported(cfg, mesh, tcfg.compression)
    abstract = lm.abstract_params(cfg)
    place = par.placement(abstract, rules, mesh)
    zspecs = map_tree(lambda leaf: leaf.zspec, place)
    specs = TrainState(params=map_tree(lambda leaf: leaf.spec, place),
                       opt=AdamWState(step=(), mu=zspecs, nu=zspecs),
                       ef=(map_tree(lambda leaf: leaf.spec, place)
                           if tcfg.compression != "none" else None))

    def batch_specs(batch) -> Dict:
        return {k: rules.resolve(("batch",) + (None,) * (v.ndim - 1), mesh,
                                 v.shape) for k, v in batch.items()}

    def rows(t):
        entry = rules.resolve(("batch",), mesh, t.shape[:1])[0]
        if entry is None:
            return t
        if entry != "data":
            raise NotImplementedError(f"batch on {entry!r}")
        r, n = par.coords(mesh)["data"]
        k = t.shape[0] // n
        return t[r * k:(r + 1) * k]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = {k: rows(torch.as_tensor(v, device=dev))
                 for k, v in batch.items()}
        lv, metrics, grads = loss_and_grads(cfg, tcfg, state.params, batch,
                                            mesh, rules)
        grads = par.reduce_grads(grads, place, mesh)
        ef = state.ef
        if tcfg.compression != "none":       # one rank (check_supported)
            grads, ef_state, cm = compression.compress(
                grads, compression.ErrorFeedbackState(ef),
                scheme=tcfg.compression, topk_ratio=tcfg.topk_ratio)
            ef = ef_state.residual
            metrics.update(cm)
        with torch.no_grad():
            params, opt, om = zero_adamw_update(
                tcfg.adamw, grads, state.opt, state.params, place, mesh)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = lv
        return TrainState(params, opt, ef), metrics

    def init_state(seed=0) -> TrainState:
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(seed)))
        params = par.shard_tree(lm.init(cfg, gen), place, mesh)
        zeros = lambda: tree_unflatten(params, [
            torch.zeros((t if leaf.zdim is None else
                         par.zero_slice(t, leaf.zdim, mesh)).shape,
                        dtype=torch.float32, device=dev)
            for t, leaf in zip(tree_leaves(params), tree_leaves(place))])
        ef = (compression.ef_init(params).residual
              if tcfg.compression != "none" else None)
        return TrainState(params, AdamWState(
            torch.zeros((), dtype=torch.int32, device=dev), zeros(),
            zeros()), ef)

    return train_step, specs, batch_specs, init_state


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
