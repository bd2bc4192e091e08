"""The dense LM for serving: embedding -> stacked attention units -> norm
-> tied or untied head. The port of ``repro/models/lm.py`` for the dense
pattern (``attn`` blocks only).

Parameters are nested dicts of tensors in the reference's tree layout:
``units`` leaves carry a leading unit axis, so
:func:`repro_torch.models.param.from_jax_params` converts a reference
tree leaf by leaf. The unit loop is a Python loop over that axis (the
reference's ``lax.scan``).

Entry points:
  init / abstract_params            parameter trees
  forward                           logits for train/prefill (+ caches)
  init_cache / cache_from_prefill   decode caches (n_units, B, KV, S, dh)
  decode_step                       one token vs the KV cache
  split_serve_params / decode_step_split   the same, cut at a unit
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, init_params, map_tree


def _check_dense(cfg):
    if cfg.pattern_unit() != ("attn",) or cfg.enc_dec or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention models only "
            f"(pattern {cfg.pattern_unit()})")


# --------------------------------------------------------------------------
# Param specs.
# --------------------------------------------------------------------------

def _block_spec(cfg) -> Dict:
    d = cfg.d_model
    spec = {"norm1": L.spec_rmsnorm(d), "attn": L.spec_attention(cfg)}
    if cfg.d_ff:
        spec["norm2"] = L.spec_rmsnorm(d)
        spec["mlp"] = L.spec_mlp(cfg)
    return spec


def abstract_params(cfg) -> Dict:
    _check_dense(cfg)
    d, V = cfg.d_model, cfg.vocab
    stack = lambda s: ParamSpec((cfg.n_units,) + s.shape, s.init, s.scale,
                                s.dtype)
    tree: Dict[str, Any] = {
        "embed": ParamSpec((V, d), "embed"),
        "units": {"0:attn": map_tree(stack, _block_spec(cfg))},
        "final_norm": L.spec_rmsnorm(d),
    }
    if not cfg.tie_embeddings:
        tree["head"] = ParamSpec((d, V))
    return tree


def init(cfg, generator: torch.Generator) -> Dict:
    """Seeded random weights on ``generator.device``."""
    return init_params(abstract_params(cfg), generator)


def _unit(params_units, u: int):
    return map_tree(lambda a: a[u], params_units)


def _n_units(params) -> int:
    return params["units"]["0:attn"]["norm1"]["scale"].shape[0]


# --------------------------------------------------------------------------
# Blocks and forward.
# --------------------------------------------------------------------------

def _apply_block(cfg, p, x, ctx: L.Ctx, cache):
    """Pre-norm residual attention block. Returns (x, attention cache)."""
    h, nc = L.apply_attention(p["attn"], L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                              ctx, causal=cfg.causal, window=cfg.window,
                              cache=cache)
    x = x + h
    if cfg.d_ff:
        x = x + L.apply_mlp(p["mlp"], L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                            ctx)
    return x, nc


def _embed_tokens(params, tokens, act_dtype):
    return params["embed"][tokens].to(act_dtype)


def _rope_for(cfg, seq: int, device, positions=None):
    """cos/sin tables. positions: (B,) decode positions or None (0..S)."""
    if positions is None:
        positions = torch.arange(seq, device=device)
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def forward(cfg, params, tokens, *, ctx: L.Ctx):
    """Full-sequence logits. mode = train (no cache) or prefill.

    Returns (logits fp32, aux_loss (0 for dense), caches_or_None) with
    caches ``{"0:attn": {"attn": {"k", "v"}}}`` stacked (n_units, B, KV,
    S, dh).
    """
    _check_dense(cfg)
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, ctx.act_dtype)
    ctx = dataclasses.replace(ctx, rope=_rope_for(cfg, S, tokens.device))
    ks, vs = [], []
    for u in range(_n_units(params)):
        x, nc = _apply_block(cfg, _unit(params["units"], u)["0:attn"], x, ctx,
                             None)
        if ctx.mode == "prefill":
            ks.append(nc["k"])
            vs.append(nc["v"])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _head(cfg, params, x)
    caches = None
    if ctx.mode == "prefill":
        caches = {"0:attn": {"attn": {"k": torch.stack(ks),
                                      "v": torch.stack(vs)}}}
    return logits, torch.zeros((), device=x.device), caches


def _head(cfg, params, x):
    """f32 logits from act-dtype operands: the products of bf16 values are
    exact in f32, so this is the reference's bf16 dot with
    ``preferred_element_type=f32``. Rounding logits to bf16 would flip
    greedy ties."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x.float() @ w.to(x.dtype).float()


# --------------------------------------------------------------------------
# Serving: cache init + single-token decode.
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, s_max: int, act_dtype=torch.bfloat16,
               device="cpu") -> Dict:
    """Per-unit stacked cache (leading axis n_units), zeros."""
    _check_dense(cfg)
    s_eff = min(cfg.window, s_max) if cfg.window else s_max
    shape = (cfg.n_units, batch, cfg.n_kv_heads, s_eff, cfg.head_dim)
    return {"0:attn": {"attn": {
        "k": torch.zeros(shape, dtype=act_dtype, device=device),
        "v": torch.zeros(shape, dtype=act_dtype, device=device)}}}


def cache_from_prefill(cfg, caches, s_max: int, act_dtype=torch.bfloat16):
    """Convert ``forward(mode="prefill")`` caches into a decode cache of
    capacity ``s_max``: full-attention K/V pad to s_max; sliding-window
    K/V scatter the last ``window`` positions into their ring slots
    (slot = pos % window), matching the decode write index."""
    def ring(kv):
        U, B, KV, S, dh = kv.shape
        s_eff = min(cfg.window, s_max) if cfg.window else s_max
        out = torch.zeros((U, B, KV, s_eff, dh), dtype=act_dtype,
                          device=kv.device)
        take = min(S, s_eff)
        slots = torch.arange(S - take, S, device=kv.device) % s_eff
        out[:, :, :, slots, :] = kv[:, :, :, S - take:, :].to(act_dtype)
        return out

    return {key: {sub: {kk: ring(vv) for kk, vv in val.items()}
                  for sub, val in blk.items()}
            for key, blk in caches.items()}


def _decode_units(cfg, params, cache, x, ctx):
    """Apply every unit of ``params`` to the one-token activation ``x``,
    writing each unit's K/V into its slice of ``cache`` in place."""
    kv = cache["0:attn"]["attn"]
    for u in range(_n_units(params)):
        x, _ = _apply_block(cfg, _unit(params["units"], u)["0:attn"], x, ctx,
                            {"k": kv["k"][u], "v": kv["v"][u]})
    return x


def _decode_ctx(cfg, ctx, positions):
    return dataclasses.replace(
        ctx, mode="decode", positions=positions,
        rope=_rope_for(cfg, 1, positions.device, positions=positions))


def decode_step(cfg, params, cache, tokens, positions, *, ctx: L.Ctx):
    """One decode step. tokens: (B, 1); positions: (B,).

    Returns (logits (B, 1, V) fp32, cache). The cache is updated in place
    (the reference returns an updated copy); the same dict is returned.
    """
    _check_dense(cfg)
    x = _embed_tokens(params, tokens, ctx.act_dtype)
    x = _decode_units(cfg, params, cache, x, _decode_ctx(cfg, ctx, positions))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params, x), cache


# --------------------------------------------------------------------------
# Split serving: decode with the model cut at a unit boundary.
# --------------------------------------------------------------------------

def split_serve_params(cfg, params, cut_units: int):
    """Split the decode-path params at unit boundary ``cut_units``.

    Returns ``(params_sat, params_gnd)``: the satellite half holds the
    embedding and units ``[0, cut)``; the ground half holds units
    ``[cut, U)``, the final norm and the head (for tied embeddings the
    ground keeps its own reference to the embedding matrix). Unit leaves
    are views of ``params``.
    """
    if not 1 <= cut_units <= cfg.n_units - 1:
        raise ValueError(f"cut_units must be in [1, {cfg.n_units - 1}], "
                         f"got {cut_units}")
    _check_dense(cfg)
    pa = {"embed": params["embed"],
          "units": map_tree(lambda a: a[:cut_units], params["units"])}
    pb = {"units": map_tree(lambda a: a[cut_units:], params["units"]),
          "final_norm": params["final_norm"]}
    if cfg.tie_embeddings:
        pb["embed"] = params["embed"]
    else:
        pb["head"] = params["head"]
    return pa, pb


def decode_step_split(cfg, params_sat, params_gnd, cache, tokens, positions,
                      *, ctx: L.Ctx):
    """One decode step of the SPLIT model: the satellite half's units,
    then the ground half's, in the same order as :func:`decode_step`.

    ``cache`` is the full stacked decode cache; each half writes its own
    unit slices in place. Returns ``(logits (B, 1, V) fp32, cache,
    boundary)`` where ``boundary`` is the activation ``(B, 1, d_model)``
    that crosses the satellite->ground downlink.
    """
    cut = _n_units(params_sat)
    x = _embed_tokens(params_sat, tokens, ctx.act_dtype)
    dctx = _decode_ctx(cfg, ctx, positions)
    kv = cache["0:attn"]["attn"]
    half = lambda lo, hi: {"0:attn": {"attn": {"k": kv["k"][lo:hi],
                                               "v": kv["v"][lo:hi]}}}
    boundary = _decode_units(cfg, params_sat, half(0, cut), x, dctx)
    x = _decode_units(cfg, params_gnd, half(cut, None), boundary, dctx)
    x = L.rmsnorm(params_gnd["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params_gnd, x), cache, boundary
