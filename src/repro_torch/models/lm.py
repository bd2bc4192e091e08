"""The LM: embedding -> stacked pattern units -> norm -> tied or untied
head. The port of ``repro/models/lm.py`` for the block kinds ``attn``,
``moe``, ``mamba2``, ``shared_attn``, ``mlstm`` and ``slstm`` (dense
models, the MoE models, Qwen2-VL's backbone with M-RoPE and its vision
prefix, Zamba2 and xLSTM) and for Whisper's encoder-decoder
(``cfg.enc_dec``): an encoder stack over ``enc_frames`` (``enc_units``,
``enc_norm``), sinusoid positions in place of RoPE, and a cross-attention
sub-block (``norm_x``, ``cross``) in every decoder block, whose decode
cache ``cross`` holds the encoder memory's K/V, fixed after the prefill.
As in the reference, enc-dec is served through ``forward(mode=
"prefill")``, ``cache_from_prefill`` and ``decode_step`` only: the split
decode and the engines refuse it.

Parameters are nested dicts of tensors in the reference's tree layout:
``units`` holds one entry per non-shared block of the pattern unit,
keyed ``f"{j}:{kind}"``, whose leaves carry a leading unit axis; Zamba2's
shared attention block is the top-level ``shared`` entry, applied at
every ``shared_attn`` position. So
:func:`repro_torch.models.param.from_jax_params` converts a reference
tree leaf by leaf. The unit loop is a Python loop over that axis (the
reference's ``lax.scan``).

Caches are nested dicts keyed like the unit (shared positions included)
whose leaves carry a leading unit axis: ``{"attn": {"k", "v"}}`` for an
attention block, ``{"mamba": {"conv", "h"}}`` for a Mamba-2 block, and
tuples as in the reference for xLSTM: ``{"mlstm": (C, n, m)}`` and
``{"slstm": (c, n, h, m)}``, all f32, with the stabilizer m at -1e30
before the first token.

Training: ``forward(remat=)`` recomputes each pattern unit in the
backward (``"full"``: ``torch.utils.checkpoint``, non-reentrant) or
keeps only its matmul outputs (``"dots"``: a selective checkpoint
policy, the counterpart of ``jax.checkpoint_policies.checkpoint_dots``);
the three modes give the same gradients. Remat applies only when a
parameter requires grad under grad mode. The reference's ``unroll`` (its
``lax.scan`` unrolling) is accepted and ignored. With ``ctx.mesh`` (a
train step on a ``(data, model)`` mesh, :mod:`repro_torch.models.
parallel`) ``params`` hold this rank's shards: the embedding, the head
and the loss run vocab-parallel where the vocab is cut, and ``loss``
averages over the global batch; serving and split segments refuse a
mesh.

Entry points:
  init / abstract_params            parameter trees
  forward                           logits, MoE aux, caches (train/prefill)
  loss                              next-token CE + aux_weight * MoE aux
  init_cache / cache_from_prefill   decode caches
  decode_step                       one token vs the caches
  split_serve_params / decode_step_split   the same, cut at a unit
                                    (not for enc-dec)
  n_blocks / forward_segment        SL split execution of blocks [lo, hi)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models import parallel as par
from repro_torch.models.param import ParamSpec, init_params, map_tree
from repro_torch.utils.treeutil import tree_leaves

SERVED_KINDS = ("attn", "moe", "mamba2", "shared_attn", "mlstm", "slstm")
# Recurrent block kinds: the cache entry (and parameter sub-tree) name,
# and the block's spec and apply functions.
RECURRENT = {"mamba2": ("mamba", L.spec_mamba2, L.apply_mamba2),
             "mlstm": ("mlstm", L.spec_mlstm, L.apply_mlstm),
             "slstm": ("slstm", L.spec_slstm, L.apply_slstm)}


def _check_served(cfg):
    unit = cfg.pattern_unit()
    if not set(unit) <= set(SERVED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the port serves block kinds {SERVED_KINDS} "
            f"(pattern {unit})")


def _refuse_split_enc_dec(cfg):
    if cfg.enc_dec:
        raise NotImplementedError("split serving does not cover enc-dec "
                                  "(whisper) architectures")


def _enc_cfg(cfg):
    """The encoder's config: the decoder's widths, bidirectional, no
    cross-attention."""
    return dataclasses.replace(cfg, enc_dec=False, causal=False)


# --------------------------------------------------------------------------
# Param specs.
# --------------------------------------------------------------------------

def _block_spec(cfg, kind: str) -> Dict:
    d = cfg.d_model
    if kind in RECURRENT:
        sub, spec_fn, _ = RECURRENT[kind]
        return {"norm1": L.spec_rmsnorm(d), sub: spec_fn(cfg)}
    spec = {"norm1": L.spec_rmsnorm(d), "attn": L.spec_attention(cfg)}
    if cfg.enc_dec:
        spec["norm_x"] = L.spec_rmsnorm(d)
        spec["cross"] = L.spec_attention(cfg, cross=True)
    if cfg.d_ff:
        spec["norm2"] = L.spec_rmsnorm(d)
        spec["mlp"] = L.spec_moe(cfg) if kind == "moe" else L.spec_mlp(cfg)
    return spec


def _unit_spec(cfg) -> Dict:
    return {f"{j}:{kind}": _block_spec(cfg, kind)
            for j, kind in enumerate(cfg.pattern_unit())
            if kind != "shared_attn"}


def abstract_params(cfg) -> Dict:
    _check_served(cfg)
    d, V = cfg.d_model, cfg.vocab
    stack = lambda n: lambda s: ParamSpec(
        (n,) + s.shape, ("unit",) + s.axes, s.init, s.scale, s.dtype,
        None if s.view is None else (None,) + s.view)
    tree: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), "embed"),
        "units": map_tree(stack(cfg.n_units), _unit_spec(cfg)),
        "final_norm": L.spec_rmsnorm(d),
    }
    if "shared_attn" in cfg.pattern_unit():
        tree["shared"] = _block_spec(cfg, "shared_attn")
    if not cfg.tie_embeddings:
        tree["head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.enc_dec:
        tree["enc_units"] = map_tree(
            stack(cfg.n_enc_layers),
            {"0:attn": _block_spec(_enc_cfg(cfg), "attn")})
        tree["enc_norm"] = L.spec_rmsnorm(d)
    return tree


def init(cfg, generator: torch.Generator) -> Dict:
    """Seeded random weights on ``generator.device``."""
    return init_params(abstract_params(cfg), generator)


def _unit(tree, u: int):
    return map_tree(lambda a: a[u], tree)


def _n_units(params) -> int:
    return tree_leaves(params["units"])[0].shape[0]


def _stack(trees):
    """Trees of one layout -> one tree whose leaves gain a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(items)) for items in zip(*trees))
    return torch.stack(trees)


# --------------------------------------------------------------------------
# Blocks and forward.
# --------------------------------------------------------------------------

def _apply_block(cfg, kind: str, p, x, ctx: L.Ctx, cache):
    """Pre-norm residual block. Returns (x, new cache dict, MoE aux or
    None)."""
    cache = cache or {}
    new_cache: Dict[str, Any] = {}
    xn = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in RECURRENT:
        sub, _, apply_fn = RECURRENT[kind]
        h, nc = apply_fn(p[sub], xn, ctx, cache=cache.get(sub))
        x = x + h
        if nc is not None:
            new_cache[sub] = nc
        return x, new_cache, None
    h, nc = L.apply_attention(p["attn"], xn, ctx, causal=cfg.causal,
                              window=cfg.window, cache=cache.get("attn"),
                              use_rope=not cfg.enc_dec)
    x = x + h
    if nc is not None:
        new_cache["attn"] = nc
    if cfg.enc_dec and "cross" in p:
        h, nc = L.apply_attention(
            p["cross"], L.rmsnorm(p["norm_x"], x, cfg.norm_eps), ctx,
            causal=False, cache=cache.get("cross"), kv_input=ctx.enc_out,
            use_rope=False, is_cross=True)
        x = x + h
        if nc is not None:
            new_cache["cross"] = nc
    aux = None
    if cfg.d_ff:
        xn = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        if kind == "moe":
            h, aux = L.apply_moe(p["mlp"], xn, ctx)
        else:
            h = L.apply_mlp(p["mlp"], xn, ctx)
        x = x + h
    return x, new_cache, aux


def _apply_unit(cfg, unit_params, shared_params, x, ctx: L.Ctx, unit_cache):
    """The blocks of one pattern unit in order; ``shared_attn`` positions
    use ``shared_params``. Returns (x, caches keyed like the unit, the
    unit's MoE aux summed over its blocks, f32, or None without MoE)."""
    new_caches = {}
    aux = None
    for j, kind in enumerate(cfg.pattern_unit()):
        key = f"{j}:{kind}"
        p = shared_params if kind == "shared_attn" else unit_params[key]
        c = unit_cache.get(key) if unit_cache else None
        x, nc, a = _apply_block(cfg, kind, p, x, ctx, c)
        if a is not None:
            aux = a if aux is None else aux + a
        if nc:
            new_caches[key] = nc
    return x, new_caches, aux


def _embed_tokens(params, tokens, act_dtype, ctx=None):
    """The token embeddings; vocab-parallel where ``ctx``'s mesh cuts the
    vocab."""
    split = None if ctx is None else par.model_split(ctx, "vocab",
                                                     ctx.cfg.vocab)
    if split is not None:
        return par.embed_lookup(params["embed"], tokens, ctx.mesh,
                                split).to(act_dtype)
    return params["embed"][tokens].to(act_dtype)


def _refuse_mesh(ctx, what: str):
    if ctx.mesh is not None:
        raise NotImplementedError(f"{what} on a mesh: the port places the "
                                  f"train step only")


def _sinusoid_at(positions, d: int):
    """Rows ``positions`` (int, any device) of the reference's f32 table
    ``_sinusoid``: [sin(pos / 10000^(2i/d)), cos(...)], i < d/2, (N, d)
    f32. The power is taken in f64 and rounded once to f32, as the
    reference's f32 power rounds it (but at one frequency of d = 768,
    where XLA's is an ulp off); a row depends on its position only, so
    this equals the table's rows without building the table (2^17 rows
    at decode in the reference, 402 MB at d = 768)."""
    dev = positions.device
    expo = 2.0 * torch.arange(d // 2, dtype=torch.float32, device=dev) / d
    denom = torch.pow(torch.tensor(10000.0, dtype=torch.float64, device=dev),
                      expo.double()).float()
    ang = positions.float()[:, None] / denom[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(S: int, d: int, device=None):
    """The reference's absolute position table, (S, d) f32."""
    return _sinusoid_at(torch.arange(S, device=device), d)


def _run_encoder(cfg, params, enc_frames, ctx: L.Ctx):
    """Whisper's encoder over (stub) frame embeddings (B, S_enc, d):
    frames in the activation dtype plus the sinusoid, the encoder units
    (bidirectional self-attention + MLP, no RoPE, never checkpointed, as
    the reference's encoder scan is not), then ``enc_norm``."""
    S = enc_frames.shape[1]
    x = enc_frames.to(ctx.act_dtype) + \
        _sinusoid(S, cfg.d_model, enc_frames.device).to(ctx.act_dtype)[None]
    enc_cfg = _enc_cfg(cfg)
    ectx = dataclasses.replace(ctx, cfg=enc_cfg, mode="train", rope=None)
    for u in range(cfg.n_enc_layers):
        x, _, _ = _apply_unit(enc_cfg, _unit(params["enc_units"], u), None,
                              x, ectx, None)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _rope_for(cfg, batch: int, seq: int, device, positions=None,
              frontend_len: int = 0):
    """cos/sin tables. positions: (B,) decode positions or None (0..S).
    M-RoPE: (3, B, S) ids with a vision prefix of ``frontend_len`` grid
    positions, or each decode position in all three sections. None for
    enc-dec (Whisper takes absolute sinusoid positions instead)."""
    if cfg.enc_dec:
        return None
    if cfg.mrope:
        if positions is None:
            ids = L.text_mrope_positions(batch, seq, frontend_len,
                                         device=device)
        else:
            ids = positions[None, :, None].expand(3, batch, 1)
        return L.mrope_tables(ids, cfg.head_dim, cfg.rope_theta)
    if positions is None:
        positions = torch.arange(seq, device=device)
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


REMAT = ("none", "full", "dots")
# The matmuls whose outputs remat="dots" keeps (einsums lower to them).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_unit(remat: str, fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward:
    all of them (``"full"``) or all but the matmul outputs (``"dots"``)."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _trains(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def forward(cfg, params, tokens, *, ctx: L.Ctx, frontend_embed=None,
            enc_frames=None, remat: str = "full", unroll: int = 1):
    """Full-sequence logits. mode = train (no cache) or prefill.

    Returns (logits fp32, MoE aux summed over blocks and units (0 without
    MoE), caches_or_None) with the caches stacked along a leading unit
    axis (module docstring). A vision config (``frontend == "vision"``)
    given ``frontend_embed`` (B, frontend_len, d) takes it in place of
    the first ``frontend_len`` token embeddings, and its M-RoPE gives
    those positions grid ids. An enc-dec config needs ``enc_frames``
    (B, S_enc, d): the encoder runs over them once (not checkpointed)
    and every decoder block's cross-attention reads its output; a
    decoder-only config ignores them, as the reference does. ``remat``
    (none | full | dots) sets what the decoder's backward recomputes;
    ``unroll`` is accepted and ignored.
    """
    _check_served(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if ctx.mesh is not None:
        if ctx.mode != "train":
            _refuse_mesh(ctx, f"mode {ctx.mode!r}")
        par.check_supported(cfg, ctx.mesh)
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, ctx.act_dtype, ctx)
    n_front = 0
    if cfg.frontend == "vision" and frontend_embed is not None:
        n_front = cfg.frontend_len
        x = torch.cat([frontend_embed.to(ctx.act_dtype), x[:, n_front:]],
                      dim=1)
    if cfg.enc_dec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             f"needs enc_frames (B, frames, d_model)")
        x = x + _sinusoid(S, cfg.d_model, x.device).to(ctx.act_dtype)[None]
        ctx = dataclasses.replace(
            ctx, enc_out=_run_encoder(cfg, params, enc_frames, ctx))
    ctx = dataclasses.replace(ctx, rope=_rope_for(
        cfg, B, S, tokens.device, frontend_len=n_front))
    shared = params.get("shared")
    remat = remat if _trains(params) else "none"
    per_unit = []
    aux = torch.zeros((), device=x.device)
    for u in range(_n_units(params)):
        args = (cfg, _unit(params["units"], u), shared, x, ctx, None)
        x, caches, a = (_apply_unit(*args) if remat == "none"
                        else _remat_unit(remat, _apply_unit, *args))
        per_unit.append(caches)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _head(cfg, params, x, ctx)
    caches = _stack(per_unit) if ctx.mode == "prefill" else None
    return logits, aux, caches


def _head(cfg, params, x, ctx=None):
    """f32 logits from act-dtype operands: the products of bf16 values are
    exact in f32, so this is the reference's bf16 dot with
    ``preferred_element_type=f32``. Rounding logits to bf16 would flip
    greedy ties. Where ``ctx``'s mesh cuts the vocab, this rank's
    columns of the logits."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    if ctx is not None and par.model_split(ctx, "vocab", cfg.vocab):
        x = par.copy_to_model(x, ctx.mesh)
    return x.float() @ w.to(x.dtype).float()


def loss(cfg, params, tokens, labels, *, ctx: L.Ctx, frontend_embed=None,
         enc_frames=None, remat: str = "full", aux_weight: float = 0.01,
         unroll: int = 1):
    """Next-token CE (labels = targets aligned to positions; -1 = pad;
    a vision config's first ``frontend_len`` positions are left out).
    Returns (ce + aux_weight * aux, {"ce", "aux", "ntok"}). On a mesh the
    mean is over the global batch (the sum and the token count summed
    over ``data``), and a cut vocab takes the vocab-parallel CE."""
    logits, aux, _ = forward(cfg, params, tokens, ctx=ctx,
                             frontend_embed=frontend_embed,
                             enc_frames=enc_frames, remat=remat,
                             unroll=unroll)
    mask = labels >= 0
    if cfg.frontend == "vision":
        pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
        mask = mask & (pos >= cfg.frontend_len)
    labels_c = labels.clamp(min=0).long()
    split = par.model_split(ctx, "vocab", cfg.vocab)
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels_c[..., None])[..., 0]
    else:
        lse = par.vocab_logsumexp(logits, ctx.mesh)
        ll = par.vocab_pick(logits, labels_c, split, ctx.mesh)
    ce = (lse - ll) * mask
    total, n = ce.sum(), mask.sum()
    if ctx.mesh is not None:
        total = par.reduce_from_data(total, ctx.mesh)
        n = par.all_reduce(n, ctx.mesh, "data")
    n = n.clamp(min=1)
    ce_mean = total / n
    return ce_mean + aux_weight * aux, {"ce": ce_mean, "aux": aux,
                                        "ntok": n}


# --------------------------------------------------------------------------
# Serving: cache init + single-token decode.
# --------------------------------------------------------------------------

def _block_cache_shapes(cfg, kind: str, batch: int, s_max: int, act_dtype,
                        device) -> Dict:
    zeros = lambda shape, dt: torch.zeros((cfg.n_units,) + shape, dtype=dt,
                                          device=device)
    if kind == "mamba2":
        di, H, P, N = L.mamba_dims(cfg)
        return {"mamba": {"conv": zeros((batch, 3, di), act_dtype),
                          "h": zeros((batch, H, P, N), torch.float32)}}
    if kind == "mlstm":
        H = cfg.n_heads
        P = cfg.d_inner // H
        return {"mlstm": (zeros((batch, H, P, P), torch.float32),
                          zeros((batch, H, P), torch.float32),
                          zeros((batch, H), torch.float32).fill_(-1e30))}
    if kind == "slstm":
        d = cfg.d_model
        return {"slstm": tuple(zeros((batch, d), torch.float32).fill_(
            -1e30 if i == 3 else 0.0) for i in range(4))}
    s_eff = min(cfg.window, s_max) if cfg.window else s_max
    kv = lambda s: {n: zeros((batch, cfg.n_kv_heads, s, cfg.head_dim),
                             act_dtype) for n in ("k", "v")}
    out = {"attn": kv(s_eff)}
    if cfg.enc_dec:                      # the encoder memory's K/V
        out["cross"] = kv(cfg.frontend_len)
    return out


def init_cache(cfg, batch: int, s_max: int, act_dtype, device) -> Dict:
    """Per-unit stacked decode cache (leading axis n_units), zeros, on
    ``device``."""
    _check_served(cfg)
    return {f"{j}:{kind}": _block_cache_shapes(cfg, kind, batch, s_max,
                                               act_dtype, device)
            for j, kind in enumerate(cfg.pattern_unit())}


def cache_from_prefill(cfg, caches, s_max: int, act_dtype=torch.bfloat16):
    """Convert ``forward(mode="prefill")`` caches into a decode cache of
    capacity ``s_max``. Recurrent states (mamba, mlstm, slstm; the
    xLSTM ones are tuples) pass through as copies,
    since decode updates the cache in place; full-attention K/V pad to
    s_max; sliding-window K/V scatter the last
    ``window`` positions into their ring slots (slot = pos % window),
    matching the decode write index. Cross-attention's K/V (the fixed
    encoder memory) are copied in ``act_dtype``, with no ring and no
    pad."""
    def ring(kv):
        U, B, KV, S, dh = kv.shape
        s_eff = min(cfg.window, s_max) if cfg.window else s_max
        out = torch.zeros((U, B, KV, s_eff, dh), dtype=act_dtype,
                          device=kv.device)
        take = min(S, s_eff)
        slots = torch.arange(S - take, S, device=kv.device) % s_eff
        out[:, :, :, slots, :] = kv[:, :, :, S - take:, :].to(act_dtype)
        return out

    def convert(sub, val):
        if sub == "attn":
            return {kk: ring(vv) for kk, vv in val.items()}
        if sub == "cross":
            return map_tree(lambda a: a.to(act_dtype, copy=True), val)
        return map_tree(torch.clone, val)

    return {key: {sub: convert(sub, val) for sub, val in blk.items()}
            for key, blk in caches.items()}


def _decode_units(cfg, params, cache, x, ctx):
    """Apply every unit of ``params`` to the one-token activation ``x``,
    updating each unit's slice of ``cache`` in place."""
    shared = params.get("shared")
    for u in range(_n_units(params)):
        x, _, _ = _apply_unit(cfg, _unit(params["units"], u), shared, x, ctx,
                              _unit(cache, u))
    return x


def _decode_ctx(cfg, ctx, positions):
    return dataclasses.replace(
        ctx, mode="decode", positions=positions,
        rope=_rope_for(cfg, positions.shape[0], 1, positions.device,
                       positions=positions))


def decode_step(cfg, params, cache, tokens, positions, *, ctx: L.Ctx,
                unroll: int = 1):
    """One decode step. tokens: (B, 1); positions: (B,).

    Returns (logits (B, 1, V) fp32, cache). The cache is updated in place
    (the reference returns an updated copy); the same dict is returned.
    An enc-dec config adds each position's sinusoid row to the token
    embedding (the reference gathers it from a table of 2^17 rows) and
    reads the cross cache as it is. ``unroll`` is accepted and ignored.
    """
    _check_served(cfg)
    _refuse_mesh(ctx, "decode_step")
    x = _embed_tokens(params, tokens, ctx.act_dtype)
    if cfg.enc_dec:
        x = x + _sinusoid_at(positions, cfg.d_model)[:, None].to(
            ctx.act_dtype)
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
    ground keeps its own reference to the embedding matrix). Zamba2's
    shared block goes to both halves, as it is applied inside units on
    each side. Unit leaves are views of ``params``. Enc-dec (Whisper)
    raises NotImplementedError, as in the reference.
    """
    if not 1 <= cut_units <= cfg.n_units - 1:
        raise ValueError(f"cut_units must be in [1, {cfg.n_units - 1}], "
                         f"got {cut_units}")
    _check_served(cfg)
    _refuse_split_enc_dec(cfg)
    pa = {"embed": params["embed"],
          "units": map_tree(lambda a: a[:cut_units], params["units"])}
    pb = {"units": map_tree(lambda a: a[cut_units:], params["units"]),
          "final_norm": params["final_norm"]}
    if cfg.tie_embeddings:
        pb["embed"] = params["embed"]
    else:
        pb["head"] = params["head"]
    if "shared" in params:
        pa["shared"] = params["shared"]
        pb["shared"] = params["shared"]
    return pa, pb


def decode_step_split(cfg, params_sat, params_gnd, cache, tokens, positions,
                      *, ctx: L.Ctx, unroll: int = 1):
    """One decode step of the SPLIT model: the satellite half's units,
    then the ground half's, in the same order as :func:`decode_step`.

    ``cache`` is the full stacked decode cache; each half updates its own
    unit slices in place. Returns ``(logits (B, 1, V) fp32, cache,
    boundary)`` where ``boundary`` is the activation ``(B, 1, d_model)``
    that crosses the satellite->ground downlink. ``unroll`` is accepted
    and ignored. Enc-dec raises NotImplementedError (no split params).
    """
    _refuse_split_enc_dec(cfg)
    _refuse_mesh(ctx, "decode_step_split")
    cut = _n_units(params_sat)
    x = _embed_tokens(params_sat, tokens, ctx.act_dtype)
    dctx = _decode_ctx(cfg, ctx, positions)
    boundary = _decode_units(cfg, params_sat,
                             map_tree(lambda a: a[:cut], cache), x, dctx)
    x = _decode_units(cfg, params_gnd, map_tree(lambda a: a[cut:], cache),
                      boundary, dctx)
    x = L.rmsnorm(params_gnd["final_norm"], x, cfg.norm_eps)
    return _head(cfg, params_gnd, x), cache, boundary


# --------------------------------------------------------------------------
# Split-learning segment execution (the paper's cut, on a real model).
# --------------------------------------------------------------------------

def n_blocks(cfg) -> int:
    return cfg.n_units * len(cfg.pattern_unit())


def forward_segment(cfg, params, x, lo: int, hi: int, *, ctx: L.Ctx,
                    tokens=None, unit_offset: int = 0):
    """Apply blocks [lo, hi). lo == 0 consumes ``tokens`` via the
    embedding; hi == n_blocks applies the final norm and the head (f32
    logits). ``unit_offset``: params["units"] holds units starting at this
    index (segment trees are slices of the full stacked tree). On an
    enc-dec config this computes what the reference's does: no sinusoid,
    and with no ``ctx.enc_out`` each cross-attention reads the decoder's
    own states."""
    _check_served(cfg)
    _refuse_mesh(ctx, "forward_segment")
    pat = cfg.pattern_unit()
    if lo == 0:
        if tokens is None:
            raise ValueError("forward_segment from block 0 needs tokens")
        x = _embed_tokens(params, tokens, ctx.act_dtype)
    ctx = dataclasses.replace(ctx, rope=_rope_for(cfg, x.shape[0], x.shape[1],
                                                  x.device))
    for idx in range(lo, hi):
        u, j = divmod(idx, len(pat))
        kind = pat[j]
        p = (params.get("shared") if kind == "shared_attn"
             else _unit(params["units"], u - unit_offset)[f"{j}:{kind}"])
        x, _, _ = _apply_block(cfg, kind, p, x, ctx, None)
    if hi == n_blocks(cfg):
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _head(cfg, params, x)
    return x
