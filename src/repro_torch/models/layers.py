"""Model layers: RMSNorm, RoPE and Qwen2-VL's M-RoPE, GQA attention
(self- and cross-attention, train/prefill and decode), the SwiGLU/GELU
MLP, the
top-k MoE MLP with capacity dispatch, the Mamba-2 block and xLSTM's
mLSTM and sLSTM blocks.

Each layer is a (spec_*, apply_*) pair as in ``repro/models/layers.py``.
Compute runs in the activation dtype; weights are cast to it at each
matmul (a no-op when the serving engine has cast them once already);
attention and scan math is f32 inside the kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import parallel as par
from repro_torch.models.param import ParamSpec, ShardingRules


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context threaded through blocks, with every field of the
    reference's ``Ctx`` and its defaults. ``mamba_chunk`` and
    ``mlstm_chunk`` set the scans' chunks (the mLSTM kernel takes at most
    64 of it; the scans are exact for any chunk). ``mesh`` (a ``(data,
    model)`` ``DeviceMesh``) and ``rules`` place a train step's layers:
    each rank holds the shard its placement spec gives
    (:mod:`repro_torch.models.parallel`), attention runs B2 on the rank's
    heads and the MLP on its slice of ``d_ff``. Accepted and ignored:
    ``use_pallas``, ``block_q`` and ``block_k`` (TPU kernel choices: the
    card always takes the Hopper kernels, the CPU their plain versions);
    ``attn_compute_dtype`` (the port's attention math is f32 already).
    ``enc_out`` is Whisper's encoder output, the K/V source of
    cross-attention at train and prefill; ``moe_dispatch`` picks the MoE
    layout (:func:`apply_moe`)."""

    cfg: Any
    mesh: Any = None
    rules: ShardingRules = ShardingRules()
    mode: str = "train"                        # train | prefill | decode
    positions: Optional[torch.Tensor] = None   # (B,) decode positions
    rope: Optional[Tuple] = None               # precomputed (cos, sin)
    enc_out: Optional[torch.Tensor] = None     # Whisper's cross-attn memory
    act_dtype: torch.dtype = torch.bfloat16
    use_pallas: Optional[bool] = False
    block_q: int = 512
    block_k: int = 512
    mamba_chunk: int = 128
    mlstm_chunk: int = 256
    attn_compute_dtype: Any = torch.float32
    moe_dispatch: str = "global"               # global | batch_local


# --------------------------------------------------------------------------
# Norms.
# --------------------------------------------------------------------------

def spec_rmsnorm(d: int) -> Dict:
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE / M-RoPE.
# --------------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device):
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_tables(positions, dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., dim/2) fp32."""
    ang = positions.float()[..., None] * _rope_freqs(dim // 2, theta,
                                                     positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_tables(pos_thw, dim: int, theta: float,
                 sections=(0.25, 0.375, 0.375)):
    """Qwen2-VL M-RoPE: the rotary dims split into (t, h, w) sections,
    each rotated by its own position id.

    pos_thw: (3, ...) int position ids. Returns cos/sin (..., dim/2)."""
    half = dim // 2
    n_t, n_h = int(half * sections[0]), int(half * sections[1])
    sec = torch.cat([torch.zeros(n_t, dtype=torch.long),
                     torch.ones(n_h, dtype=torch.long),
                     torch.full((half - n_t - n_h,), 2, dtype=torch.long)])
    # per rotary index j, position = pos_thw[sec[j]]
    pos_per_freq = pos_thw.movedim(0, -1)[..., sec.to(pos_thw.device)]
    ang = pos_per_freq.float() * _rope_freqs(half, theta, pos_thw.device)
    return torch.cos(ang), torch.sin(ang)


def text_mrope_positions(batch: int, seq: int, frontend_len: int,
                         offset=0, device=None):
    """(3, B, S) ids: the vision prefix gets (t=0, h=i//g, w=i%g) grid
    ids on a g x g grid, g = isqrt(frontend_len); text positions repeat
    their index in all three (so text-only M-RoPE is RoPE)."""
    idx = torch.arange(seq, device=device) + offset
    vis = idx < frontend_len
    g = max(int(math.sqrt(max(frontend_len, 1))), 1)
    ids = torch.stack([torch.where(vis, 0, idx),
                       torch.where(vis, idx // g, idx),
                       torch.where(vis, idx % g, idx)])       # (3, S)
    return ids[:, None, :].expand(3, batch, seq)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (S, D/2), (B, D/2) (decode) or
    (B, S, D/2) (M-RoPE)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 3:                                      # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    elif cos.shape[0] == x.shape[1]:                        # (S, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                                   # (B, half)
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention.
# --------------------------------------------------------------------------

def spec_attention(cfg, cross: bool = False) -> Dict:
    """Self-attention's projections; cross-attention (``cross``) has the
    same four."""
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kv = (1, H, dh), (1, KV, dh)            # shards hold whole heads
    return {
        "wq": ParamSpec((d, H * dh), ("embed", "heads"), view=(None, q)),
        "wk": ParamSpec((d, KV * dh), ("embed", "kv_heads"), view=(None, kv)),
        "wv": ParamSpec((d, KV * dh), ("embed", "kv_heads"), view=(None, kv)),
        "wo": ParamSpec((H * dh, d), ("heads", "embed"), view=(q, None)),
    }


def apply_attention(p, x, ctx: Ctx, *, causal=True, window=None, cache=None,
                    kv_input=None, use_rope=True, is_cross=False):
    """x: (B, S, d). cache: {'k','v'} (B, KV, S_max, dh) for decode.

    Returns (y, new_cache). ``kv_input`` (B, S_kv, d) is the K/V source
    in place of ``x`` (cross-attention at train and prefill). At
    self-attention decode the token's K/V are written into ``cache`` in
    place (the reference returns an updated copy); the returned cache is
    the same dict. Cross-attention at decode (``is_cross``) reads its
    cached encoder K/V over every row, projects no K/V and writes
    nothing. At prefill the new cache holds the sequence's (roped) K and
    V, or cross-attention's K/V of the encoder memory, (B, KV, S_kv, dh).
    RoPE applies to self-attention only, when ``use_rope`` and
    ``ctx.rope`` is set. On a mesh whose model axis cuts the heads, the
    rank runs its own q heads and the KV heads they read
    (:func:`repro_torch.models.parallel.local_heads`) and the output is
    summed over ``model``.
    """
    cfg = ctx.cfg
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, _ = x.shape
    dt = x.dtype
    decode = ctx.mode == "decode"
    wk, wv = p["wk"], p["wv"]
    heads = par.local_heads(ctx, H, KV)
    if heads is not None:
        if kv_input is not None and heads[0] != H:
            raise NotImplementedError("cross-attention on a model axis")
        H, KV, sel = heads
        x = par.copy_to_model(x, ctx.mesh)
        if sel is not None:
            wk, wv = (par.take_kv_heads(w, sel, dh, ctx.mesh)
                      for w in (wk, wv))

    q = (x @ p["wq"].to(dt)).reshape(B, S, H, dh)
    if not (is_cross and decode):
        src = x if kv_input is None else kv_input.to(dt)
        k = (src @ wk.to(dt)).reshape(B, src.shape[1], KV, dh)
        v = (src @ wv.to(dt)).reshape(B, src.shape[1], KV, dh)
    if use_rope and ctx.rope is not None and not is_cross:
        cos, sin = ctx.rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if decode:
        s_max = cache["k"].shape[2]
        if is_cross:       # the fixed encoder memory: every row, no write
            lengths = torch.full((B,), s_max, dtype=torch.int32,
                                 device=x.device)
        else:
            pos = ctx.positions                             # (B,)
            widx = (pos % s_max if window is not None
                    else pos.clamp(max=s_max - 1))
            bidx = torch.arange(B, device=x.device)
            cache["k"][bidx, :, widx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, :, widx] = v[:, 0].to(cache["v"].dtype)
            lengths = (pos + 1).clamp(max=s_max).to(torch.int32)
        o = ops.decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                                 lengths)
        new_cache = cache
    else:
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)       # (B, KV, S, dh)
        o = ops.flash_attention(q.transpose(1, 2), kh, vh, causal=causal,
                                window=window)
        new_cache = {"k": kh, "v": vh} if ctx.mode == "prefill" else None
    y = o.transpose(1, 2).reshape(B, S, H * dh) @ p["wo"].to(dt)
    if heads is not None:
        y = par.reduce_from_model(y, ctx.mesh)
    return y, new_cache


# --------------------------------------------------------------------------
# Dense MLPs.
# --------------------------------------------------------------------------

def spec_mlp(cfg) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    wi = (ParamSpec((d, 2 * f), ("embed", "mlp"), view=(None, (2, f, 1)))
          if cfg.mlp_kind == "swiglu" else ParamSpec((d, f), ("embed", "mlp")))
    return {"wi": wi, "wo": ParamSpec((f, d), ("mlp", "embed"))}


def apply_mlp(p, x, ctx: Ctx):
    """The dense MLP; on a mesh whose model axis cuts ``d_ff``, the rank's
    columns of ``wi`` (of the gate and of the up projection alike) and
    rows of ``wo``, the output summed over ``model``."""
    dt = x.dtype
    split = par.model_split(ctx, "mlp", ctx.cfg.d_ff)
    if split is not None:
        x = par.copy_to_model(x, ctx.mesh)
    h = x @ p["wi"].to(dt)
    if ctx.cfg.mlp_kind == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate.float()).to(dt) * up
    else:                             # jax.nn.gelu defaults to the tanh form
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    y = h @ p["wo"].to(dt)
    return y if split is None else par.reduce_from_model(y, ctx.mesh)


# --------------------------------------------------------------------------
# Top-k MoE with capacity-based dispatch (GShard-style, static shapes).
# --------------------------------------------------------------------------

def spec_moe(cfg) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None), scale=0.02),
        "wi": ParamSpec((E, d, 2 * f), ("experts", "embed", "mlp"),
                        view=(None, None, (2, f, 1))),
        "wo": ParamSpec((E, f, d), ("experts", "mlp", "embed")),
    }


def _route(probs, k: int, E: int, C: int):
    """Top-k routing over the last axis of ``probs`` (..., T, E), tokens
    in order along T: (gates renormalized over the top k, expert ids,
    keep, buffer slot), the last three (..., T, k). A (token, choice)
    takes its place in its expert's buffer by a cumulative count in
    (token, choice) order; past the capacity C it goes to the trash row
    E * C. ``torch.topk`` orders equal probabilities as it likes where
    ``jax.lax.top_k`` takes the lower expert first; with learned or
    random weights exact ties do not occur."""
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    *lead, T, _ = eidx.shape
    flat = F.one_hot(eidx, E).reshape(*lead, T * k, E)
    pos = flat.cumsum(dim=-2) - flat
    pos = (pos * flat).sum(-1).reshape(*lead, T, k)
    keep = pos < C
    slot = torch.where(keep, eidx * C + pos, E * C)
    return gate, eidx, keep, slot


def _experts(p, buf, dt):
    """The experts' SwiGLU on their buffers (..., E, C, d)."""
    h = torch.einsum("...ecd,edf->...ecf", buf, p["wi"].to(dt))
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g.float()).to(dt) * u
    return torch.einsum("...ecf,efd->...ecd", h, p["wo"].to(dt))


def _switch_aux(probs, eidx, E: int):
    """The Switch load-balancing term E * sum(mean(probs) * mean(one_hot
    of the first choice)), the means over every token."""
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(eidx[..., 0].reshape(-1), E).float().mean(0)
    return E * (me * ce).sum()


def apply_moe(p, x, ctx: Ctx):
    """Token-dropping top-k dispatch (the reference's ``apply_moe``), in
    one of two layouts (``ctx.moe_dispatch``):

    * ``global``: one (E, C, d) buffer for all B*S tokens,
      C = ceil(B*S*k/E * capacity_factor);
    * ``batch_local``: a (B, E, C, d) buffer, each batch row dispatched
      on its own, C = ceil(S*k/E * capacity_factor).

    Dropped (token, choice) pairs contribute zero (``gate * keep``).
    Returns (y (B, S, d), the Switch aux term, f32). The expert products
    are batched matmuls over the buffer, as the reference's einsums."""
    cfg = ctx.cfg
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    local = ctx.moe_dispatch == "batch_local"
    if not local and ctx.moe_dispatch != "global":
        raise ValueError(f"moe_dispatch must be 'global' or 'batch_local', "
                         f"got {ctx.moe_dispatch!r}")
    C = max(1, int(math.ceil((S if local else B * S) * k / E
                             * cfg.capacity_factor)))
    dt = x.dtype
    xt = x if local else x.reshape(1, B * S, d)          # (R, T, d)
    R, T = xt.shape[0], xt.shape[1]

    logits = (xt @ p["router"].to(dt)).float()            # (R, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx, keep, slot = _route(probs, k, E, C)

    xrep = xt.repeat_interleave(k, dim=1)                 # (R, T*k, d)
    idx = slot.reshape(R, T * k, 1).expand(R, T * k, d)
    buf = torch.zeros((R, E * C + 1, d), dtype=dt, device=x.device)
    buf = buf.scatter_add(1, idx, xrep)[:, :-1].reshape(R, E, C, d)
    out_buf = _experts(p, buf, dt).reshape(R, E * C, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((R, 1, d))], dim=1)
    y = out_buf.gather(1, idx).reshape(R, T, k, d)
    y = (y * (gate * keep).to(dt)[..., None]).sum(dim=2)
    return y.reshape(B, S, d), _switch_aux(probs, eidx, E)


# --------------------------------------------------------------------------
# Mamba-2 block.
# --------------------------------------------------------------------------

def spec_mamba2(cfg) -> Dict:
    d = cfg.d_model
    di, H, _, N = mamba_dims(cfg)
    return {
        "w_in": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamSpec((4, di), ("conv_k", "inner"), scale=0.5),
        "w_bc": ParamSpec((di, 2 * N), ("inner", "state")),
        "w_dt": ParamSpec((di, H), ("inner", None), scale=0.02),
        "dt_bias": ParamSpec((H,), (None,), "zeros"),
        "a_log": ParamSpec((H,), (None,), "zeros"),
        "d_skip": ParamSpec((H,), (None,), "ones"),
        "w_out": ParamSpec((di, d), ("inner", "embed")),
    }


def mamba_dims(cfg):
    """(d_inner, heads H, head channels P = 64, state size N)."""
    di = cfg.d_inner
    H = di // min(64, di)
    return di, H, di // H, cfg.ssm_state or 64


def apply_mamba2(p, x, ctx: Ctx, cache=None):
    """x: (B, S, d). cache: {'conv': (B, 3, di), 'h': (B, H, P, N) f32}
    for decode, updated in place (the reference returns a copy). At
    prefill the new cache holds the last 3 inputs of the conv (zero-padded
    on the left for prompts shorter than 3) and the scan's final state.
    ``conv_w``, ``dt_bias`` and ``a_log`` are read in f32."""
    di, H, P, N = mamba_dims(ctx.cfg)
    B, S, _ = x.shape
    dt_ = x.dtype

    xs, z = (x @ p["w_in"].to(dt_)).chunk(2, dim=-1)        # (B, S, di)
    conv_w = p["conv_w"].float()                            # (4, di)
    if ctx.mode == "decode":
        hist = torch.cat([cache["conv"].to(dt_), xs], dim=1)    # (B, 4, di)
        xc = torch.einsum("bkd,kd->bd", hist.float(), conv_w)[:, None, :]
    else:
        pad = F.pad(xs.float(), (0, 0, 3, 0))
        xc = sum(pad[:, i:i + S] * conv_w[i] for i in range(4))
    xc = F.silu(xc).to(dt_)

    bmat, cmat = (xc @ p["w_bc"].to(dt_)).chunk(2, dim=-1)  # (B, S, N) each
    dt_pre = xc @ p["w_dt"].to(dt_)                         # (B, S, H)
    dtv = F.softplus(dt_pre.float() + p["dt_bias"].float())
    xh = xc.reshape(B, S, H, P)

    if ctx.mode == "decode":
        y, h_new = ops.mamba_decode_step(cache["h"], xh[:, 0], dtv[:, 0],
                                         p["a_log"], bmat[:, 0], cmat[:, 0])
        y = y[:, None]                                      # (B, 1, H, P)
        cache["conv"].copy_(hist[:, 1:])
        cache["h"].copy_(h_new)
        new_cache = cache
    else:
        y, h_final = ops.mamba_scan(xh, dtv, p["a_log"], bmat, cmat,
                                    chunk=ctx.mamba_chunk)
        new_cache = None
        if ctx.mode == "prefill":
            tail = F.pad(xs, (0, 0, 3, 0))[:, S:S + 3]
            new_cache = {"conv": tail, "h": h_final}
    y = y + xh * p["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, di) * F.silu(z.float()).to(dt_)
    return y @ p["w_out"].to(dt_), new_cache


# --------------------------------------------------------------------------
# xLSTM blocks.
# --------------------------------------------------------------------------

def spec_mlstm(cfg) -> Dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "w_qkv": ParamSpec((d, 3 * di), ("embed", "inner")),
        "w_if": ParamSpec((d, 2 * H), ("embed", None), scale=0.02),
        "b_if": ParamSpec((2 * H,), (None,), "zeros"),
        "w_out": ParamSpec((di, d), ("inner", "embed")),
    }


def apply_mlstm(p, x, ctx: Ctx, cache=None):
    """x: (B, S, d). cache: (C (B,H,P,P), n (B,H,P), m (B,H)) f32 for
    decode, updated in place (the reference returns a copy). At prefill
    the new cache is the scan's final state. ``b_if`` is read in f32."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    di, H = cfg.d_inner, cfg.n_heads
    P = di // H
    dt_ = x.dtype

    q, k, v = (t.reshape(B, S, H, P)
               for t in (x @ p["w_qkv"].to(dt_)).chunk(3, dim=-1))
    gates = (x @ p["w_if"].to(dt_)).float() + p["b_if"].float()
    i_pre, f_pre = gates.chunk(2, dim=-1)                   # (B, S, H)

    if ctx.mode == "decode":
        h, state = ops.mlstm_decode_step(
            cache, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
        for dst, src in zip(cache, state):
            dst.copy_(src)
        h = h[:, None]
        new_cache = cache
    else:
        h, state = ops.mlstm_scan(q, k, v, i_pre, f_pre,
                                  chunk=ctx.mlstm_chunk)
        new_cache = state if ctx.mode == "prefill" else None
    return h.reshape(B, S, di) @ p["w_out"].to(dt_), new_cache


def spec_slstm(cfg) -> Dict:
    d = cfg.d_model
    return {
        "w_x": ParamSpec((d, 4 * d), ("embed", "mlp")),
        "w_h": ParamSpec((d, 4 * d), ("embed", "mlp")),
        "bias": ParamSpec((4 * d,), ("mlp",), "zeros"),
    }


def apply_slstm(p, x, ctx: Ctx, cache=None):
    """Sequential scalar LSTM with exponential gating, all in f32 (its
    weights too); only the output is cast to the activation dtype.
    cache: (c, n, h, m) each (B, d) f32 for decode, updated in place. At
    prefill the new cache is the recurrence's final state."""
    B, S, d = x.shape
    xproj = x.float() @ p["w_x"].float() + p["bias"].float()   # (B, S, 4d)
    if cache is None:
        zeros = lambda: torch.zeros((B, d), dtype=torch.float32,
                                    device=x.device)
        state0 = (zeros(), zeros(), zeros(),
                  torch.full((B, d), -1e30, dtype=torch.float32,
                             device=x.device))
    else:
        state0 = tuple(t.float() for t in cache)
    hs, state = ops.slstm_scan(xproj, p["w_h"].float(), *state0)
    new_cache = None
    if ctx.mode == "decode":
        for dst, src in zip(cache, state):
            dst.copy_(src)
        new_cache = cache
    elif ctx.mode == "prefill":
        new_cache = state
    return hs.to(x.dtype), new_cache
