"""Plain PyTorch oracles (full materialization, fp32 math): the port's
copy of ``repro/kernels/ref.py`` for the attention kernels, the Mamba-2
SSD scan, the xLSTM mLSTM recurrence and the SL boundary quantizer. The decode oracle is the same attention function
with ``causal=False`` and the per-batch valid lengths in ``kv_len``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


NEG_INF = -1e30           # lse of a row that sees no key


def band_mask(Sq: int, Skv: int, *, q0: int = 0, k0: int = 0,
              causal: bool = True, window: Optional[int] = None,
              device=None):
    """(Sq, Skv) bool: key k0 + j is in the band of query q0 + i."""
    qpos = torch.arange(q0, q0 + Sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None,
              kv_len: Optional[torch.Tensor] = None,
              q_offset: int = 0, return_lse: bool = False):
    """Naive softmax attention with GQA.

    q: (B, H, Sq, D); k, v: (B, KV, Skv, D) with H % KV == 0.
    ``q_offset``: absolute position of q[0]. ``kv_len``: (B,) valid cache
    lengths; None = all valid. Rows with no valid key give 0. With
    ``return_lse`` also each row's log-sum-exp of the scaled scores, f32
    (B, H, Sq): m + log(max(l, 1e-30)), with m = -1e30 for a row with no
    valid key (the flash kernel's lse).
    """
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(D)

    dev = q.device
    mask = band_mask(Sq, Skv, q0=q_offset, causal=causal, window=window,
                     device=dev)[None]
    if kv_len is not None:
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = mask & (kpos < kv_len.reshape(-1, 1, 1).to(dev))
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)             # empty rows
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if not return_lse:
        return o
    m = s.amax(dim=-1).clamp(min=NEG_INF)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return o, m + torch.log(torch.clamp(l, min=1e-30))


def decode_attention(q, k, v, lengths):
    """Decode oracle: one query per batch row against a cache whose first
    ``lengths[b]`` rows are valid. q: (B, H, 1, D); k, v: (B, KV, S, D)."""
    return attention(q, k, v, causal=False, kv_len=lengths)


def mamba_ssd(x, dt, a_log, b, c, h0=None):
    """Sequential Mamba-2 SSD oracle, fp32:
    h_t = exp(a*dt_t) h_{t-1} + dt_t * (x_t ⊗ b_t);  y_t = h_t c_t.

    x: (B, S, H, P); dt: (B, S, H) positive steps; a_log: (H,) with
    A = -exp(a_log); b, c: (B, S, N) shared across heads; h0: (B, H, P, N)
    initial state or None (zeros). Returns (y in x's dtype, h_final f32).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    a = -torch.exp(a_log.float())                                # (H,)
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(a[None] * dtf[:, t])                   # (B, H)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * bf[:, t, None, None, :])                        # (B,H,P,N)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), h


def mlstm(q, k, v, i_pre, f_pre, state=None):
    """Sequential stabilized mLSTM oracle (xLSTM eq. 19-27), fp32:
    C_t = f_t C_{t-1} + i_t k_t v_t^T, n_t = f_t n_{t-1} + i_t k_t,
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t)), with log f = log
    sigmoid(f_pre), log i = i_pre and q scaled by 1/sqrt(P).

    q, k, v: (B, S, H, P); i_pre, f_pre: (B, S, H). state: (C (B,H,P,P),
    n (B,H,P), m (B,H)) or None (zeros, m = -1e30). Returns (h in q's
    dtype, (C, n, m) f32).
    """
    B, S, H, P = q.shape
    qf = q.float() * (1.0 / math.sqrt(P))
    kf, vf = k.float(), v.float()
    log_i = i_pre.float()
    log_f = -torch.nn.functional.softplus(-f_pre.float())
    if state is None:
        C = torch.zeros((B, H, P, P), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, P), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = (t.float() for t in state)
    hs = []
    for t in range(S):
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        fs = torch.exp(lf + m - m_new)[..., None]
        iz = torch.exp(li - m_new)[..., None]
        C = fs[..., None] * C + iz[..., None] * (kf[:, t, :, :, None]
                                                 * vf[:, t, :, None, :])
        n = fs * n + iz * kf[:, t]
        num = torch.einsum("bhkv,bhk->bhv", C, qf[:, t])
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf[:, t]).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1) if hs else qf.new_zeros((B, 0, H, P))
    return h.to(q.dtype), (C, n, m)


def quantize_rows(x):
    """Per-row symmetric int8: returns (q int8, scale fp32 per row).
    Both divisions are IEEE divisions, as in the reference: the divisor
    127 is a tensor because PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which rounds differently."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)
