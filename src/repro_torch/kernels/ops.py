"""Public kernel ops, dispatched by the device of their input: a CUDA
tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor takes the kernel's plain PyTorch version. There is no fallback
from one to the other.

On the card the scans (B4, B5) always go through their autograd
Functions (the kernel forward, the plain scan's gradient by recompute;
without grad the Function launches the same kernel and adds nothing).
Attention (B2) takes its Function (the kernel forward with its lse, the
plain backward) only when an input requires grad under grad mode, since
the lse write costs time; otherwise the kernel runs without lse. Decode
attention (B3) raises under grad. The plain CPU versions are differentiable as
they are. A meta tensor (shape-only metering, ``sl_step.boundary_bits``)
takes the plain version too: nothing is computed.

While a :class:`repro_torch.utils.census.Census` counts, it is
``census`` here, and each kernel op (and the sLSTM recurrence) hands its
call to it; otherwise that is one check of a module global a call.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import ref
from repro_torch.kernels import split_quant as _quant


census = None       # the counting Census, set while one is entered


def _plain(t) -> bool:
    return t.device.type in ("cpu", "meta")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B,H,Sq,D); k,v: (B,KV,Skv,D) -> (B,H,Sq,D)."""
    if census is not None:
        return census.flash_attention(q, k, v, causal=causal, window=window)
    if _plain(q):
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    return flash_card(q, k, v, causal=causal, window=window)


def flash_card(q, k, v, *, causal: bool = True,
               window: Optional[int] = None,
               kernel=_flash.flash_attention_fwd):
    """The card's attention over ``kernel`` (B2's wrapper, or a census's
    span of it): its autograd Function with lse when an input requires
    grad under grad mode, else the kernel alone."""
    if _needs_grad(q, k, v):
        return _flash.flash_attention_grad(
            q, k, v, causal=causal, window=window,
            forward_fn=functools.partial(kernel, lse=True))
    return kernel(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (B,H,1,D); k,v: (B,KV,S,D); lengths: (B,) -> (B,H,1,D)."""
    if census is not None:
        return census.decode_attention(q, k, v, lengths)
    if _plain(q):
        return _decode.decode_attention_plain(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)


def mamba_scan(x, dt, a_log, b, c, *, chunk: int = 128):
    """Mamba-2 SSD chunked scan. x: (B,S,H,P); dt: (B,S,H); a_log: (H,);
    b, c: (B,S,N) -> (y (B,S,H,P), h_final (B,H,P,N) f32)."""
    if census is not None:
        return census.mamba_scan(x, dt, a_log, b, c, chunk=chunk)
    if _plain(x):
        return _mamba.mamba_chunk_scan_plain(x, dt, a_log, b, c, chunk=chunk)
    return _mamba.mamba_scan_grad(x, dt, a_log, b, c, chunk=chunk)


def mamba_decode_step(h, x_t, dt_t, a_log, b_t, c_t):
    """Single-token SSD state update (plain PyTorch on every device, as
    the reference's is jnp). h: (B,H,P,N) f32; x_t: (B,H,P); dt_t: (B,H);
    b_t, c_t: (B,N). Returns (y_t (B,H,P) in x_t's dtype, h_new)."""
    a = -torch.exp(a_log.float())
    decay = torch.exp(a[None] * dt_t.float())                     # (B,H)
    upd = (dt_t[..., None, None] * x_t[..., None].float()
           * b_t[:, None, None, :].float())
    h = h * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, c_t.float())
    return y.to(x_t.dtype), h


def mlstm_scan(q, k, v, i_pre, f_pre, *, chunk: int = 256):
    """xLSTM mLSTM chunkwise scan. q, k, v: (B,S,H,P); i_pre, f_pre:
    (B,S,H) f32 -> (h (B,S,H,P), (C (B,H,P,P), n (B,H,P), m (B,H)) f32)."""
    if census is not None:
        return census.mlstm_scan(q, k, v, i_pre, f_pre, chunk=chunk)
    if _plain(q):
        return _mlstm.mlstm_chunk_scan_plain(q, k, v, i_pre, f_pre,
                                             chunk=chunk)
    return _mlstm.mlstm_scan_grad(q, k, v, i_pre, f_pre, chunk=chunk)


def mlstm_decode_step(state, q_t, k_t, v_t, i_t, f_t):
    """Single-token mLSTM update (plain PyTorch on every device, as the
    reference's is jnp). state = (C (B,H,P,P), n (B,H,P), m (B,H)) f32;
    q_t, k_t, v_t: (B,H,P); i_t, f_t: (B,H). Returns (h_t (B,H,P) in
    q_t's dtype, new state)."""
    C, n, m = state
    qf = q_t.float() * (1.0 / math.sqrt(q_t.shape[-1]))
    kf, vf = k_t.float(), v_t.float()
    li = i_t.float()
    lf = -F.softplus(-f_t.float())
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    iz = torch.exp(li - m_new)
    C = fs[..., None, None] * C + iz[..., None, None] * (
        kf[..., None] * vf[..., None, :])
    n = fs[..., None] * n + iz[..., None] * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q_t.dtype), (C, n, m_new)


def slstm_scan(xproj, wh, c0, n0, h0, m0):
    """Stabilized exponential-gating sLSTM, token by token (a true
    recurrence; the reference has no kernel for it either). xproj:
    (B,S,4d) input projections plus bias; wh: (d,4d); c0, n0, h0, m0:
    (B,d), all f32. Returns (h (B,S,d), (c, n, h, m))."""
    if census is not None:
        return census.slstm_scan(xproj, wh, c0, n0, h0, m0)
    return slstm_loop(xproj, wh, c0, n0, h0, m0)


def slstm_loop(xproj, wh, c0, n0, h0, m0, steps: Optional[int] = None):
    """:func:`slstm_scan`'s token loop; ``steps`` runs only the first
    tokens (the census counts a few to extrapolate)."""
    c, n, h, m = c0, n0, h0, m0
    hs = []
    for t in range(xproj.shape[1] if steps is None else steps):
        zt, it, ft, ot = (xproj[:, t] + h @ wh).chunk(4, dim=-1)
        lf = -F.softplus(-ft)
        m_new = torch.maximum(lf + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(zt)
        n = torch.maximum(f_s * n + i_s, torch.exp(-m_new))
        h = torch.sigmoid(ot) * (c / n)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def quantize_boundary(x):
    """Per-row int8 quantization of a tensor flattened to (-1, last dim):
    returns q int8 of ``x.shape`` and scale f32 of ``x.shape[:-1] + (1,)``.
    An NHWC boundary gives one row per pixel, as in the reference; on the
    card the kernel reads a strided boundary as it lies (no copy)."""
    if census is not None:
        q, s = census.quantize_rows(x)
    elif _plain(x):
        q, s = _quant.quantize_rows_plain(x)
    else:
        q, s = _quant.quantize_rows(x)
    return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))


def dequantize_boundary(q, s, dtype=torch.float32):
    return ref.dequantize_rows(q, s, dtype)


class _STEQuantize(torch.autograd.Function):
    """Quantize-dequantize forward (one kernel launch on the card, the
    result in x's strides), straight-through backward."""

    @staticmethod
    def forward(ctx, x):
        if census is not None:
            return census.quantize_dequantize(x)
        if _plain(x):
            return _quant.quantize_dequantize_plain(x)
        return _quant.quantize_dequantize(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_quantize(x):
    """Quantize-dequantize with straight-through gradients (training)."""
    return _STEQuantize.apply(x)
