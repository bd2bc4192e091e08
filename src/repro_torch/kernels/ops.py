"""Public kernel ops, dispatched by the device of their input: a CUDA
tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor takes the kernel's plain PyTorch version. There is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import ref
from repro_torch.kernels import split_quant as _quant


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B,H,Sq,D); k,v: (B,KV,Skv,D) -> (B,H,Sq,D)."""
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    return _flash.flash_attention_fwd(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (B,H,1,D); k,v: (B,KV,S,D); lengths: (B,) -> (B,H,1,D)."""
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)


def mamba_scan(x, dt, a_log, b, c, *, chunk: int = 128):
    """Mamba-2 SSD chunked scan. x: (B,S,H,P); dt: (B,S,H); a_log: (H,);
    b, c: (B,S,N) -> (y (B,S,H,P), h_final (B,H,P,N) f32)."""
    if x.device.type == "cpu":
        return _mamba.mamba_chunk_scan_plain(x, dt, a_log, b, c, chunk=chunk)
    return _mamba.mamba_chunk_scan(x, dt, a_log, b, c, chunk=chunk)


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


def quantize_boundary(x):
    """Per-row int8 quantization of a tensor flattened to (-1, last dim):
    returns q int8 of ``x.shape`` and scale f32 of ``x.shape[:-1] + (1,)``.
    An NHWC boundary gives one row per pixel, as in the reference."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        q, s = _quant.quantize_rows_plain(x2)
    else:
        q, s = _quant.quantize_rows(x2)
    return q.reshape(shape), s.reshape(shape[:-1] + (1,))


def dequantize_boundary(q, s, dtype=torch.float32):
    return ref.dequantize_rows(q, s, dtype)


class _STEQuantize(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x):
        q, s = quantize_boundary(x)
        return dequantize_boundary(q, s, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_quantize(x):
    """Quantize-dequantize with straight-through gradients (training)."""
    return _STEQuantize.apply(x)
