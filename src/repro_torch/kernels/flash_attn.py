"""Flash-attention forward (prefill): the hand-written Hopper kernel
``csrc/flash_attn_fwd.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py``
(``flash_attention_fwd``, ``pallas_call`` at line 126). On the H100 it is
bounded by the causal score and PV products (989 TFLOP/s of bf16 tensor
cores); the kernel's design and why it does not reach that bound yet are
in the source's header.

:func:`flash_attention_fwd` launches the kernel on CUDA tensors only and
counts its launches in ``flash_attention_fwd.launches``; the dispatch by
device is in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """The plain version: full materialization in f32."""
    return ref.attention(q, k, v, causal=causal, window=window)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, H, Sq, D); k, v: (B, KV, Skv, D) on one CUDA device, bf16 or
    f32, D in HEAD_DIMS. Returns (B, H, Sq, D) in q's dtype."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd needs q, k, v on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS or k.shape != (B, KV, Skv, D) or v.shape != k.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd needs 16-byte aligned inputs")
    o = torch.empty_like(q)
    if o.numel() == 0 or Skv == 0:
        return o.zero_()
    fn = _build.load("flash_attn_fwd").flash_attn_fwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Skv, D, int(causal), window or 0,
                 1.0 / math.sqrt(D), DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
