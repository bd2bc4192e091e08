"""Flash-attention forward (prefill): the hand-written Hopper kernel
``csrc/flash_attn_fwd.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py``
(``flash_attention_fwd``, ``pallas_call`` at line 126). On the H100 it is
bounded by the causal score and PV products (989 TFLOP/s of bf16 tensor
cores); the kernel's design and why it does not reach that bound yet are
in the source's header.

:func:`flash_attention_fwd` launches the kernel on CUDA tensors only and
counts its launches in ``flash_attention_fwd.launches``; the dispatch by
device is in :mod:`repro_torch.kernels.ops`. With ``lse=True`` the kernel
also writes each row's log-sum-exp, which :class:`FlashAttention` (the
autograd Function of training on the card) saves for its backward,
:func:`flash_attention_bwd_plain`. That backward is plain PyTorch: it is
the port of the reference's jnp backward (``repro/kernels/ops.py``,
``_chunked_attention_bwd``), since the reference has no Pallas backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = ref.NEG_INF     # the lse of a row that sees no key
BLOCK = 512               # the backward's q and k blocks (Ctx.block_q/_k)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """The plain version: full materialization in f32."""
    return ref.attention(q, k, v, causal=causal, window=window)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None):
    """The plain version of the kernel with ``lse=True``: (o in q's dtype,
    lse f32 (B, H, Sq)), lse = m + log(max(l, 1e-30)) with m = -1e30 for
    a row that sees no key."""
    return ref.attention(q, k, v, causal=causal, window=window,
                         return_lse=True)


def _kv_range(qi: int, n_kv: int, *, causal: bool, window: Optional[int],
              block_q: int, block_k: int):
    """Static KV block range [lo, hi) in the band of q block qi (the
    reference's ``_kv_range``)."""
    hi = n_kv
    if causal:
        hi = min(n_kv, ((qi + 1) * block_q + block_k - 1) // block_k)
    lo = 0
    if window is not None:
        lo = max(0, (qi * block_q - window + 1) // block_k)
    return lo, hi


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None):
    """The attention backward from the forward's output and lse, the port
    of the reference's ``_chunked_attention_bwd``: q blocks of BLOCK rows
    against the k blocks of their band only (the static triangular and
    window skipping), so no (Sq, Skv) score matrix of the whole sequence
    is formed; the probabilities are recomputed as exp(s - lse), and
    delta = sum(dO * O) per row. dk and dv sum over the H / KV q heads of
    each group. Computes in f32; returns (dq, dk, dv) in the inputs'
    dtypes. q, o, do: (B, H, Sq, D); k, v: (B, KV, Skv, D); lse: (B, H,
    Sq) f32."""
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    grp = lambda t: t.float().reshape(B, KV, g, Sq, -1)
    qf, dof = grp(q), grp(do)
    lsef = lse.float().reshape(B, KV, g, Sq, 1)
    delta = (dof * grp(o)).sum(dim=-1, keepdim=True)
    kf, vf = k.float(), v.float()
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    bq, bk = min(BLOCK, Sq), min(BLOCK, Skv)
    n_q, n_kv = -(-Sq // bq) if Sq else 0, -(-Skv // bk) if Skv else 0
    for qi in range(n_q):
        lo, hi = _kv_range(qi, n_kv, causal=causal, window=window,
                           block_q=bq, block_k=bk)
        q0, q1 = qi * bq, min((qi + 1) * bq, Sq)
        k0, k1 = lo * bk, min(hi * bk, Skv)
        if k1 <= k0:
            continue
        qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb) * scale
        band = ref.band_mask(q1 - q0, k1 - k0, q0=q0, k0=k0, causal=causal,
                             window=window, device=q.device)
        p = torch.where(band, torch.exp(s - lsef[:, :, :, q0:q1]), 0.0)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dob, vb)
        ds = p * (dp - delta[:, :, :, q0:q1]) * scale
        dq[:, :, :, q0:q1] += torch.einsum("bkgqc,bkcd->bkgqd", ds, kb)
        dk[:, :, k0:k1] += torch.einsum("bkgqc,bkgqd->bkcd", ds, qb)
        dv[:, :, k0:k1] += torch.einsum("bkgqc,bkgqd->bkcd", p, dob)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, KV, Skv, D) on one CUDA device, bf16 or
    f32, D in HEAD_DIMS. Returns (B, H, Sq, D) in q's dtype, and with
    ``lse`` also each row's log-sum-exp, f32 (B, H, Sq), from the same
    launch."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd needs q, k, v on one CUDA device")
    return _call(q, k, v, causal=causal, window=window, lse=lse, launch=True)


def flash_attention_fwd_meta(q, k, v, *, causal: bool = True,
                             window: Optional[int] = None, lse: bool = False):
    """:func:`flash_attention_fwd` on meta tensors: its checks and its
    allocations, without the launch (the census's dry run)."""
    if not all(t.is_meta for t in (q, k, v)):
        raise ValueError("flash_attention_fwd_meta needs meta tensors")
    return _call(q, k, v, causal=causal, window=window, lse=lse, launch=False)


def _call(q, k, v, *, causal, window, lse, launch):
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
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
    m = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
         if lse else None)
    if o.numel() == 0 or Skv == 0:
        o.zero_()
        return (o, m.fill_(NEG_INF)) if lse else o
    if launch:
        fn = _build.load("flash_attn_fwd").flash_attn_fwd
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     m.data_ptr() if lse else None, B, H, KV, Sq, Skv, D,
                     int(causal), window or 0, 1.0 / math.sqrt(D),
                     DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
        flash_attention_fwd.launches += 1
    return (o, m) if lse else o


flash_attention_fwd.launches = 0


def _pairs(Sq, Skv, causal, window):
    """The (q, k) pairs one head attends: the causal band of Sq rows
    (within the window if any), or all Sq x Skv pairs without the band."""
    if not causal:
        return Sq * Skv
    w = Sq if window is None else min(window, Sq)
    return w * (w + 1) // 2 + (Sq - w) * w


def work(q, k, *, causal: bool = True, window: Optional[int] = None,
         lse: bool = False):
    """(bytes, operations) of one launch on q (B, H, Sq, D) and k, v (B,
    KV, Skv, D): q, k and v read once, o (and with ``lse`` the f32 lse)
    written once; q.k^T and p.v over the band's pairs, 4 D operations a
    pair and head."""
    B, H, Sq, D = q.shape
    nbytes = ((2 * q.numel() + 2 * k.numel()) * q.element_size()
              + (4 * B * H * Sq if lse else 0))
    return nbytes, 4 * D * H * B * _pairs(Sq, k.shape[2], causal, window)


def bwd_work(q, k, *, causal: bool = True, window: Optional[int] = None):
    """(bytes, operations) of :func:`flash_attention_bwd_plain`: it reads
    q, k, v, o, dO and lse and writes dq, dk, dv once; it recomputes the
    scores and takes dP, dV, dQ and dK, 10 D operations a pair and head."""
    B, H, Sq, D = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * B * H * Sq
    return nbytes, 10 * D * H * B * _pairs(Sq, k.shape[2], causal, window)


def _kernel_with_lse(q, k, v, *, causal, window):
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               lse=True)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is ``forward_fn`` (the
    kernel with its lse on the card; a test passes
    :func:`flash_attention_lse_plain` to run the same backward on the
    CPU), which saves (q, k, v, o, lse); the backward is
    :func:`flash_attention_bwd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, forward_fn):
        o, lse = forward_fn(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_grad(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         forward_fn=_kernel_with_lse):
    """Differentiable attention: :class:`FlashAttention` over the kernel
    (one launch, with lse) or over ``forward_fn``."""
    return FlashAttention.apply(q, k, v, causal, window, forward_fn)
