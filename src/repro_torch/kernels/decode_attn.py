"""Flash-decode attention: the hand-written Hopper kernel
``csrc/decode_attn.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attn.py``
(``decode_attention``, ``pallas_call`` at line 88). On the H100 it is
bounded by reading the valid K and V cache rows once (3.35 TB/s). It is
split-KV flash-decoding: one block per (split of the cache rows, KV
head, batch row) serves every query head of the group, so each row is
read once per KV head rather than once per query head, and writes a
partial softmax record (m, l, acc) per query head; the last block of
each (KV head, batch row) to finish merges the records in split order,
so the result is deterministic. The design is in the source's header.

:func:`decode_attention` launches the kernel on CUDA tensors only and
counts its launches in ``decode_attention.launches``; the dispatch by
device is in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8                    # query heads per KV head (MAXG in the source)
SPLIT_BYTES = 32768              # most bytes of K (and of V) per block
SPLIT_ROWS = 256                 # most cache rows per block


def split_rows(D, dtype):
    """Cache rows per block: 256, or fewer where 256 rows pass 32 KB of K
    (two passes of the block's 256 threads x 4 loads of 16 bytes); 256
    rows at bf16, D = 64."""
    return min(SPLIT_ROWS,
               SPLIT_BYTES // (D * (2 if dtype == torch.bfloat16 else 4)))


def n_splits(S, D, dtype):
    """Blocks per (KV head, batch row) on a cache of S rows."""
    return -(-S // split_rows(D, dtype))


def scratch_words(B, H, KV, S, D, dtype):
    """32-bit words of scratch: the partial records, (m, l) and acc per
    split, batch row and query head, then a counter per (batch row, KV
    head)."""
    return B * H * n_splits(S, D, dtype) * (D + 2) + B * KV


def decode_attention_plain(q, k, v, lengths):
    """The plain version, one masked pass over the cache in f32 (the
    reference's jnp path, ``repro/kernels/ops.py::decode_attention``)."""
    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    qr = q.reshape(B, KV, g, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", qr, k.float()) * (1.0 / math.sqrt(D))
    kpos = torch.arange(S, device=q.device)
    s = s.masked_fill(kpos >= lengths.to(q.device).reshape(B, 1, 1, 1), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, H, 1, D).to(q.dtype)


def decode_attention(q, k, v, lengths):
    """q: (B, H, 1, D); k, v: (B, KV, S, D); lengths: (B,) valid rows per
    batch row, all on one CUDA device. Returns (B, H, 1, D) in q's dtype.
    Decode is never differentiated (nor in the reference): under grad mode
    an input that requires grad raises, rather than an output without a
    graph."""
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and lengths.device == dev):
        raise ValueError("decode_attention needs q, k, v, lengths on one "
                         "CUDA device")
    return _call(q, k, v, lengths, launch=True)


def decode_attention_meta(q, k, v, lengths):
    """:func:`decode_attention` on meta tensors: its checks and its
    allocations, without the launch (the census's dry run)."""
    if not all(t.is_meta for t in (q, k, v, lengths)):
        raise ValueError("decode_attention_meta needs meta tensors")
    return _call(q, k, v, lengths, launch=False)


def _call(q, k, v, lengths, *, launch):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no gradient: call it under "
                           "torch.no_grad() or on inputs without grad")
    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.shape != (B, H, 1, D) or D not in HEAD_DIMS
            or k.shape != (B, KV, S, D) or v.shape != k.shape
            or lengths.shape != (B,)):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, lengths {tuple(lengths.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H}, KV={KV}: need H % KV == 0 and "
                         f"H // KV <= {MAX_GROUP}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention needs 16-byte aligned inputs")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if S == 0:                     # no cache row: 0, as the reference's kernel
        return o.zero_()
    scratch = torch.empty(scratch_words(B, H, KV, S, D, q.dtype),
                          dtype=torch.float32, device=dev)
    if launch:
        fn = _build.load("decode_attn").decode_attn
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), o.data_ptr(), scratch.data_ptr(), B,
                     H, KV, S, D, split_rows(D, q.dtype), 1.0 / math.sqrt(D),
                     DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_attn launch failed: CUDA error {err}")
        decode_attention.launches += 1
    return o


def work(q, k, rows):
    """(bytes, operations) of one launch on q (B, H, 1, D) and k, v (B,
    KV, S, D) holding ``rows`` valid cache rows in all (the sum of
    ``lengths``): q read and o written once, the int32 lengths, and the
    valid K and V rows read once per KV head; q.k^T and p.v over the
    valid rows, 4 D operations a row and query head."""
    B, H, _, D = q.shape
    KV, elt = k.shape[1], k.element_size()
    return (2 * q.numel() * elt + 4 * B + 2 * rows * KV * D * elt,
            4 * D * H * rows)


decode_attention.launches = 0
