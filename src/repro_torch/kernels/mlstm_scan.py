"""xLSTM mLSTM chunkwise scan: the hand-written Hopper kernel
``csrc/mlstm_scan.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_scan.py``
(``mlstm_chunk_scan``, ``pallas_call`` at line 129). Per (batch, head)
the stabilized mLSTM recurrence C_t = f_t C_{t-1} + i_t k_t v_t^T is
computed chunk by chunk: within a chunk it is a decay-masked L x L
attention-like product, and the P x P matrix memory C, the normalizer n
and the scalar stabilizer m carry from chunk to chunk. The chunk's row
stabilizers equal the sequential ones exactly, so the chunkwise form is
exact up to rounding for any chunk length. On the H100 the kernel's
operations bound it (xLSTM-1.3B's P = 1024 makes the two products per
chunk large). In bf16 it runs three launches with every product on the
tensor cores (one q.k^T per chunk, C held in registers); in f32 one
launch of f32 FMAs. The design is in the source's header, its times in
PERF.md.

:func:`mlstm_chunk_scan` launches the kernel on CUDA tensors only and
counts its launches in ``mlstm_chunk_scan.launches``; the dispatch by
device is in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
L_MAX = 64                # the kernel's longest chunk (L_MAX in the source)
# Scratch of the bf16 path, 32-bit words per (batch, head, chunk): W's
# tensor-core fragments and the chunk's per-position scalars (REC in the
# source).
SCRATCH_WORDS = 5440


def mlstm_chunk_scan_plain(q, k, v, i_pre, f_pre, *, chunk: int = 256):
    """The plain version, chunk by chunk in f32: the reference's jnp path
    (``repro/kernels/ops.py::_mlstm_chunked_jnp``). The padded tail of
    the last chunk has f = 1 and i = -1e30 (no update) and zero data.
    Returns (h in q's dtype (B, S, H, P), (C (B, H, P, P), n (B, H, P),
    m (B, H)) f32)."""
    B, S, H, P = q.shape
    dev = q.device
    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    if S == 0:
        return torch.empty_like(q), (C, n, m)
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    blk = lambda t: F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
    qf = blk(q).reshape(B, nc, L, H, P) * (1.0 / math.sqrt(P))
    kf = blk(k).reshape(B, nc, L, H, P)
    vf = blk(v).reshape(B, nc, L, H, P)
    li = blk(i_pre).reshape(B, nc, L, H)
    lf = -F.softplus(-blk(f_pre).reshape(B, nc, L, H))
    if pad:
        valid = (torch.arange(nc * L, device=dev) < S).reshape(1, nc, L, 1)
        li = torch.where(valid, li, NEG_INF)
        lf = torch.where(valid, lf, 0.0)
    tri = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    hs = []
    for c in range(nc):
        qc, kc, vc, lic, lfc = qf[:, c], kf[:, c], vf[:, c], li[:, c], lf[:, c]
        bcum = torch.cumsum(lfc, dim=1)                           # (B,L,H)
        # select, not mask by product: D is only defined for s <= t
        dmat = torch.where(tri[None, :, :, None],
                           bcum[:, :, None, :] - bcum[:, None, :, :]
                           + lic[:, None, :, :], NEG_INF)         # (B,L,L,H)
        m_inter = bcum + m[:, None, :]
        m_row = torch.maximum(dmat.amax(dim=2), m_inter)          # (B,L,H)
        sw = (torch.einsum("bthp,bshp->btsh", qc, kc)
              * torch.exp(dmat - m_row[:, :, None, :]))
        inter = torch.exp(m_inter - m_row)
        num = (torch.einsum("btsh,bshp->bthp", sw, vc)
               + inter[..., None] * torch.einsum("bthp,bhpv->bthv", qc, C))
        den = sw.sum(dim=2) + inter * torch.einsum("bthp,bhp->bth", qc, n)
        den = torch.maximum(den.abs(), torch.exp(-m_row))
        hs.append(num / den[..., None])

        btot = bcum[:, -1, :]                                     # (B,H)
        m_new = m_row[:, -1, :]
        wk = (torch.exp(btot[:, None, :] - bcum + lic)
              * torch.exp(-m_new)[:, None, :])                    # (B,L,H)
        decay = torch.exp(btot + m - m_new)
        kw = kc * wk[..., None]
        C = (decay[..., None, None] * C
             + torch.einsum("bshp,bshv->bhpv", kw, vc))
        n = decay[..., None] * n + kw.sum(dim=1)
        m = m_new
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(q.dtype), (C, n, m)


def mlstm_chunk_scan(q, k, v, i_pre, f_pre, *, chunk: int = 256):
    """q, k, v: (B, S, H, P) in f32 or bf16 (one dtype); i_pre, f_pre:
    (B, S, H) f32; all on one CUDA device. The kernel's chunk is
    ``min(chunk, S, 64)``; its three stages count as one launch. bf16
    takes P <= 1024, a multiple of 8 (the tensor-core tiles). In f32 a P
    too wide for one head's value tile of C in shared memory (P > 1024 or
    so) fails at launch and raises.
    Returns (h (B, S, H, P) in q's dtype, (C (B, H, P, P), n (B, H, P, 1),
    m (B, H)) f32), the Pallas kernel's layout."""
    B, S, H, P = q.shape
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, i_pre, f_pre))):
        raise ValueError("mlstm_chunk_scan needs q, k, v, i_pre, f_pre on "
                         "one CUDA device")
    if (q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32):
        raise ValueError(f"unsupported dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}, i_pre {i_pre.dtype}, f_pre "
                         f"{f_pre.dtype}")
    if (k.shape != q.shape or v.shape != q.shape or i_pre.shape != (B, S, H)
            or f_pre.shape != (B, S, H) or min(B, H, P) < 1):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, i_pre "
                         f"{tuple(i_pre.shape)}, f_pre {tuple(f_pre.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if q.dtype == torch.bfloat16 and (P > 1024 or P % 8):
        raise ValueError(f"bf16 head width P={P}: the kernel takes P <= 1024, "
                         f"a multiple of 8")
    if q.dtype == torch.bfloat16 and S * H * P >= 2 ** 31:
        raise ValueError(f"S*H*P = {S * H * P}: the bf16 kernel takes fewer "
                         f"than 2**31 elements per batch row")
    q, k, v, i_pre, f_pre = (t.contiguous() for t in (q, k, v, i_pre, f_pre))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm_chunk_scan needs 16-byte aligned bf16 inputs")
    h = torch.empty_like(q)
    C = torch.empty((B, H, P, P), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, P, 1), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    if S == 0:
        return h, (C.zero_(), n.zero_(), m.fill_(NEG_INF))
    L = min(chunk, S, L_MAX)
    # the tensor-core path's per-chunk records (bf16 only)
    scratch = torch.empty(B * H * -(-S // L) * SCRATCH_WORDS
                          if q.dtype == torch.bfloat16 else 0,
                          dtype=torch.float32, device=dev)
    fn = _build.load("mlstm_scan").mlstm_scan
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                 f_pre.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
                 m.data_ptr(), scratch.data_ptr(), B, S, H, P, L,
                 1.0 / math.sqrt(P), DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan launch failed: CUDA error {err}")
    mlstm_chunk_scan.launches += 1
    return h, (C, n, m)


mlstm_chunk_scan.launches = 0
