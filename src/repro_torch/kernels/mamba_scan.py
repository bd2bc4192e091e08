"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel
``csrc/mamba_scan.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_chunk_scan``, ``pallas_call`` at line 101). Per (batch, head)
the sequence is cut into chunks; within a chunk the scan is an L x L
decay-masked product plus the inter-chunk term of the carried P x N f32
state, which is then updated. On the H100 its bytes bound it (2.90 us at
S=512 bf16 for Zamba2's heads; at the bf16 tensor-core rate the
operations take less). In bf16 it runs the SSD state-passing form in
three launches: c.b^T once per chunk for all heads and each chunk's
contribution to the state, in parallel over chunks; an elementwise state
pass over the chunks; the chunk outputs, in parallel. Every product is
on the tensor cores, the f32 operand split into two bf16 halves. In f32
one launch of f32 FMAs walks the chunks. The design is in the source's
header, its times in PERF.md.

:func:`mamba_chunk_scan` launches the kernel on CUDA tensors only and
counts its launches in ``mamba_chunk_scan.launches`` (the bf16 path's
three stages count as one); the dispatch by device is in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.recompute import recompute_grads

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
L_MAX = 128               # longest chunk the kernel's thread mapping covers
N_MAX_BF16 = 128          # widest state of the tensor-core path (N_TC)


def scratch_words(B, S, H, P, N, L):
    """f32 words of the bf16 path's scratch: per (batch, chunk) c.b^T
    (L rounded up to 16, squared), each head's P x N state contribution
    (then the state entering the chunk) and its decay."""
    nc = -(-S // L)
    lp = -(-L // 16) * 16
    return B * nc * (lp * lp + H * P * N + H)


def mamba_chunk_scan_plain(x, dt, a_log, b, c, *, chunk: int = 128,
                           steps: Optional[int] = None):
    """The plain version, chunk by chunk in f32: the reference's jnp path
    (``repro/kernels/ops.py::_mamba_chunked_jnp``), with the same values;
    its gradient is finite where the reference's is NaN (the decay's
    exponent is masked above the diagonal). Returns (y in x's dtype (B,
    S, H, P), h_final f32 (B, H, P, N)). ``steps`` runs only the first
    chunks (the census counts a few to extrapolate; y then holds
    theirs)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    if S == 0:
        return torch.empty_like(x), h
    L = min(chunk, S)
    n = -(-S // L)
    pad = n * L - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, n, L, H)
    bf = F.pad(b.float(), (0, 0, 0, pad)).reshape(B, n, L, N)
    cf = F.pad(c.float(), (0, 0, 0, pad)).reshape(B, n, L, N)
    a = -torch.exp(a_log.float())                                   # (H,)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ys = []
    for i in range(n if steps is None else steps):
        xc, dtc, bc, cc = xf[:, i], dtf[:, i], bf[:, i], cf[:, i]
        cum = torch.cumsum(dtc * a, dim=1)                          # (B,L,H)
        # the exponent is masked too, not only the product: above the
        # diagonal exp(cum_t - cum_s) overflows to inf, and the backward
        # of the select would multiply that inf by a zero gradient (NaN;
        # the reference's jnp scan has that fault). Values are unchanged.
        band = tri[None, :, :, None]
        decay = torch.exp(torch.where(band, cum[:, :, None, :]
                                      - cum[:, None, :, :], -torch.inf))
        scores = torch.einsum("btn,bsn->bts", cc, bc)
        m = torch.where(band, decay * scores[..., None] * dtc[:, None], 0.0)
        y = torch.einsum("btsh,bshp->bthp", m, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp",
                                                         cc, h)
        total = cum[:, -1:, :]                                      # (B,1,H)
        w = torch.exp(total - cum) * dtc                            # (B,L,H)
        h = (torch.exp(total)[:, 0, :, None, None] * h
             + torch.einsum("bshp,bsn,bsh->bhpn", xc, bc, w))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), h


def mamba_chunk_scan(x, dt, a_log, b, c, *, chunk: int = 128):
    """x: (B, S, H, P) and b, c: (B, S, N) in f32 or bf16 (one dtype);
    dt: (B, S, H) and a_log: (H,) in f32; all on one CUDA device.
    ``min(chunk, S)`` must be at most 128. bf16 takes N <= 128; in f32 an
    N too large for the chunk's tiles in shared memory (above 64 at
    chunk 128) fails at launch and raises. Returns (y (B, S, H, P) in
    x's dtype, h_final (B, H, P, N) f32)."""
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, a_log, b, c))):
        raise ValueError("mamba_chunk_scan needs x, dt, a_log, b, c on one "
                         "CUDA device")
    return _call(x, dt, a_log, b, c, chunk=chunk, launch=True)


def mamba_chunk_scan_meta(x, dt, a_log, b, c, *, chunk: int = 128):
    """:func:`mamba_chunk_scan` on meta tensors: its checks and its
    allocations, without the launch (the census's dry run)."""
    if not all(t.is_meta for t in (x, dt, a_log, b, c)):
        raise ValueError("mamba_chunk_scan_meta needs meta tensors")
    return _call(x, dt, a_log, b, c, chunk=chunk, launch=False)


def _call(x, dt, a_log, b, c, *, chunk, launch):
    B, S, H, P = x.shape
    N = b.shape[-1]
    dev = x.device
    if (x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or dt.dtype != torch.float32 or a_log.dtype != torch.float32):
        raise ValueError(f"unsupported dtypes x {x.dtype}, b {b.dtype}, "
                         f"c {c.dtype}, dt {dt.dtype}, a_log {a_log.dtype}")
    if (dt.shape != (B, S, H) or a_log.shape != (H,) or b.shape != (B, S, N)
            or c.shape != b.shape or min(B, H, P, N) < 1):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    L = min(chunk, S)
    if S and not 1 <= L <= L_MAX:
        raise ValueError(f"chunk length {L} not in [1, {L_MAX}]")
    if x.dtype == torch.bfloat16 and N > N_MAX_BF16:
        raise ValueError(f"bf16 state width N={N}: the kernel takes N <= "
                         f"{N_MAX_BF16}")
    x, dt, a_log, b, c = (t.contiguous() for t in (x, dt, a_log, b, c))
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if S == 0:
        return y, h.zero_()
    scratch = torch.empty(scratch_words(B, S, H, P, N, L)
                          if x.dtype == torch.bfloat16 else 0,
                          dtype=torch.float32, device=dev)
    if launch:
        fn = _build.load("mamba_scan").mamba_scan
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                     b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr(),
                     scratch.data_ptr(), B, S, H, P, N, L, DTYPES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
        mamba_chunk_scan.launches += 1
    return y, h


def work(x, dt, a_log, b, c, *, chunk: int = 128):
    """(bytes, operations) of one launch: x, b, c, dt and a_log read once,
    y and the f32 final state written once; per head, the L x L products
    c.b^T and M x (2 S L (N + P)) and the inter-chunk and state-update
    contractions (4 S P N), without causal skipping."""
    B, S, H, P = x.shape
    N, elt = b.shape[-1], x.element_size()
    L = min(chunk, S)
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt + 4 * B * S * H
              + 4 * H + 4 * B * H * P * N)
    return nbytes, B * H * (2 * S * L * (N + P) + 4 * S * P * N)


mamba_chunk_scan.launches = 0


class MambaScan(torch.autograd.Function):
    """The scan with a gradient: the forward is ``forward_fn`` (the kernel
    on the card; a test passes :func:`mamba_chunk_scan_plain`) and saves
    only its inputs; the backward re-runs the plain scan at the same
    chunk (:func:`recompute_grads`), so its gradients of y and of the
    final state are the plain path's bit for bit."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk, forward_fn):
        ctx.save_for_backward(x, dt, a_log, b, c)
        ctx.chunk = chunk
        return forward_fn(x, dt, a_log, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        grads = recompute_grads(mamba_chunk_scan_plain, ctx.saved_tensors,
                                ctx.needs_input_grad[:5], (gy, gh),
                                chunk=ctx.chunk)
        return grads + (None, None)


def mamba_scan_grad(x, dt, a_log, b, c, *, chunk: int = 128,
                    forward_fn=mamba_chunk_scan):
    """Differentiable scan: :class:`MambaScan` over the kernel (or over
    ``forward_fn``). Returns (y, h_final) as the kernel does."""
    return MambaScan.apply(x, dt, a_log, b, c, chunk, forward_fn)
