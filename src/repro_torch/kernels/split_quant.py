"""Per-row int8 quantization of the split-learning boundary: the
hand-written Hopper kernel ``csrc/split_quant.cu`` and its plain
PyTorch versions.

Replaces the Pallas TPU kernel ``repro/kernels/split_quant.py``
(``quantize_rows``, ``pallas_call`` at line 35). On the H100 it is
bounded by its bytes: x read once, its outputs written once (3.35
TB/s). Two entries launch it:

- :func:`quantize_rows` returns the codes and scales, as the TPU kernel;
- :func:`quantize_dequantize` returns the straight-through estimator's
  forward output, q * scale in x's dtype, from the same launch, written
  in x's own strides; the codes are never stored.

Both take the boundary in the layout it arrives in, read from
``x.stride()`` (:func:`layout`): row-major rows (a warp per row) or
channel-major rows, such as the NHWC view of NCHW memory that a conv
stage hands over (a thread per pixel, coalesced per channel). Any other
layout is made contiguous first, and the module counts those copies in
``copies``; the kernel still runs. The design is in the source's header.

Each entry launches the kernel on CUDA tensors only and counts its
launches (``quantize_rows.launches``, ``quantize_dequantize.launches``);
the dispatch by device is in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CM_MAX_C = 256                    # channel-major rows: C <= 256 (the source's)

copies = 0                        # inputs made contiguous before a launch


class Layout(NamedTuple):
    """x (..., C) read as an (N, P, C) view: element (n, p, c) at
    ``n * ns + p * ps + c * cs`` elements from ``x.data_ptr()``."""

    N: int
    P: int
    C: int
    ns: int
    ps: int
    cs: int


def _collapse(dims):
    """The stride of (size, stride) dims flattened into one, outer to
    inner, or None where they do not flatten without a copy."""
    dims = [(n, s) for n, s in dims if n != 1]
    if not dims:
        return 1
    for (_, s_out), (n_in, s_in) in zip(dims, dims[1:]):
        if s_out != n_in * s_in:
            return None
    return dims[-1][1]


def _non_overlapping(shape, stride) -> bool:
    """Whether the strides put each element at its own address (each dim,
    by stride, steps past the extent of the ones below it)."""
    extent = 1
    for s, n in sorted((s, n) for n, s in zip(shape, stride) if n != 1):
        if s < extent:
            return False
        extent = s * n
    return True


def layout(x) -> Optional[Layout]:
    """How the kernel reads x (rows along the last dim, one row per index
    of the others): row-major rows (``cs == 1``) or channel-major rows
    (``ps == 1``, C <= 256), or None where neither holds without a copy
    (overlapping elements, row dims that do not flatten)."""
    shape, stride = x.shape, x.stride()
    if not _non_overlapping(shape, stride):
        return None
    C = shape[-1]
    if len(shape) <= 2:
        N, ns, lead = 1, 0, list(zip(shape[:-1], stride[:-1]))
    else:
        N, ns = shape[0], stride[0]
        lead = list(zip(shape[1:-1], stride[1:-1]))
    P = math.prod(n for n, _ in lead)
    ps = _collapse(lead)
    cs = 1 if C == 1 else stride[-1]
    if ps is None:
        return None
    if N == 1:
        ns = 0                          # one image: its stride is never read
    if P == 1:
        ps = 1 if cs != 1 else C        # one pixel: either reading holds
    if cs == 1 or (ps == 1 and C <= CM_MAX_C):
        return Layout(N, P, C, ns, ps, cs)
    return None


def _like(x):
    """An empty tensor of x's shape and dtype in x's strides, where those
    hold each element once; else contiguous."""
    if _non_overlapping(x.shape, x.stride()):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device)
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _launch(x, entry, fused: bool, launch: bool = True):
    """One launch on x (..., C), counted in ``entry.launches``: fused ->
    xhat in x's strides; else -> (q int8 (rows, C), scale f32 (rows, 1)).
    Without ``launch`` (a meta x, the census's dry run): the same checks
    and allocations, no launch."""
    global copies
    if not (x.is_cuda if launch else x.is_meta):
        raise ValueError("split_quant needs a CUDA tensor" if launch
                         else "split_quant's dry run needs a meta tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    lay = layout(x)
    if lay is None:
        x = x.contiguous()
        copies += 1
        lay = layout(x)
    C = lay.C
    rows = lay.N * lay.P
    dev = x.device
    if fused:       # x holds each element once: xhat takes its strides
        xhat = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=dev)
        q = scale = None
    else:
        xhat = None
        q = torch.empty((rows, C), dtype=torch.int8, device=dev)
        scale = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    out = xhat if fused else (q, scale)
    if rows == 0 or not launch:
        return out
    per_vec = 16 // x.element_size()          # elements in one 16-byte load
    vec = int(lay.cs == 1 and C % per_vec == 0 and lay.ns % per_vec == 0
              and lay.ps % per_vec == 0 and x.data_ptr() % 16 == 0)
    fn = _build.load("split_quant").split_quant
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), ptr(xhat), ptr(q), ptr(scale), lay.N, lay.P,
                 C, lay.ns, lay.ps, lay.cs, DTYPES[x.dtype], vec,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"split_quant launch failed: CUDA error {err}")
    entry.launches += 1
    return out


def quantize_rows_plain(x):
    """x (..., d) -> (q int8 (rows, d), scale f32 (rows, 1)): the oracle
    on x flattened to rows, divide then round half to even."""
    return ref.quantize_rows(x.reshape(-1, x.shape[-1]))


def quantize_rows(x):
    """x: (rows, d), or any tensor with its rows along the last dim, f32
    or bf16 on a CUDA device, in any strides -> (q int8 (rows, d), scale
    f32 (rows, 1)), bit-identical to :func:`quantize_rows_plain`."""
    return _launch(x, quantize_rows, fused=False)


quantize_rows.launches = 0


def quantize_rows_meta(x):
    """:func:`quantize_rows` on a meta tensor, without the launch."""
    return _launch(x, quantize_rows, fused=False, launch=False)


def quantize_dequantize_plain(x):
    """x (..., d) -> dequantize(quantize(rows of x)) with x's shape, dtype
    and (where they hold each element once) strides."""
    y = ref.dequantize_rows(*quantize_rows_plain(x), x.dtype)
    return _like(x).copy_(y.reshape(x.shape))


def quantize_dequantize(x):
    """x (..., d) f32 or bf16 on a CUDA device, in any strides -> q * scale
    in x's dtype, shape and (where they hold each element once) strides,
    bit-identical to :func:`quantize_dequantize_plain`, in one launch."""
    return _launch(x, quantize_dequantize, fused=True)


quantize_dequantize.launches = 0


def quantize_dequantize_meta(x):
    """:func:`quantize_dequantize` on a meta tensor, without the launch."""
    return _launch(x, quantize_dequantize, fused=True, launch=False)


def work(x, fused: bool):
    """(bytes, operations) of one launch on x (..., C): x read once; xhat
    in x's dtype (``fused``), or the int8 codes and the f32 scales,
    written once; about six f32 operations per element (abs, max, divide,
    round, 2 clips)."""
    n, rows = x.numel(), x.numel() // x.shape[-1]
    out_bytes = n * x.element_size() if fused else n + 4 * rows
    return n * x.element_size() + out_bytes, 6 * n
