"""Per-row int8 quantization of the split-learning boundary: the
hand-written Hopper kernel ``csrc/split_quant.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/split_quant.py``
(``quantize_rows``, ``pallas_call`` at line 35). On the H100 it is
bounded by its bytes: the (rows, d) input read once, the int8 codes and
the per-row f32 scales written once (3.35 TB/s). One warp per row reads
the row in 16-byte vectors and packs four codes per 32-bit store; the
design is in the source's header.

:func:`quantize_rows` launches the kernel on CUDA tensors only and
counts its launches in ``quantize_rows.launches``; the dispatch by
device is in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The plain version is the oracle itself: x (rows, d) -> (q int8 (rows, d),
# scale f32 (rows, 1)), divide then round half to even, as the kernel.
quantize_rows_plain = ref.quantize_rows


def quantize_rows(x):
    """x: (rows, d) f32 or bf16 on a CUDA device -> (q int8 (rows, d),
    scale f32 (rows, 1)), bit-identical to :func:`quantize_rows_plain`."""
    if not x.is_cuda:
        raise ValueError("quantize_rows needs a CUDA tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.dim() != 2 or x.shape[1] == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    rows, d = x.shape
    x = x.contiguous()
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    per_vec = 16 // x.element_size()          # elements in one 16-byte load
    vec = int(d % per_vec == 0 and x.data_ptr() % 16 == 0
              and q.data_ptr() % per_vec == 0)
    fn = _build.load("split_quant").split_quant
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, d,
                 DTYPES[x.dtype], vec, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"split_quant launch failed: CUDA error {err}")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0
