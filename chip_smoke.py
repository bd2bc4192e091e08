#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device report (name, power limit);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
  3. each attention kernel against its plain PyTorch version at
     SmolLM-360M's head geometry, at Zamba2-1.2B's (MHA, 32 heads) and
     at head dim 16 (the smoke configs' heads), the Mamba-2 chunked scan
     against its plain version at Zamba2's full-width heads, the mLSTM
     chunkwise scan against its plain version at xLSTM-1.3B's (H=4,
     P=1024), and the SL boundary quantizer against its plain version
     bit for bit at the training path's shapes, with each kernel's time,
     bound, plain time and library yardstick;
  4. full-width SmolLM-360M split-model serving (cut at unit 16) through
     both attention kernels: launch counts, split == unsplit greedy
     tokens, one decode step's logits on the kernel path against the
     plain path;
  5. the paper's training loop: a 25-satellite Table-I ring training
     full-width ResNet-18 (224 px, cut l2, batch 8, SGD) with the int8
     boundary through the quantizer kernel (2 launches per SL step),
     finite losses, the metered boundary payload, one step's loss on the
     kernel path against the plain path, step times and a profile; then
     one autoencoder pass at 224 px;
  6. full-width Zamba2-1.2B split-model serving (cut at unit 3) through
     the scan kernel (prefill) and both attention kernels (the shared
     block): launch counts, split == unsplit greedy tokens, one prefill's
     and one decode step's logits on the kernel path against the plain
     path, times and profiles;
  7. full-width xLSTM-1.3B split-model serving (cut at unit 3) through
     the mLSTM scan kernel (prefill; decode and the sLSTM recurrence are
     plain PyTorch): phase 6's checks, no kernel launch in a decode step,
     and the f32 prefill logits held within the spread of two exact
     mLSTM chunkings instead of 1e-3.
The last two lines are the kernels' JSON record and the result JSON.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import sl_step  # noqa: E402
from repro_torch.core.constellation import (ConstellationConfig,  # noqa: E402
                                            ConstellationSim)
from repro_torch.core.energy import PassBudget  # noqa: E402
from repro_torch.core.splitting import RESNET18_PAPER_CUTS  # noqa: E402
from repro_torch.core.train_state import SLTrainState  # noqa: E402
from repro_torch.data.synthetic import ImageryShards  # noqa: E402
from repro_torch.kernels import (_build, decode_attn, flash_attn,  # noqa: E402
                                 mamba_scan, mlstm_scan, ops, split_quant)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.param import map_tree  # noqa: E402
from repro_torch.train.optimizer import resolve_optimizer  # noqa: E402
from repro_torch.utils.treeutil import tree_leaves  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serve_fleet.engine import SplitDecodeEngine  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}    # as the CPU tests
H, KV, D = 15, 5, 64                                 # SmolLM-360M heads
MHA_H = 32                                           # Zamba2-1.2B: H = KV
SMOKE_H, SMOKE_D = 4, 16               # the smoke configs' heads (Zamba2's)
PREFILL_S = (1, 77, 498, 512, 1000)     # 498: the longest served prompt
DECODE_B, DECODE_S = 8, 2048
DECODE_LENS = [1, 2048, 100, 513, 1024, 37, 2000, 777]
# The quantizer's shapes: ResNet-18's l2 boundary at 224 px and batch 8
# (z and dz, 8*28*28 rows of 128 channels) in f32 and bf16, the
# autoencoder's 224-px latent (8*7*7 rows of 3), and a d that is not a
# multiple of the 16-byte vector. Every input has all-zero rows and .5 ties.
QUANT_SHAPES = [(6272, 128, torch.float32), (6272, 128, torch.bfloat16),
                (392, 3, torch.float32), (1000, 130, torch.float32)]
# The Mamba-2 scan at Zamba2-1.2B's full-width heads (H=64, P=N=64,
# chunk 128): (B, S), S = 1 and ragged last chunks included.
MAMBA_H, MAMBA_P, MAMBA_N, MAMBA_CHUNK = 64, 64, 64, 128
MAMBA_SHAPES = [(1, 1), (1, 100), (1, 512), (1, 1000), (2, 257)]
# f32: the reference's scan tolerance (MAMBA_SWEEP, tests/test_kernels.py);
# bf16: y rounds to bf16 after f32 sums taken in another order than the
# plain version's (1 ulp = 2**-8 relative), as the attention kernels.
MAMBA_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-4}
# The mLSTM scan at xLSTM-1.3B's full-width heads (H=4, P=1024; the
# model's chunk 256, of which the kernel takes 64): (B, S) as for Mamba-2.
MLSTM_H, MLSTM_P, MLSTM_CHUNK = 4, 1024, 256
MLSTM_SHAPES = MAMBA_SHAPES
# h: f32 at the reference's mLSTM tolerance (tests/test_kernels.py), bf16
# as the Mamba-2 scan's y (1 ulp after f32 sums in another order); the
# f32 state C, n, m at the reference's tolerance in both.
MLSTM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MLSTM_STATE_TOL = 1e-4
# The training ring (phase 5): Table I's 25-satellite plane and its 400
# items per pass, capped at 8 SL steps a pass so the phase stays short.
RING_PASSES, RING_STEPS, RING_BATCH = 6, 8, 8
L2_INT8_BITS_PER_ITEM = 28 * 28 * 128 * 8          # 802,816
# Table II's l2 D_tx at f32, 3.211e6 bits (benchmarks/paper_tables.py:29),
# exactly 28*28*128*32
L2_F32_DTX_BITS = 3_211_264
# One SL step's loss, kernel path vs plain-quantizer path: the kernel is
# bit-exact, so the two differ only by cuDNN's run-to-run order of sums.
STEP_LOSS_RTOL = 1e-5
# One decode step's logits, kernel path vs plain path, both in bf16
# activations: the attention outputs round to bf16 at different sums, and
# the 1-ulp differences travel through 32 layers. Held to 3% of the
# largest logit (PERF.md, "Findings").
LOGITS_TOL_OF_MAX = 0.03
# A whole prefill's logits, kernel path vs plain path, in f32 activations:
# bf16 ones are not comparable, since Zamba2's 1-ulp differences per call
# grow along the sequence and through 36 blocks to ~25% of the largest
# logit (PERF.md, Findings), so the bf16 prefill is held call by call
# instead. In f32 the two paths agreed to 9e-5 of the largest logit on
# the card (PERF.md, Findings); held to 1e-3 of it. xLSTM-1.3B's 48 blocks
# amplify the order of f32 sums ~1000-fold: two plain paths that differ
# only in the mLSTM chunk (64 against 256, both exact) part by 1.3% of
# the largest logit (PERF.md, Findings). There the kernel path is held to
# the plain path at the kernel's chunk within that spread, measured anew.
PREFILL_F32_TOL_OF_MAX = 1e-3


def check(ok, what):
    """A failed check ends the run (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters=20, flush=None):
    """Median device time of ``fn`` by CUDA events, one launch per pair of
    events; ``flush`` (a large buffer) is rewritten before each launch so
    the launch finds the 50 MB L2 cold, as a decode layer does."""
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound(nbytes, nops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_prefill(dtype, S, gen, flush, H=H, KV=KV, D=D):
    dev = torch.device("cuda")
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((1, H, S, D), (1, KV, S, D), (1, KV, S, D))]
    got = flash_attn.flash_attention_fwd(q, k, v, causal=True)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    pairs = S * (S + 1) // 2                        # causal (q, k) pairs
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                       4 * D * H * pairs, dtype)
    return dict(
        shape=f"prefill B=1 H={H} KV={KV} S={S} D={D} {str(dtype)[6:]}",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attn.flash_attention_fwd(q, k, v),
                   flush=flush),
        plain_ms=time_ms(lambda: flash_attn.flash_attention_plain(q, k, v),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def check_decode(dtype, gen, flush, H=H, KV=KV, D=D):
    dev = torch.device("cuda")
    q, k, v = [torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((DECODE_B, H, 1, D), (DECODE_B, KV, DECODE_S, D),
                         (DECODE_B, KV, DECODE_S, D))]
    lengths = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    got = decode_attn.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    kx, vx = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    mask = (torch.arange(DECODE_S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    rows = sum(DECODE_LENS)
    b_ms, b_by = bound(2 * q.numel() * q.element_size() + 4 * len(DECODE_LENS)
                       + 2 * rows * KV * D * k.element_size(),
                       4 * D * H * rows, dtype)
    return dict(
        shape=f"decode B={DECODE_B} H={H} KV={KV} s_max={DECODE_S} D={D} "
              f"lengths={DECODE_LENS} {str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: decode_attn.decode_attention(q, k, v, lengths),
                   flush=flush),
        plain_ms=time_ms(lambda: decode_attn.decode_attention_plain(
            q, k, v, lengths), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def quant_input(rows, d, dtype, gen):
    x = torch.randn((rows, d), generator=gen, device="cuda") * 7.3
    x[::7] = 0.0                                   # all-zero rows
    ties = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5][:d]
    x[1, :len(ties)] = torch.tensor(ties, device="cuda")   # scale 1: .5 ties
    return x.to(dtype)


def check_quant(rows, d, dtype, gen, flush):
    """The quantizer kernel against its plain version, bit for bit."""
    x = quant_input(rows, d, dtype, gen)
    q, s = split_quant.quantize_rows(x)
    qp, sp = split_quant.quantize_rows_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(q, qp) and torch.equal(s, sp),
          f"quantizer {rows}x{d} {dtype}: not bit-identical to plain")
    err = max((q.int() - qp.int()).abs().max().item(),
              (s - sp).abs().max().item())
    n = rows * d
    # read x once, write q (int8) and the per-row f32 scales once; about
    # six f32 operations per element (abs, max, divide, round, 2 clips)
    b_ms, b_by = bound(n * x.element_size() + n + 4 * rows, 6 * n,
                       torch.float32)
    return dict(
        shape=f"quantize rows={rows} d={d} {str(dtype)[6:]}",
        max_abs_err=err,
        ms=time_ms(lambda: split_quant.quantize_rows(x), flush=flush),
        plain_ms=time_ms(lambda: split_quant.quantize_rows_plain(x),
                         flush=flush),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def mamba_work(B, S, H, P, N, chunk, elt):
    """Bytes and operations of one SSD chunked scan: x, b, c, dt and
    a_log read once, y and the f32 final state written once; per head,
    the L x L products c.b^T and M x (2 S L (N + P)) and the inter-chunk
    and state-update contractions (4 S P N), without causal skipping."""
    L = min(chunk, S)
    nbytes = (2 * B * S * H * P * elt + 2 * B * S * N * elt + 4 * B * S * H
              + 4 * H + 4 * B * H * P * N)
    nops = B * H * (2 * S * L * (N + P) + 4 * S * P * N)
    return nbytes, nops


def check_mamba(dtype, B, S, gen, flush):
    """The SSD scan kernel against its plain version at Zamba2's heads."""
    dev = torch.device("cuda")
    Hm, P, N = MAMBA_H, MAMBA_P, MAMBA_N
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = rnd(B, S, Hm, P).to(dtype)
    dt = F.softplus(rnd(B, S, Hm))
    a_log = rnd(Hm) * 0.5
    b, c = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)
    args = (x, dt, a_log, b, c)
    y, h = mamba_scan.mamba_chunk_scan(*args, chunk=MAMBA_CHUNK)
    yp, hp = mamba_scan.mamba_chunk_scan_plain(*args, chunk=MAMBA_CHUNK)
    torch.cuda.synchronize()
    tol = MAMBA_TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hp, atol=tol, rtol=tol)
    err = max((y.float() - yp.float()).abs().max().item(),
              (h - hp).abs().max().item())
    nbytes, nops = mamba_work(B, S, Hm, P, N, MAMBA_CHUNK, x.element_size())
    b_ms, b_by = bound(nbytes, nops, dtype)
    return dict(
        shape=f"scan B={B} S={S} H={Hm} P={P} N={N} chunk {MAMBA_CHUNK} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: mamba_scan.mamba_chunk_scan(
            *args, chunk=MAMBA_CHUNK), flush=flush),
        plain_ms=time_ms(lambda: mamba_scan.mamba_chunk_scan_plain(
            *args, chunk=MAMBA_CHUNK), flush=flush),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, ops=nops)


def mlstm_work(B, S, H, P, elt):
    """Bytes and operations of one mLSTM chunkwise scan at the kernel's
    chunk L = min(64, S): q, k, v, i_pre, f_pre read once, h and the f32
    final state (C, n, m) written once; per head and position, q.k^T and
    W v over the chunk (4 L P, the full L x L block, no causal
    skipping), q C_prev and the C update (4 P^2), q.n and the n update
    (4 P)."""
    L = min(mlstm_scan.L_MAX, S)
    nbytes = (4 * B * S * H * P * elt + 2 * 4 * B * S * H
              + 4 * B * H * (P * P + P + 1))
    nops = B * H * S * (4 * L * P + 4 * P * P + 4 * P)
    return nbytes, nops


def check_mlstm(dtype, B, S, gen, flush):
    """The mLSTM scan kernel against its plain version at xLSTM's heads:
    h, C, n and m held to the plain version at the kernel's own chunk
    (as phase 7's per-call checks), and timed against the plain version
    at the model's chunk (256). The two plain chunkings are the same
    function, but their f32 sums part by their own rounding (``spread``),
    at S=1000 in f32 by more than the tolerance (PERF.md, PR 17). In bf16
    the kernel's three launches are timed by name (``stages``)."""
    dev = torch.device("cuda")
    Hx, P = MLSTM_H, MLSTM_P
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v = (rnd(B, S, Hx, P).to(dtype) for _ in range(3))
    i_pre, f_pre = rnd(B, S, Hx), rnd(B, S, Hx) + 1.0   # as the reference's test
    args = (q, k, v, i_pre, f_pre)
    L = min(mlstm_scan.L_MAX, S)                        # the kernel's chunk
    h, (C, n, m) = mlstm_scan.mlstm_chunk_scan(*args, chunk=MLSTM_CHUNK)
    hp, (Cp, np_, mp) = mlstm_scan.mlstm_chunk_scan_plain(*args, chunk=L)
    hq, _ = mlstm_scan.mlstm_chunk_scan_plain(*args, chunk=MLSTM_CHUNK)
    torch.cuda.synchronize()
    tol = MLSTM_TOL[dtype]
    torch.testing.assert_close(h.float(), hp.float(), atol=tol, rtol=tol)
    for got, want in ((C, Cp), (n[..., 0], np_), (m, mp)):
        torch.testing.assert_close(got, want, atol=MLSTM_STATE_TOL,
                                   rtol=MLSTM_STATE_TOL)
    err = max((a.float() - b.float()).abs().max().item() for a, b in (
        (h, hp), (C, Cp), (n[..., 0], np_), (m, mp)))
    nbytes, nops = mlstm_work(B, S, Hx, P, q.element_size())
    b_ms, b_by = bound(nbytes, nops, dtype)
    run = lambda: mlstm_scan.mlstm_chunk_scan(*args, chunk=MLSTM_CHUNK)
    return dict(
        shape=f"mlstm B={B} S={S} H={Hx} P={P} chunk {L} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        spread=(hq.float() - hp.float()).abs().max().item(),
        ms=time_ms(run, flush=flush),
        plain_ms=time_ms(lambda: mlstm_scan.mlstm_chunk_scan_plain(
            *args, chunk=MLSTM_CHUNK), flush=flush),
        stages=device_ms(run, flush) if dtype == torch.bfloat16 else None,
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes=nbytes, ops=nops)


# The served models (phases 4, 6 and 7): published widths, seeded random
# weights, the cut, and each kernel's launches per prompt (bulk prefill)
# and per decode step: SmolLM-360M's 32 attention layers; Zamba2-1.2B's 6
# units of 5 Mamba-2 blocks and one pass through the shared block;
# xLSTM-1.3B's 6 units of 7 mLSTM blocks and one sLSTM block (no kernel:
# the mLSTM decode update and the sLSTM recurrence are plain PyTorch).
SERVED = {
    "smollm_360m": dict(dims=(32, 960, 49152), cut=16,
                        per_prompt={"flash_attn_fwd": 32},
                        per_step={"decode_attn": 32}),
    "zamba2_1_2b": dict(dims=(36, 2048, 32000), cut=3,
                        per_prompt={"mamba_scan": 30, "flash_attn_fwd": 6},
                        per_step={"decode_attn": 6}),
}
SERVED["xlstm_1_3b"] = dict(dims=(48, 2048, 50304), cut=3,
                            per_prompt={"mlstm_scan": 42}, per_step={})
WRAPPERS = {"flash_attn_fwd": flash_attn.flash_attention_fwd,
            "decode_attn": decode_attn.decode_attention,
            "mamba_scan": mamba_scan.mamba_chunk_scan,
            "mlstm_scan": mlstm_scan.mlstm_chunk_scan,
            "split_quant": split_quant.quantize_rows}
# What ``ops`` dispatches to on the card, and the plain version that
# replaces it for the comparisons (their launches are not counted).
PLAIN_OPS = {
    "flash_attention": flash_attn.flash_attention_plain,
    "decode_attention": decode_attn.decode_attention_plain,
    "mamba_scan": mamba_scan.mamba_chunk_scan_plain,
    "mlstm_scan": lambda *a, chunk=256: mlstm_scan.mlstm_chunk_scan_plain(
        *a, chunk=min(chunk, mlstm_scan.L_MAX)),    # the kernel's chunk
}
# The ``ops`` name of each serving kernel, and the tolerance of its
# outputs by dtype (phase 3's); f32 outputs of a bf16 call (the scans'
# states) are held at the f32 tolerance.
OP_OF = {"flash_attn_fwd": "flash_attention",
         "decode_attn": "decode_attention",
         "mamba_scan": "mamba_scan", "mlstm_scan": "mlstm_scan"}
OP_TOL = {"flash_attention": TOL, "decode_attention": TOL,
          "mamba_scan": MAMBA_TOL, "mlstm_scan": MLSTM_TOL}


def flat(out):
    """The tensors of an op's output (a tensor or nested tuples), in order."""
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in flat(o)]


def with_ops(make, fn):
    """``fn()`` with each kernel op of the serving path (the names in
    PLAIN_OPS) replaced by ``make(name, kernel op, plain version)``."""
    kernel_ops = {name: getattr(ops, name) for name in PLAIN_OPS}
    for name, plain in PLAIN_OPS.items():
        setattr(ops, name, make(name, kernel_ops[name], plain))
    try:
        return fn()
    finally:
        for name, op in kernel_ops.items():
            setattr(ops, name, op)


def with_plain_ops(fn):
    """``fn()`` with every kernel op swapped for its plain version."""
    return with_ops(lambda name, kernel_op, plain: plain, fn)


def with_checked_ops(fn):
    """``fn()`` with every kernel op of the serving path run twice on the
    same inputs, as the kernel and as its plain version, each output held
    to the plain one at phase 3's tolerance of its dtype. Returns
    (fn's result, {op: (calls, largest error, largest |plain value|)})."""
    seen = {}

    def checked(name, kernel_op, plain):
        def op(*a, **kw):
            out = kernel_op(*a, **kw)
            got, want = flat(out), flat(plain(*a, **kw))
            check(len(got) == len(want), f"{name}: outputs differ in number")
            for g, w in zip(got, want):
                tol = OP_TOL[name][g.dtype]
                torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                           rtol=tol)
                n, err, top = seen.get(name, (0, 0.0, 0.0))
                seen[name] = (n, max(err, (g.float() - w.float()).abs()
                                     .max().item()),
                              max(top, w.float().abs().max().item()))
            n, err, top = seen[name]
            seen[name] = (n + 1, err, top)
            return out
        return op

    return with_ops(checked, fn), seen


def logits_close(lk, lp, what, tol_of_max=LOGITS_TOL_OF_MAX):
    """Kernel-path logits against plain-path logits: finite f32, within
    ``tol_of_max`` of the largest logit. Returns (err, max, argmax
    agreement)."""
    check(lk.dtype == torch.float32 and bool(torch.isfinite(lk).all()),
          f"finite f32 {what} logits")
    err = (lk - lp).abs().max().item()
    top = lp.abs().max().item()
    check(err <= tol_of_max * top, (what, err, top))
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    return err, top, agree


def serve_full_width(arch, label):
    spec = SERVED[arch]
    cfg = configs.get(arch)
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == spec["dims"],
          f"full-width {arch} config")
    cut = spec["cut"]
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    kw = dict(n_slots=8, s_max=2048, act_dtype=torch.bfloat16, device="cuda")
    split = SplitDecodeEngine(cfg, params, cut_units=cut, **kw)
    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, 16)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in plens]
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]

    # warm-up on a throwaway engine (cuBLAS handles, allocator)
    SplitDecodeEngine(cfg, params, cut_units=cut, **kw).submit_and_run(
        reqs()[:2])

    prefill_ms, step_ms = [], []
    step_launches = dict.fromkeys(WRAPPERS, 0)   # launched in decode steps

    def timed(fn, out, launched=None):
        def wrapper(*a):
            n0 = {k: w.launches for k, w in WRAPPERS.items()}
            t0 = time.perf_counter()
            r = fn(*a)                      # returns host values: synced
            out.append((time.perf_counter() - t0) * 1e3)
            if launched is not None:
                for k, w in WRAPPERS.items():
                    launched[k] += w.launches - n0[k]
            return r
        return wrapper

    split._prefill = timed(split._prefill, prefill_ms)
    split._step = timed(split._step, step_ms, step_launches)
    counted = {**spec["per_prompt"], **spec["per_step"]}
    for name in counted:
        WRAPPERS[name].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = split.submit_and_run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: WRAPPERS[name].launches for name in counted}
    want = {**{n: k * len(prefill_ms) for n, k in spec["per_prompt"].items()},
            **{n: k * len(step_ms) for n, k in spec["per_step"].items()}}
    check(len(prefill_ms) == 16 and launches == want,
          f"launches {launches} != {want} ({len(prefill_ms)} prompts, "
          f"{len(step_ms)} decode steps)")
    want_step = {k: spec["per_step"].get(k, 0) * len(step_ms)
                 for k in WRAPPERS}
    check(step_launches == want_step,
          f"decode-step launches {step_launches} != {want_step}")

    check(sorted(out) == list(range(16)), "every request served")
    check(all(len(t) == 32 and all(0 <= x < cfg.vocab for x in t)
              for t in out.values()), "32 in-vocabulary tokens per request")
    unsplit = DecodeEngine(cfg, params, **kw).submit_and_run(reqs())
    check(unsplit == out, "split and unsplit greedy tokens differ")

    # one decode step's f32 logits: kernel path vs plain path, same state
    tokens = torch.tensor(split.last_tok[:, None], device="cuda")
    positions = torch.tensor(np.minimum(plens[:8] + 3, 2047), device="cuda")
    ctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.bfloat16)
    cache0 = map_tree(torch.clone, split.cache)
    with torch.no_grad():
        lk, _, _ = lm.decode_step_split(cfg, split.params_sat,
                                        split.params_gnd, split.cache,
                                        tokens, positions, ctx=ctx)
        lp, _, _ = with_plain_ops(lambda: lm.decode_step_split(
            cfg, split.params_sat, split.params_gnd, cache0, tokens,
            positions, ctx=ctx))
    d_err, d_max, d_agree = logits_close(lk, lp, "decode")

    # one prefill (the longest prompt): in bf16 every kernel call against
    # its plain version on the same inputs, and the logits of both paths
    # (printed); in f32 activations the logits of both paths, held
    longest = torch.tensor(prompts[int(np.argmax(plens))][None, :],
                           device="cuda")
    pctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.bfloat16)
    pctx32 = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    with torch.no_grad():
        (pk, _, _), calls = with_checked_ops(lambda: lm.forward(
            cfg, split.params, longest, ctx=pctx))
        pp, _, _ = with_plain_ops(lambda: lm.forward(
            cfg, split.params, longest, ctx=pctx))
        pk32, _, _ = lm.forward(cfg, params, longest, ctx=pctx32)
        pp32, _, _ = with_plain_ops(lambda: lm.forward(
            cfg, params, longest, ctx=pctx32))
        spread = 0.0
        if "mlstm_scan" in spec["per_prompt"]:
            # the plain path at the model's chunk against the plain path
            # at the kernel's: the spread of two exact chunkings
            pq32, _, _ = with_ops(
                lambda name, kernel_op, plain:
                    mlstm_scan.mlstm_chunk_scan_plain
                    if name == "mlstm_scan" else plain,
                lambda: lm.forward(cfg, params, longest, ctx=pctx32))
            spread = (pq32 - pp32).abs().max().item()
    want_calls = {OP_OF[k]: n for k, n in spec["per_prompt"].items()}
    check({n: c[0] for n, c in calls.items()} == want_calls,
          f"checked prefill calls {calls}")
    check(bool(torch.isfinite(pk).all()), "finite bf16 prefill logits")
    b_err = (pk - pp).abs().max().item()
    b_agree = (pk.argmax(-1) == pp.argmax(-1)).float().mean().item()
    p_tol = max(PREFILL_F32_TOL_OF_MAX,
                spread / pp32.abs().max().item())
    p_err, p_max, p_agree = logits_close(pk32, pp32, "f32 prefill", p_tol)

    n_tok = sum(len(t) for t in out.values())
    print(f"serve {arch} split@{cut}, 8 slots, s_max 2048, 16 requests "
          f"(prompts {plens.min()}-{plens.max()}), 32 new tokens each [{label}]")
    print(f"  {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s "
          f"[{label}]")
    print(f"  prefill median {statistics.median(prefill_ms):.2f} ms over "
          f"{len(prefill_ms)} prompts [{label}]")
    print(f"  decode step median {statistics.median(step_ms):.2f} ms over "
          f"{len(step_ms)} steps [{label}]")
    print(f"  launches on this run: {launches} = per prompt "
          f"{spec['per_prompt']} and per decode step {spec['per_step']} "
          f"(decode steps launched {step_launches}); split tokens == "
          f"unsplit")
    print(f"  logits kernel vs plain (tol {LOGITS_TOL_OF_MAX:.0%} of max "
          f"|logit|): decode max abs err {d_err:.3e} of {d_max:.3e}, argmax "
          f"equal in {d_agree:.0%} of 8 rows")
    print(f"  prefill of {longest.shape[1]} tokens, kernel vs plain: bf16 "
          f"calls (err, max |plain|) " + ", ".join(
              f"{n} {c}x ({e:.3e}, {t:.3e})" for n, (c, e, t) in
              calls.items()) + f"; bf16 logits max abs err {b_err:.3e} "
          f"(not held: differences grow along the sequence), argmax equal "
          f"in {b_agree:.1%}; f32 logits max abs err {p_err:.3e} of "
          f"{p_max:.3e} (tol {p_tol:.3g} of max; mLSTM chunking spread "
          f"{spread:.3e}), argmax equal in {p_agree:.1%} of positions")
    profile_decode(split, label)
    profile_calls(lambda: split._prefill(prompts[int(np.argmax(plens))]), 3,
                  f"prefills of {longest.shape[1]} tokens", label)
    return launches


def profile_calls(fn, n, what, label):
    """Kernel time by name over ``n`` calls of ``fn`` (each returning host
    values, so synced), against the same calls' host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    call = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / n / 1e3
    if busy == 0:
        print(f"profile: {what} {call:.2f} ms each; device time not measured "
              "(the profiler saw no kernels)")
        return
    print(f"profile of {n} {what} [{label}]: {call:.2f} ms each (host clock, "
          f"unprofiled), kernels {busy:.3f} ms each, device idle "
          f"{max(0.0, 1 - busy / call):.1%}")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / n / 1e3:8.4f} ms each  "
              f"{e.count / n:6.1f}x  {e.key[:90]}")
    ours = {}
    for e in kern:
        name = next((k for k in OUR_KERNELS if f"::{k}" in e.key), None)
        if name:
            c, t = ours.get(name, (0, 0.0))
            ours[name] = (c + e.count / n, t + dev_us(e) / n / 1e3)
    if ours:
        total = sum(t for _, t in ours.values())
        print(f"  this repo's kernels: {total:.4f} ms each ({total / busy:.1%} "
              f"of kernel time): " + ", ".join(
                  f"{k} {c:g}x {t:.4f} ms" for k, (c, t) in ours.items()))


# The functions in csrc/*.cu, as the profiler names them.
OUR_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel", "decode_kernel",
               "ssd_kernel", "mlstm_chunk_kernel", "mlstm_norm_kernel",
               "mlstm_value_kernel", "mlstm_fma_kernel", "quant_kernel")


def profile_decode(engine, label, steps=5):
    """Kernel time by name over a few decode steps of the served engine
    (torch.profiler), against the same steps' host-clock time."""
    toks = engine.last_tok.reshape(-1, 1).astype(np.int32)
    pos = np.minimum(engine.positions, engine.s_max - 2)
    profile_calls(lambda: engine._step(toks, pos), steps, "decode steps",
                  label)


def train_full_width(label):
    """Phase 5: the ResNet-18 ring at full width through the quantizer."""
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = ImageryShards(img=224, batch=RING_BATCH, n_shards=25)
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    check(budget.plane.n_sats == 25 and budget.n_items == 400,
          "Table-I plane")
    with tempfile.TemporaryDirectory() as handoff_dir:
        sim = ConstellationSim(
            adapter, budget, shards.batch_at,
            ConstellationConfig(
                n_passes=RING_PASSES, optimizer="sgd",
                quantize_boundary=True, fail_prob=0.0,
                max_steps_per_pass=RING_STEPS, handoff_dir=handoff_dir),
            device="cuda")
        # warm-up on a throwaway state (cuDNN and cuBLAS handles, allocator)
        warm = SLTrainState.create(*adapter.init(torch.Generator(
            device="cuda").manual_seed(1)), sim.optimizer)
        sim.sl_pass(warm, [shards.batch_at(0, 0)])
        del warm

        split_quant.quantize_rows.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_rows.launches
        handoffs = sorted(Path(handoff_dir).iterdir())
    steps = int(sim.state.step)
    check(steps == sum(min(max(1, round(r.n_items / RING_BATCH)), RING_STEPS)
                       for r in records if r.action in ("trained", "shed")),
          "step counter == the passes' allocated steps")
    check(launches == 2 * steps > 0,
          f"quantizer launches {launches} != 2 x {steps} SL steps")
    check(all(r.loss is not None and np.isfinite(r.loss) for r in records),
          "every pass trained with a finite loss")
    check(len(handoffs) == RING_PASSES, "one handoff checkpoint per pass")
    batch = shards.batch_at(0, 0)
    bits = sl_step.boundary_bits(adapter, batch, True) / RING_BATCH
    check(bits == L2_INT8_BITS_PER_ITEM and 4 * bits == L2_F32_DTX_BITS
          == adapter.costs().dtx_bits, f"boundary payload {bits} bits/item")

    # one SL step from the trained state, kernel vs plain quantizer
    step = sl_step.make_sl_step(adapter, quantize_boundary=True)
    pa, pb = sim.state.params_a, sim.state.params_b
    rk = step(pa, pb, batch)
    kernel_quant = split_quant.quantize_rows
    split_quant.quantize_rows = split_quant.quantize_rows_plain
    try:
        rp = step(pa, pb, batch)
    finally:
        split_quant.quantize_rows = kernel_quant
    lk, lp = float(rk.loss), float(rp.loss)
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), (lk, lp))
    g_err = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(rk.grads_a), tree_leaves(rp.grads_a)))

    layout = boundary_layout(adapter, pa, pb, batch)

    # SL step time on device-resident batches (no data generation)
    t0 = time.perf_counter()
    host_batches = [shards.batch_at(1, i) for i in range(RING_STEPS)]
    gen_ms = (time.perf_counter() - t0) / RING_STEPS * 1e3
    dev_batches = [{k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()} for b in host_batches]
    state, pass_ms = sim.state, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.sl_pass(state, dev_batches)
        float(res.losses[-1])                       # ends in a device sync
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        state = res.state
    step_ms = statistics.median(pass_ms) / RING_STEPS
    print(f"train resnet18 224px cut l2 batch {RING_BATCH}, 25-sat Table-I "
          f"ring, {RING_PASSES} passes x {RING_STEPS} steps, int8 boundary, "
          f"sgd [{label}]")
    print(f"  actions {[r.action for r in records]}; losses "
          f"{[round(r.loss, 4) for r in records]}")
    print(f"  ring: {steps} SL steps in {wall:.3f} s = {steps / wall:.2f} "
          f"steps/s incl. host data generation, planning and handoffs "
          f"[{label}]")
    print(f"  host data generation (NumPy ImageryShards.batch_at): "
          f"{gen_ms:.2f} ms per batch of {RING_BATCH} [{label}]")
    print(f"  SL step on device batches: {step_ms:.2f} ms "
          f"({1e3 / step_ms:.1f} steps/s), median of 3 passes of "
          f"{RING_STEPS} steps, host clock ending in a sync [{label}]")
    print(f"  quantizer launches {launches} = 2 x {steps} steps; boundary "
          f"{bits:.0f} bits/item int8 = 1/4 of {L2_F32_DTX_BITS}; step loss "
          f"kernel {lk:.7f} vs plain {lp:.7f}, grads_a max abs diff "
          f"{g_err:.3e}")
    print(f"  {layout} [{label}]")
    profile_sl_steps(sim.sl_pass, state, dev_batches[:4], label)
    return launches


def device_ms(fn, flush, n=20):
    """Device time per call of ``fn`` by kernel, from torch.profiler (no
    host gaps, unlike a pair of events around a Python call): a list of
    (kernel name, launches per call, ms per call). ``flush`` is zeroed
    before each call and its fill left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count / n,
             getattr(e, "self_device_time_total", 0) / n / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "FillFunctor" not in e.key and "Memset" not in e.key]


def boundary_layout(adapter, pa, pb, batch):
    """Whether z and dz reach the quantizer as contiguous NHWC rows, and
    the device time of ``ops.quantize_boundary`` on them as the step
    hands them over (a strided tensor is copied to rows first), by
    kernel; and the quantizer kernel's own device time at the
    autoencoder latent's 392 x 3, beside the event-pair floor of
    ``time_ms``. Run after the main path's count is read."""
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.no_grad():
        z = adapter.forward_a(pa, b)
    z_tx = ops.ste_quantize(z).requires_grad_()
    with torch.enable_grad():
        dz, = torch.autograd.grad(adapter.loss_b(pb, z_tx, b), z_tx)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    latent = quant_input(392, 3, torch.float32,
                         torch.Generator(device="cuda").manual_seed(0))
    parts = [f"empty event pair {time_ms(lambda: None, flush=flush):.4f} ms"]
    for name, fn, t in (
            ("z", lambda: ops.quantize_boundary(z), z),
            ("dz", lambda: ops.quantize_boundary(dz), dz),
            ("latent 392x3 rows", lambda: split_quant.quantize_rows(latent),
             latent)):
        kern = device_ms(fn, flush)
        detail = ", ".join(f"{k[:48]} {c:g}x {ms:.4f} ms"
                           for k, c, ms in kern)
        parts.append(f"{name} {tuple(t.shape)} stride {t.stride()} "
                     f"contiguous {t.is_contiguous()}: device "
                     f"{sum(ms for *_, ms in kern):.4f} ms per call "
                     f"({detail})")
    return ("boundary layout on the card (torch.profiler, 20 calls, L2 "
            "flushed): " + "; ".join(parts))


def profile_sl_steps(sl_pass, state, batches, label):
    """Kernel time by name over one pass of a few SL steps, against the
    same pass's host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    n = len(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sl_pass(state, batches)
    float(res.losses[-1])
    step = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = sl_pass(res.state, batches)
        float(res.losses[-1])
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / n / 1e3
    if busy == 0:
        print(f"profile: SL step {step:.2f} ms; device time not measured "
              "(the profiler saw no kernels)")
        return
    print(f"profile of {n} SL steps [{label}]: step {step:.2f} ms (host "
          f"clock, unprofiled), kernels {busy:.3f} ms/step, device idle "
          f"{max(0.0, 1 - busy / step):.1%}")
    for e in sorted(kern, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / n / 1e3:8.4f} ms/step  "
              f"{e.count / n:6.1f}x  {e.key[:90]}")


def autoencoder_pass_224(label):
    """One autoencoder pass at 224 px: the quantizer at d = 3."""
    adapter = sl_step.autoencoder_adapter(cut=5, img=224)
    shards = ImageryShards(img=224, batch=RING_BATCH, n_shards=1)
    opt = resolve_optimizer("sgd", lr=1e-2)
    state = SLTrainState.create(*adapter.init(torch.Generator(
        device="cuda").manual_seed(0)), opt)
    sl_pass = sl_step.make_sl_pass(adapter, quantize_boundary=True,
                                   optimizer=opt)
    batches = [shards.batch_at(0, i) for i in range(4)]
    n0 = split_quant.quantize_rows.launches
    res = sl_pass(state, batches)
    losses = res.losses.tolist()
    check(split_quant.quantize_rows.launches - n0 == 2 * len(batches),
          "2 quantizer launches per autoencoder step")
    check(all(np.isfinite(losses)), f"autoencoder losses {losses}")
    check(res.dtx_bits_down == RING_BATCH * 7 * 7 * 3 * 8,
          "autoencoder latent payload")
    print(f"train autoencoder 224px cut 5, one pass of {len(batches)} steps "
          f"[{label}]: losses {[round(x, 5) for x in losses]}, boundary "
          f"{res.dtx_bits_down} bits per step (8x7x7x3 int8)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(secs)} "
          f"(nvcc sm_90a, in parallel)")
    for name in secs:                      # the compiler's -Xptxas=-v report
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {"flash_attn_fwd": [], "decode_attn": [], "split_quant": [],
            "mamba_scan": [], "mlstm_scan": []}
    for dtype in (torch.bfloat16, torch.float32):
        for S in PREFILL_S:
            rows["flash_attn_fwd"].append(check_prefill(dtype, S, gen, flush))
        rows["decode_attn"].append(check_decode(dtype, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):     # Zamba2's MHA heads
        rows["flash_attn_fwd"].append(check_prefill(
            dtype, 512, gen, flush, H=MHA_H, KV=MHA_H))
        rows["decode_attn"].append(check_decode(dtype, gen, flush, H=MHA_H,
                                                KV=MHA_H))
    for dtype in (torch.bfloat16, torch.float32):     # head dim 16 (smoke)
        rows["flash_attn_fwd"].append(check_prefill(
            dtype, 512, gen, flush, H=SMOKE_H, KV=SMOKE_H, D=SMOKE_D))
        rows["decode_attn"].append(check_decode(
            dtype, gen, flush, H=SMOKE_H, KV=SMOKE_H, D=SMOKE_D))
    for r, d, dtype in QUANT_SHAPES:
        rows["split_quant"].append(check_quant(r, d, dtype, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MAMBA_SHAPES:
            rows["mamba_scan"].append(check_mamba(dtype, B, S, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MLSTM_SHAPES:
            rows["mlstm_scan"].append(check_mlstm(dtype, B, S, gen, flush))
    print(f"kernels vs plain on {smi} (ms, median of 20, L2 flushed):")
    for name, rs in rows.items():
        for r in rs:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            ratios = ""
            if name in ("flash_attn_fwd", "mlstm_scan"):
                vs_lib = ("n/a" if r["library_ms"] is None
                          else f"{r['ms'] / r['library_ms']:.2f}x")
                ratios = (f" kernel/library {vs_lib} kernel/bound "
                          f"{r['ms'] / r['bound_ms']:.1f}x")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} plain "
                  f"{r['plain_ms']:.4f} library {lib} bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
                  f"{r['max_abs_err']:.3e}{ratios}")
            if name == "mlstm_scan":
                stages = "; ".join(f"{k[:40]} {c:g}x {ms:.4f} ms"
                                   for k, c, ms in r["stages"] or [])
                print(f"    h of the plain version at chunk 256 vs at the "
                      f"kernel's chunk: {r['spread']:.3e}"
                      + (f"; device time by kernel (torch.profiler, 20 "
                         f"calls): {stages}" if stages else ""))
    scan = rows["mamba_scan"][2]                      # S=512 bf16
    print(f"  mamba_scan bound at S=512 bf16: {scan['bytes'] / 1e6:.2f} MB "
          f"-> {scan['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; "
          f"{scan['ops'] / 1e9:.3f} GFLOP -> "
          f"{scan['ops'] / PEAK_OPS[torch.bfloat16] * 1e3:.4f} ms at the "
          f"bf16 tensor peak, {scan['ops'] / PEAK_OPS[torch.float32] * 1e3:.4f}"
          f" ms at the f32 peak; the script uses the inputs' type (bf16): "
          f"bound {scan['bound_ms']:.4f} ms by {scan['bound_by']}")
    mscan = rows["mlstm_scan"][2]                     # S=512 bf16
    print(f"  mlstm_scan bound at S=512 bf16: {mscan['bytes'] / 1e6:.2f} MB "
          f"-> {mscan['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{mscan['ops'] / 1e9:.3f} GFLOP -> "
          f"{mscan['ops'] / PEAK_OPS[torch.bfloat16] * 1e3:.4f} ms at the "
          f"bf16 tensor peak, "
          f"{mscan['ops'] / PEAK_OPS[torch.float32] * 1e3:.4f} ms at the "
          f"f32 peak; bound {mscan['bound_ms']:.4f} ms by "
          f"{mscan['bound_by']}")
    del flush

    paths = {"smollm_360m": serve_full_width("smollm_360m", smi)}
    torch.cuda.empty_cache()
    paths["resnet18_ring"] = {"split_quant": train_full_width(smi)}
    autoencoder_pass_224(smi)
    torch.cuda.empty_cache()
    paths["zamba2_1_2b"] = serve_full_width("zamba2_1_2b", smi)
    torch.cuda.empty_cache()
    paths["xlstm_1_3b"] = serve_full_width("xlstm_1_3b", smi)
    print(f"launches on the main paths: {paths}")
    launches = {n: sum(p.get(n, 0) for p in paths.values()) for n in WRAPPERS}

    # the kernels at the main paths' largest shapes (attention in bf16 at
    # SmolLM's heads, the quantizer at ResNet-18's f32 l2 boundary, the
    # scans in bf16 at S=512)
    pick = {"flash_attn_fwd": rows["flash_attn_fwd"][PREFILL_S.index(512)],
            "decode_attn": rows["decode_attn"][0],
            "split_quant": rows["split_quant"][0],            # 6272 x 128
            "mamba_scan": scan, "mlstm_scan": mscan}
    meta = {"flash_attn_fwd": ("src/repro_torch/csrc/flash_attn_fwd.cu",
                               "src/repro/kernels/flash_attn.py:126"),
            "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                            "src/repro/kernels/decode_attn.py:88"),
            "split_quant": ("src/repro_torch/csrc/split_quant.cu",
                            "src/repro/kernels/split_quant.py:35"),
            "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:101"),
            "mlstm_scan": ("src/repro_torch/csrc/mlstm_scan.cu",
                           "src/repro/kernels/mlstm_scan.py:129")}
    kernels = [dict(name=n, route="cuda", source=meta[n][0],
                    replaces=meta[n][1], launches=launches[n],
                    max_abs_err=max(r["max_abs_err"] for r in rows[n]
                                    if n == "split_quant"
                                    or "bfloat16" in r["shape"]),
                    ms=pick[n]["ms"], plain_ms=pick[n]["plain_ms"],
                    bound_ms=pick[n]["bound_ms"], bound_by=pick[n]["bound_by"],
                    library_ms=pick[n]["library_ms"])
               for n in ("flash_attn_fwd", "decode_attn", "split_quant",
                         "mamba_scan", "mlstm_scan")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
