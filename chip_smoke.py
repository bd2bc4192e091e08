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
     P=1024), and both entries of the SL boundary quantizer (codes and
     scales; the fused quantize-dequantize) against their plain versions
     bit for bit at the training path's shapes, as row-major rows and as
     the channel-major NHWC view of NCHW memory that the conv stages hand
     over, with each kernel's time, bound, plain time and library
     yardstick (and their ratios), the quantizer's device time beside
     that of a copy of its input, the device time of each stage of the
     two scans in bf16, and the split count of flash decode, whose two
     runs must agree bit for bit;
  4. full-width SmolLM-360M split-model serving (cut at unit 16) through
     both attention kernels: launch counts, split == unsplit greedy
     tokens, one decode step's logits on the kernel path against the
     plain path;
  5. the paper's training loop: a 25-satellite Table-I ring training
     full-width ResNet-18 (224 px, cut l2, batch 8, SGD) with the int8
     boundary through the fused quantizer (exactly 2 launches per SL
     step, no copy: one kernel per crossing), finite losses, the metered
     boundary payload, one step's loss on the kernel path against the
     plain path, step times and a profile; then one autoencoder pass at
     224 px;
  6. full-width Zamba2-1.2B split-model serving (cut at unit 3) through
     the scan kernel (prefill) and both attention kernels (the shared
     block): launch counts, split == unsplit greedy tokens, one prefill's
     and one decode step's logits on the kernel path against the plain
     path, times and profiles;
  7. full-width xLSTM-1.3B split-model serving (cut at unit 3) through
     the mLSTM scan kernel (prefill; decode and the sLSTM recurrence are
     plain PyTorch): phase 6's checks, no kernel launch in a decode step,
     and the f32 prefill logits held within the spread of two exact
     mLSTM chunkings instead of 1e-3;
  8. the device-resident closed loop (repro_torch.sim): (a) one revolution
     of the Table-I plane training full-width ResNet-18 (224 px, cut l2,
     batch 8, int8 boundary, SGD) on batches generated on the card, 6 of
     8 executed steps a pass valid and two satellites below reserve, the
     device engine against the host engine on the same provider (equal
     actions, losses, batteries and energies at the reference's
     host-vs-device tolerances), no host sync inside the revolution (the
     engine runs it under sync-debug mode "error"), 2 quantizer launches
     per executed step and no copy, with passes/s, steps/s, card time and
     idle share per revolution, batch generation and plan solve times;
     (b) the reference example's 1000-satellite ring (autoencoder at
     32 px, batch 2, 200 J batteries, int8 boundary), streamed one host
     sync per revolution, reserve skips by the third revolution, the
     quantizer held bit for bit on the ring's own z and dz, and the host
     engine timed on the first 250 passes of the same ring.
Each phase prints its elapsed time. Every profile is framed by marker
kernels (cuda_events), since torch.profiler can drop a trace's first
kernels.
Phases 4, 6 and 7 also print the satellite's joules per token at their
measured rate (serve_cost). The last two lines are the kernels' JSON
record and the result JSON.
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
from repro_torch.core import resource_opt  # noqa: E402
from repro_torch.core.constellation import (ConstellationConfig,  # noqa: E402
                                            ConstellationSim)
from repro_torch.core.energy import PassBudget  # noqa: E402
from repro_torch.core.orbits import OrbitalPlane  # noqa: E402
from repro_torch.core.splitting import RESNET18_PAPER_CUTS  # noqa: E402
from repro_torch.core.train_state import SLTrainState  # noqa: E402
from repro_torch.data.synthetic import ImageryShards  # noqa: E402
from repro_torch.kernels import (_build, decode_attn, flash_attn,  # noqa: E402
                                 mamba_scan, mlstm_scan, ops, split_quant)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.param import map_tree  # noqa: E402
from repro_torch.train.optimizer import resolve_optimizer  # noqa: E402
from repro_torch.utils.bucketing import bucket_size  # noqa: E402
from repro_torch.utils.treeutil import tree_leaves  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serve_fleet.engine import (SplitDecodeEngine,  # noqa: E402
                                            serve_cost)
from repro_torch.sim import (ACTION_SKIPPED, ACTION_TRAINED,  # noqa: E402
                             DeviceConstellationSim, DeviceImageryShards,
                             DeviceSimConfig, plan_ring_passes)

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
# The same boundaries as the training path hands them over on the card,
# an NHWC view of NCHW memory (channel-major rows): ResNet-18's l2 z and
# dz, the autoencoder latent at 224 px, and at 32 px and batch 2 (phase
# 8b's ring, 12,000 of the main paths' launches; phase 8b also holds the
# kernel against the plain version on its own z and dz).
QUANT_CM_SHAPES = [((8, 28, 28, 128), torch.float32),
                   ((8, 28, 28, 128), torch.bfloat16),
                   ((8, 7, 7, 3), torch.float32),
                   ((2, 1, 1, 3), torch.float32)]
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
# Marker kernels on each side of a profiled region (cuda_events): runs on
# the H100 lost 1-4 of a trace's first kernels.
PROFILE_EDGE = 4


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
    again = decode_attn.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"decode {dtype} H={H} D={D}: two runs "
          f"differ (the split merge must be deterministic)")
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
        splits=decode_attn.n_splits(DECODE_S, D, dtype),
        split_rows=decode_attn.split_rows(D, dtype),
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


def quant_cases(gen):
    """(label, x) for phase 3: QUANT_SHAPES as row-major rows, then
    QUANT_CM_SHAPES as channel-major rows (the NHWC view of NCHW memory)."""
    for rows, d, dtype in QUANT_SHAPES:
        yield (f"rows={rows} d={d} {str(dtype)[6:]} row-major",
               quant_input(rows, d, dtype, gen))
    for (N, H, W, C), dtype in QUANT_CM_SHAPES:
        x = quant_input(N * H * W, C, dtype, gen).reshape(N, H, W, C)
        yield (f"{(N, H, W, C)} {str(dtype)[6:]} channel-major",
               x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))


def check_quant(label, x, fused, flush):
    """One quantizer entry against its plain version, bit for bit, with no
    copy of x: the fused quantize-dequantize (xhat in x's strides) or the
    codes and scales. Timed by event pairs and by device time per kernel,
    beside the device time of a ``copy_`` of x into x's layout (x read
    and written once: a practical floor, not a library call)."""
    entry = (split_quant.quantize_dequantize if fused
             else split_quant.quantize_rows)
    plain = (split_quant.quantize_dequantize_plain if fused
             else split_quant.quantize_rows_plain)
    c0 = split_quant.copies
    got, want = flat(entry(x)), flat(plain(x))
    torch.cuda.synchronize()
    what = f"quantizer {entry.__name__} {label}"
    check(split_quant.copies == c0, f"{what}: x was copied")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{what}: not bit-identical to plain")
    check(not fused or got[0].stride() == x.stride(),
          f"{what}: xhat strides {got[0].stride()} != x's {x.stride()}")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    n, rows = x.numel(), x.numel() // x.shape[-1]
    # read x once; write xhat in x's dtype, or the int8 codes and the f32
    # scales, once; about six f32 operations per element (abs, max,
    # divide, round, 2 clips)
    out_bytes = n * x.element_size() if fused else n + 4 * rows
    b_ms, b_by = bound(n * x.element_size() + out_bytes, 6 * n,
                       torch.float32)
    dst = torch.empty_like(x)
    return dict(
        shape=f"{entry.__name__} {label}", max_abs_err=err,
        ms=time_ms(lambda: entry(x), flush=flush),
        plain_ms=time_ms(lambda: plain(x), flush=flush),
        device=device_ms(lambda: entry(x), flush),
        copy_ms=sum(ms for *_, ms in device_ms(lambda: dst.copy_(x), flush)),
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
    """The SSD scan kernel against its plain version at Zamba2's heads; in
    bf16 its three launches are timed by name (``stages``)."""
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
    run = lambda: mamba_scan.mamba_chunk_scan(*args, chunk=MAMBA_CHUNK)
    return dict(
        shape=f"scan B={B} S={S} H={Hm} P={P} N={N} chunk {MAMBA_CHUNK} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(run, flush=flush),
        plain_ms=time_ms(lambda: mamba_scan.mamba_chunk_scan_plain(
            *args, chunk=MAMBA_CHUNK), flush=flush),
        stages=device_ms(run, flush) if dtype == torch.bfloat16 else None,
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
            "split_quant": split_quant.quantize_dequantize}
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
    # the satellite's joules per token at the measured rate, Table-I link
    # and device (PassBudget() defaults), the bf16 boundary's bits
    cost = serve_cost(cfg, params, cut, tokens_per_s=n_tok / wall,
                      act_bits=split.act_dtype.itemsize * 8)
    check(cost.e_token_j > 0 and cost.dtx_bits_token
          == split.boundary_bits_per_token, f"serve cost {cost}")
    print(f"serve {arch} split@{cut}, 8 slots, s_max 2048, 16 requests "
          f"(prompts {plens.min()}-{plens.max()}), 32 new tokens each [{label}]")
    print(f"  {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s "
          f"[{label}]")
    print(f"  serve_cost at {cost.tokens_per_s:.1f} tok/s: e_token_j "
          f"{cost.e_token_j:.6g} J per token on the satellite (DVFS compute "
          f"of units [0, {cut}) + downlink of {cost.dtx_bits_token:.0f} "
          f"bits), PassBudget() defaults; a 90 s window serves "
          f"{cost.window_capacity_requests(90.0, 32):.0f} requests of 32 "
          f"tokens")
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


def cuda_events(run, cpu=True, whole=None):
    """The kernels (CUDA events by name) of torch.profiler's trace of
    ``run()``. The profiler has lost the first kernels of a trace on the
    H100 (all of a trace's quantizer launches once, 1 of 20 another time,
    in phase 5; 3 marker kernels at one edge of every CPU+CUDA trace), so
    the trace is framed by ``PROFILE_EDGE`` marker kernels on each side
    (``torch.cuda._sleep``'s ``spin_kernel``, left out of the result),
    which a loss at an edge takes first. A kernel-only trace (``cpu``
    false, a few ms) is taken again, each time of a new ``run()``, up to
    3 traces, while no marker is left before or after every other kernel
    or ``whole(kernels)`` is false; a CPU+CUDA trace (a revolution, a
    few prefills: a minute to parse) is taken once and a missing frame
    reported. The last trace is returned as it is, for the caller's
    checks to judge."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    cuda = torch.autograd.DeviceType.CUDA
    attempts = 1 if cpu else 3
    for attempt in range(attempts):
        with profile(activities=acts) as prof:
            time.sleep(0.02)
            for _ in range(PROFILE_EDGE):
                torch.cuda._sleep(1000)
            run()
            for _ in range(PROFILE_EDGE):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == cuda]
        spins = [e.time_range.start for e in evs if "spin_kernel" in e.name]
        work = [e.time_range.start for e in evs
                if "spin_kernel" not in e.name]
        lead = sum(t <= min(work) for t in spins) if work else 0
        tail = sum(t >= max(work) for t in spins) if work else 0
        kern = [e for e in prof.key_averages()
                if e.device_type == cuda and "spin_kernel" not in e.key]
        if lead and tail and (whole is None or whole(kern)):
            break
        print(f"  (torch.profiler trace {attempt + 1} of {attempts} is not "
              f"whole: markers before the work {lead} of {PROFILE_EDGE}, "
              f"after it {tail} of {PROFILE_EDGE})")
    return kern


def profile_calls(fn, n, what, label):
    """Kernel time by name over ``n`` calls of ``fn`` (each returning host
    values, so synced), against the same calls' host-clock time."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    call = (time.perf_counter() - t0) / n * 1e3

    def run():
        for _ in range(n):
            fn()
    kern = cuda_events(run)
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
OUR_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel",
               "decode_split_kernel", "ssd_kernel", "ssd_chunk_kernel",
               "ssd_state_kernel", "ssd_out_kernel", "mlstm_chunk_kernel",
               "mlstm_norm_kernel", "mlstm_value_kernel", "mlstm_fma_kernel",
               "quant_kernel", "quant_cm_kernel")


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

        split_quant.quantize_dequantize.launches = 0
        split_quant.quantize_rows.launches = 0
        split_quant.copies = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_dequantize.launches
        other = (split_quant.quantize_rows.launches, split_quant.copies)
        handoffs = sorted(Path(handoff_dir).iterdir())
    steps = int(sim.state.step)
    check(steps == sum(min(max(1, round(r.n_items / RING_BATCH)), RING_STEPS)
                       for r in records if r.action in ("trained", "shed")),
          "step counter == the passes' allocated steps")
    check(launches == 2 * steps > 0,
          f"fused quantizer launches {launches} != 2 x {steps} SL steps")
    check(other == (0, 0), f"quantize_rows launches and wrapper copies "
          f"{other} on the ring (want none)")
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
    kernel_quant = split_quant.quantize_dequantize
    split_quant.quantize_dequantize = split_quant.quantize_dequantize_plain
    try:
        rp = step(pa, pb, batch)
    finally:
        split_quant.quantize_dequantize = kernel_quant
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
    print(f"  fused quantizer launches {launches} = 2 x {steps} steps, "
          f"quantize_rows launches and wrapper copies {other}; boundary "
          f"{bits:.0f} bits/item int8 = 1/4 of {L2_F32_DTX_BITS}; step loss "
          f"kernel {lk:.7f} vs plain {lp:.7f}, grads_a max abs diff "
          f"{g_err:.3e}")
    print(f"  {layout} [{label}]")
    profile_sl_steps(sim.sl_pass, state, dev_batches[:4], label)
    return launches, gen_ms


def device_ms(fn, flush, n=20):
    """Device time per call of ``fn`` by kernel, from torch.profiler (no
    host gaps, unlike a pair of events around a Python call): a list of
    (kernel name, launches per call, ms per call). ``flush`` is zeroed
    before each call and its fill left out."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            flush.zero_()
            fn()
    is_fill = lambda e: "FillFunctor" in e.key or "Memset" in e.key
    # whole: every call's flush is in the trace
    kern = cuda_events(run, cpu=False, whole=lambda kern: sum(
        e.count for e in kern if is_fill(e)) >= n)
    return [(e.key, e.count / n,
             getattr(e, "self_device_time_total", 0) / n / 1e3)
            for e in kern if not is_fill(e)]


def boundary_layout(adapter, pa, pb, batch):
    """How z and dz reach the quantizer (strides), and the device time of
    the STE forward (``ops.ste_quantize``) on them as the step hands them
    over, by kernel: each crossing must be one launch of the quantizer
    kernel and nothing else (no copy, no elementwise pass). Then segment
    B's forward and backward on the quantized z in z's strides, against
    the same on an NHWC-contiguous z (the quantizer's output layout before
    it kept x's strides): the device time of both and the kernels only
    one of them runs. Run after the main path's count is read."""
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.no_grad():
        z = adapter.forward_a(pa, b)
    z_tx = ops.ste_quantize(z).requires_grad_()
    with torch.enable_grad():
        dz, = torch.autograd.grad(adapter.loss_b(pb, z_tx, b), z_tx)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    parts = [f"empty event pair {time_ms(lambda: None, flush=flush):.4f} ms"]
    for name, t in (("z", z), ("dz", dz)):
        kern = device_ms(lambda: ops.ste_quantize(t), flush)
        check(len(kern) == 1 and kern[0][1] == 1
              and any(f"::{k}<" in kern[0][0] for k in ("quant_kernel",
                                                         "quant_cm_kernel")),
              f"{name}: one quantizer kernel per crossing, got {kern}")
        parts.append(f"{name} {tuple(t.shape)} stride {t.stride()} "
                     f"contiguous {t.is_contiguous()}: STE forward "
                     f"{kern[0][2]:.4f} ms of device time per call, one "
                     f"kernel ({kern[0][0][:56]})")

    pbg = map_tree(lambda t: t.detach().requires_grad_(), pb)

    def segment_b(zin):
        def run():
            zz = zin.detach().requires_grad_()
            with torch.enable_grad():
                torch.autograd.grad(adapter.loss_b(pbg, zz, b),
                                    [zz] + tree_leaves(pbg))
        return run

    kept = device_ms(segment_b(z_tx), flush, n=5)
    dense = device_ms(segment_b(z_tx.contiguous()), flush, n=5)
    names = lambda kern: {k for k, *_ in kern}
    only = lambda a, b_: ", ".join(f"{k[:64]} {c:g}x {ms:.4f} ms"
                                   for k, c, ms in a
                                   if k not in names(b_)) or "none"
    parts.append(f"segment B fwd+bwd: z in its strides "
                 f"{sum(ms for *_, ms in kept):.4f} ms of device time, "
                 f"NHWC-contiguous {sum(ms for *_, ms in dense):.4f} ms; "
                 f"kernels only with NHWC-contiguous z: {only(dense, kept)}; "
                 f"only with z in its strides: {only(kept, dense)}")
    return ("boundary layout on the card (torch.profiler, L2 flushed): "
            + "; ".join(parts))


def profile_sl_steps(sl_pass, state, batches, label):
    """Kernel time by name over one pass of a few SL steps, against the
    same pass's host-clock time."""
    n = len(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sl_pass(state, batches)
    float(res.losses[-1])
    step = (time.perf_counter() - t0) / n * 1e3

    def run():
        nonlocal res
        res = sl_pass(res.state, batches)
        float(res.losses[-1])
    kern = cuda_events(run)
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
    quant = [e for e in kern if any(f"::{k}<" in e.key for k in (
        "quant_kernel", "quant_cm_kernel"))]
    print("  the boundary's kernels: " + (", ".join(
        f"{e.key[:56]} {e.count / n:g}x {dev_us(e) / n / 1e3:.4f} ms/step"
        for e in quant) or "none"))


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
    n0 = split_quant.quantize_dequantize.launches
    c0 = split_quant.copies
    res = sl_pass(state, batches)
    losses = res.losses.tolist()
    check(split_quant.quantize_dequantize.launches - n0 == 2 * len(batches),
          "2 fused quantizer launches per autoencoder step")
    check(split_quant.copies == c0, "no copy of the autoencoder latent")
    check(all(np.isfinite(losses)), f"autoencoder losses {losses}")
    check(res.dtx_bits_down == RING_BATCH * 7 * 7 * 3 * 8,
          "autoencoder latent payload")
    print(f"train autoencoder 224px cut 5, one pass of {len(batches)} steps "
          f"[{label}]: losses {[round(x, 5) for x in losses]}, boundary "
          f"{res.dtx_bits_down} bits per step (8x7x7x3 int8)")


# Phase 8a: one revolution of the Table-I plane on the device engine, at
# phase 5's width, against the host engine; the reference's host-vs-device
# tolerances (tests/test_device_sim.py:33-52). Capped at 6 SL steps a
# pass, so every pass executes K = bucket_size(6) = 8 steps, 2 of them
# masked, and two satellites start at 90 J, below the 100 J reserve, so
# their passes are skipped (all 8 steps masked). Solar recharge at 1 mW
# (0.23 J a 227-s pass) keeps them below it until their turn.
LOOP_TOL = dict(loss=(2e-4, 1e-5), battery=(1e-5, 0.05), e_total=(1e-5, 1e-9))
LOOP_STEPS, LOOP_LOW_SATS, LOOP_LOW_J, LOOP_RECHARGE_W = (
    6, (3, 17), 90.0, 1e-3)
# Phase 8b: examples/constellation_device_sim.py's single ring (60-71),
# with the int8 boundary on; skips need a third revolution (200 J, ~48 J
# a pass, reserve 150 J).
BIG_RING, BIG_REVS = 1000, 3
# ... and the host engine, timed on a cut of its first revolution
HOST_PASSES = 250


def quant_kernels(kern):
    """(launches, device ms) of the quantizer kernel among a trace's
    kernels."""
    ev = [e for e in kern if any(f"::{k}<" in e.key for k in (
        "quant_kernel", "quant_cm_kernel"))]
    return (sum(e.count for e in ev),
            sum(getattr(e, "self_device_time_total", 0) for e in ev) / 1e3)


def profile_revolution(eng, label):
    """One more revolution of ``eng``, unprofiled (host clock, ending in
    the engine's telemetry read) then profiled: card time by kernel, idle
    share, and the quantizer's launches seen by the profiler."""
    t0 = time.perf_counter()
    eng.run(1)
    wall = time.perf_counter() - t0
    counted = 0

    def run():
        nonlocal counted
        n0 = split_quant.quantize_dequantize.launches
        eng.run(1)
        counted = split_quant.quantize_dequantize.launches - n0
    kern = cuda_events(run)
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / 1e3
    q_n, q_ms = quant_kernels(kern)
    check(busy > 0, "the profiler saw the revolution's kernels")
    check(q_n == counted == 2 * eng.n_sats * eng.scan_steps,
          f"quantizer launches: profiler {q_n}, wrapper {counted}")
    steps = eng.n_sats * eng.scan_steps
    print(f"  profile of one revolution [{label}]: {wall * 1e3:.1f} ms host "
          f"clock (unprofiled), {busy:.1f} ms of card time, device idle "
          f"{max(0.0, 1 - busy / (wall * 1e3)):.1%}; per executed step "
          f"{wall * 1e3 / steps:.3f} ms host clock, {busy / steps:.3f} ms "
          f"of card time; quantizer {q_n} launches (profiler = wrapper "
          f"count), {q_ms:.3f} ms")
    for e in sorted(kern, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:80]}")
    return wall, busy


def device_loop_full_width(label, numpy_gen_ms):
    """Phase 8a: the device engine at full width against the host engine."""
    adapter = sl_step.resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                       img=224)
    shards = DeviceImageryShards(img=224, batch=RING_BATCH, device="cuda")
    budget = PassBudget()                      # Table I: 25 sats, 400 items
    cfg = ConstellationConfig(n_passes=budget.plane.n_sats, optimizer="sgd",
                              quantize_boundary=True,
                              max_steps_per_pass=LOOP_STEPS,
                              recharge_w=LOOP_RECHARGE_W)
    host = ConstellationSim(adapter, budget, shards, cfg, device="cuda")
    dev = ConstellationSim(adapter, budget, shards, cfg, device="cuda")
    for sim in (host, dev):              # the device engine takes them over
        for i in LOOP_LOW_SATS:
            sim.sats[i].battery_j = LOOP_LOW_J
    warm = SLTrainState.create(*adapter.init(torch.Generator(
        device="cuda").manual_seed(1)), host.optimizer)
    host.sl_pass(warm, [shards(0, 0)])            # cuDNN/cuBLAS handles
    del warm
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.run()
        torch.cuda.synchronize()
        host_wall = time.perf_counter() - t0
        split_quant.quantize_dequantize.launches = 0
        split_quant.quantize_rows.launches = 0
        split_quant.copies = 0
        t0 = time.perf_counter()
        dev.run(engine="device")                  # ends in its telemetry read
        wall = time.perf_counter() - t0
        launches = split_quant.quantize_dequantize.launches
        other = (split_quant.quantize_rows.launches, split_quant.copies)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eng = dev.device_engine
    steps = eng.scan_steps
    skipped = [r.sat_id for r in dev.records if r.action == "skipped_energy"]
    planned = set(eng._host_plan.n_steps.tolist())
    check(skipped == list(LOOP_LOW_SATS) and planned == {LOOP_STEPS}
          and steps == bucket_size(LOOP_STEPS) > LOOP_STEPS,
          f"masked steps: skipped sats {skipped}, planned steps {planned}, "
          f"executed {steps} a pass")
    check(launches == 2 * budget.plane.n_sats * steps > 0,
          f"quantizer launches {launches} != 2 x {budget.plane.n_sats} "
          f"passes x {steps} steps")
    check(other == (0, 0), f"quantize_rows launches and copies {other}")
    check(eng.traces == 1 and eng.device_calls == eng.host_syncs == 1,
          f"one build, dispatch and sync: {eng.traces}, {eng.device_calls}, "
          f"{eng.host_syncs}")
    acts = [r.action for r in host.records]
    check([r.action for r in dev.records] == acts,
          f"actions: host {acts}, device {[r.action for r in dev.records]}")
    errs = dict(loss=0.0, battery=0.0, e_total=0.0)
    for h, d in zip(host.records, dev.records):
        for key, hv, dv in (("loss", h.loss, d.loss),
                            ("battery", h.battery_j, d.battery_j),
                            ("e_total", h.e_total_j, d.e_total_j)):
            if hv is None:
                check(dv is None, "a skipped pass has no loss")
                continue
            rtol, atol = LOOP_TOL[key]
            check(np.isfinite(dv) and abs(dv - hv) <= atol + rtol * abs(hv),
                  f"{key}: device {dv} host {hv}")
            errs[key] = max(errs[key], abs(dv - hv) / max(abs(hv), 1e-30))
    valid = sum(min(max(1, round(r.n_items / RING_BATCH)), LOOP_STEPS)
                for r in dev.records if r.loss is not None)
    print(f"device loop resnet18 224px cut l2 batch {RING_BATCH}, one "
          f"revolution of the 25-sat Table-I plane, {LOOP_STEPS} SL steps "
          f"of {steps} executed a pass, sats {list(LOOP_LOW_SATS)} at "
          f"{LOOP_LOW_J:g} J (reserve {cfg.reserve_j:g} J), recharge "
          f"{LOOP_RECHARGE_W:g} W, int8 boundary, sgd, TF32 off, cudnn.deterministic "
          f"[{label}]")
    print(f"  actions {acts}; losses "
          f"{[r.loss and round(r.loss, 4) for r in dev.records]}")
    print(f"  device engine == host engine: actions equal; largest relative "
          f"difference loss {errs['loss']:.2e}, battery {errs['battery']:.2e}, "
          f"e_total {errs['e_total']:.2e}; no host sync inside the "
          f"revolution (sync-debug mode 'error' around it)")
    print(f"  device engine: 25 passes in {wall:.3f} s = {25 / wall:.2f} "
          f"passes/s, {valid / wall:.2f} valid SL steps/s incl. planning "
          f"and the telemetry read; host engine (same provider) "
          f"{host_wall:.3f} s = {valid / host_wall:.2f} steps/s [{label}]")
    print(f"  masked steps {25 * steps - valid} of {25 * steps}: "
          f"{len(skipped)} skipped passes x {steps} + {25 - len(skipped)} "
          f"passes x {steps - LOOP_STEPS} beyond the allocation; quantizer "
          f"launches {launches} = 2 x 25 passes x {steps} executed steps "
          f"(masked included), quantize_rows launches and copies {other}")
    rev_wall, busy = profile_revolution(eng, label)

    # batch generation on the card (per batch) beside phase 5's NumPy
    sat, idx = torch.arange(25, device="cuda")[3:4], eng._batch_idx + 0
    gen_ms = time_ms(lambda: shards(sat, idx))
    print(f"  batch generation on the card (DeviceImageryShards, {RING_BATCH}"
          f"x224x224x3 + labels): {gen_ms:.3f} ms per batch (CUDA events, "
          f"median of 20) vs NumPy ImageryShards {numpy_gen_ms:.2f} ms in "
          f"phase 5 [{label}]")
    # the plan: 25 instances, float64 on the card vs the NumPy planner
    costs, times = eng.costs, {"torch": [], "numpy": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = plan_ring_passes(budget, costs, batch_size=RING_BATCH,
                                max_steps_per_pass=RING_STEPS, device="cuda")
        int(plan.n_steps[0])                         # ends in a sync
        times["torch"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        resource_opt.solve_with_shedding_batch([budget] * 25, [costs] * 25,
                                               backend="numpy")
        times["numpy"].append((time.perf_counter() - t0) * 1e3)
    print(f"  plan of 25 instances: torch float64 on the card "
          f"{statistics.median(times['torch']):.2f} ms (80 masked bisection "
          f"steps, host clock ending in a sync), NumPy planner "
          f"{statistics.median(times['numpy']):.2f} ms (median of 5) "
          f"[{label}]")
    return launches


def boundary_bitwise(adapter, state, batch):
    """z and dz of one SL step as the step hands them to the quantizer,
    each held bit for bit against the plain version by both entries, with
    no copy. Run after the main path's count is read."""
    with torch.no_grad():
        z = adapter.forward_a(state.params_a, batch)
    z_tx = ops.ste_quantize(z).requires_grad_()
    with torch.enable_grad():
        dz, = torch.autograd.grad(adapter.loss_b(state.params_b, z_tx, batch),
                                  z_tx)
    parts = []
    for name, t in (("z", z), ("dz", dz)):
        check((tuple(t.shape), t.dtype) in QUANT_CM_SHAPES,
              f"{name} {tuple(t.shape)} {t.dtype} is not a phase-3 shape")
        for entry, plain in ((split_quant.quantize_dequantize,
                              split_quant.quantize_dequantize_plain),
                             (split_quant.quantize_rows,
                              split_quant.quantize_rows_plain)):
            c0 = split_quant.copies
            got, want = flat(entry(t)), flat(plain(t))
            check(split_quant.copies == c0
                  and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name}: {entry.__name__} not bit-identical to plain, or "
                  f"copied, at the path's boundary")
        parts.append(f"{name} {tuple(t.shape)} stride {t.stride()}")
    return parts


def device_loop_1000(label):
    """Phase 8b: the reference example's 1000-satellite ring, then one
    revolution of the host engine on the same ring for its time."""
    adapter = sl_step.autoencoder_adapter(cut=5, img=32)
    shards = DeviceImageryShards(img=32, batch=2, device="cuda")
    budget = PassBudget(plane=OrbitalPlane(n_sats=BIG_RING), n_items=4e6)
    knobs = dict(battery_j=200.0, recharge_w=1e-4, reserve_j=150.0,
                 max_steps_per_pass=2, quantize_boundary=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = DeviceConstellationSim(adapter, budget, shards, DeviceSimConfig(
        n_revolutions=BIG_REVS, **knobs), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    split_quant.quantize_dequantize.launches = 0
    split_quant.copies = 0
    rows, actions = [], []
    torch.cuda.synchronize()
    for rev in range(BIG_REVS):
        t0 = time.perf_counter()
        res = eng.run(1, stream_telemetry=True)
        actions.append(res.action[0].tolist())
        rows.append((time.perf_counter() - t0,
                     int((res.action == ACTION_SKIPPED).sum()),
                     float(np.nanmean(res.loss)) if np.isfinite(
                         res.loss).any() else float("nan")))
    launches = split_quant.quantize_dequantize.launches
    check(eng.traces == 1 and eng.device_calls == eng.host_syncs == BIG_REVS,
          f"one sync per revolution: {eng.traces} builds, "
          f"{eng.device_calls} dispatches, {eng.host_syncs} syncs")
    check(rows[-1][1] > 0, f"reserve skips by revolution {BIG_REVS - 1}")
    check(launches == 2 * BIG_RING * eng.scan_steps * BIG_REVS
          and split_quant.copies == 0, f"quantizer launches {launches}")
    check(np.isfinite(rows[0][2]), "finite losses")
    print(f"device loop autoencoder 32px batch 2, {BIG_RING}-sat ring, "
          f"{BIG_REVS} streamed revolutions, {eng.scan_steps} steps/pass, "
          f"int8 boundary [{label}]")
    print(f"  device engine: construction {build_s:.3f} s (boundary "
          f"measured on the meta device, the {BIG_RING}-instance plan in "
          f"float64 "
          f"on the card)")
    for rev, (s, skipped, loss) in enumerate(rows):
        print(f"  rev {rev}: {s:.3f} s = {BIG_RING / s:.1f} passes/s, "
              f"skipped {skipped}, mean loss {loss:.4f} [{label}]")
    print(f"  {eng.traces} build, {eng.device_calls} dispatches, "
          f"{eng.host_syncs} telemetry syncs; quantizer launches {launches} "
          f"= 2 x {BIG_RING} x {eng.scan_steps} x {BIG_REVS}")
    sat = torch.zeros(1, dtype=torch.int64, device="cuda")
    parts = boundary_bitwise(adapter, eng.state, shards(sat, eng._batch_idx))
    print(f"  the boundary as the ring hands it over: {'; '.join(parts)}; "
          f"both entries bit-identical to plain, no copy")

    # the host engine on the same ring from a full fleet, cut to the first
    # HOST_PASSES passes of revolution 0: the same 2 steps a pass (all
    # trained); it plans the whole ring with NumPy at its first pass, after
    # peeking each satellite's first batch
    host = ConstellationSim(adapter, budget, shards, ConstellationConfig(
        n_passes=HOST_PASSES, optimizer="sgd", **knobs), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host.planner.entry_for(0, range(BIG_RING), budget,
                           [host._costs_for(s) for s in range(BIG_RING)])
    plan_s = time.perf_counter() - t0
    recs = host.run()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(all(r.action == "trained" for r in recs)
          and actions[0] == [ACTION_TRAINED] * BIG_RING,
          f"revolution 0: host {set(r.action for r in recs)}, device "
          f"{set(actions[0])}")
    check(all(np.isfinite(r.loss) for r in recs), "host engine: finite losses")
    check(host.planner.solve_calls == 1, "host engine: one plan")
    pass_s = (host_s - plan_s) / HOST_PASSES
    print(f"  host engine, same ring and provider, the first {HOST_PASSES} "
          f"passes of revolution 0: {host_s:.3f} s, of which the NumPy plan "
          f"of {BIG_RING} instances with its {BIG_RING} batch peeks "
          f"{plan_s:.3f} s; {pass_s * 1e3:.2f} ms a pass = "
          f"{1 / pass_s:.1f} passes/s, a revolution at that rate "
          f"{plan_s + BIG_RING * pass_s:.3f} s with its plan (device engine: "
          f"{rows[0][0]:.3f} s for revolution 0, its plan made at "
          f"construction) [{label}]")
    return launches


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
    t_run = time.perf_counter()

    def phase_done(what):
        print(f"[{time.perf_counter() - t_run:.1f} s] {what} done")

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
    for label, x in quant_cases(gen):
        for fused in (False, True):
            rows["split_quant"].append(check_quant(label, x, fused, flush))
    empty_ms = time_ms(lambda: None, flush=flush)
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MAMBA_SHAPES:
            rows["mamba_scan"].append(check_mamba(dtype, B, S, gen, flush))
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in MLSTM_SHAPES:
            rows["mlstm_scan"].append(check_mlstm(dtype, B, S, gen, flush))
    print(f"kernels vs plain on {smi} (ms, median of 20, L2 flushed; an "
          f"empty event pair {empty_ms:.4f}):")
    for name, rs in rows.items():
        for r in rs:
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            ratios = ""
            if name != "split_quant":
                vs_lib = ("n/a" if r["library_ms"] is None
                          else f"{r['ms'] / r['library_ms']:.2f}x")
                ratios = (f" kernel/library {vs_lib} kernel/bound "
                          f"{r['ms'] / r['bound_ms']:.1f}x")
            if name == "decode_attn":
                ratios += (f" splits {r['splits']} of {r['split_rows']} rows "
                           f"per (KV head, batch row)")
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} plain "
                  f"{r['plain_ms']:.4f} library {lib} bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
                  f"{r['max_abs_err']:.3e}{ratios}")
            if name == "split_quant":
                dev = sum(ms for *_, ms in r["device"])
                print(f"    device time (torch.profiler, 20 calls) {dev:.4f} "
                      f"ms = {dev / r['bound_ms']:.1f}x bound ("
                      + "; ".join(f"{k[:48]} {c:g}x {ms:.4f}"
                                  for k, c, ms in r["device"])
                      + f"); copy_ of x into x's layout {r['copy_ms']:.4f} ms")
            if name == "mamba_scan" and r["stages"]:
                print("    device time by kernel (torch.profiler, 20 calls): "
                      + "; ".join(f"{k[:40]} {c:g}x {ms:.4f} ms"
                                  for k, c, ms in r["stages"]))
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
    phase_done("phases 2-3 (build, kernels vs plain)")

    paths = {"smollm_360m": serve_full_width("smollm_360m", smi)}
    torch.cuda.empty_cache()
    phase_done("phase 4 (SmolLM-360M)")
    ring_launches, numpy_gen_ms = train_full_width(smi)
    paths["resnet18_ring"] = {"split_quant": ring_launches}
    autoencoder_pass_224(smi)
    torch.cuda.empty_cache()
    phase_done("phase 5 (training ring)")
    paths["zamba2_1_2b"] = serve_full_width("zamba2_1_2b", smi)
    torch.cuda.empty_cache()
    phase_done("phase 6 (Zamba2-1.2B)")
    paths["xlstm_1_3b"] = serve_full_width("xlstm_1_3b", smi)
    torch.cuda.empty_cache()
    phase_done("phase 7 (xLSTM-1.3B)")
    paths["device_loop_resnet18"] = {
        "split_quant": device_loop_full_width(smi, numpy_gen_ms)}
    torch.cuda.empty_cache()
    phase_done("phase 8a")
    paths["device_loop_1000"] = {"split_quant": device_loop_1000(smi)}
    phase_done("phase 8b")
    print(f"launches on the main paths (B1: counted by its wrapper at each "
          f"launch; the device loop is eager, no graph): {paths}")
    launches = {n: sum(p.get(n, 0) for p in paths.values()) for n in WRAPPERS}

    # the kernels at the main paths' largest shapes (attention in bf16 at
    # SmolLM's heads, the quantizer's fused entry at ResNet-18's f32 l2
    # boundary as the ring hands it over, channel-major; the scans in
    # bf16 at S=512)
    pick = {"flash_attn_fwd": rows["flash_attn_fwd"][PREFILL_S.index(512)],
            "decode_attn": rows["decode_attn"][0],
            "split_quant": next(r for r in rows["split_quant"] if r["shape"]
                                == "quantize_dequantize (8, 28, 28, 128) "
                                   "float32 channel-major"),
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
