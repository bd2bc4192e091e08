#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device report (name, power limit);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
  3. each kernel against its plain PyTorch version at SmolLM-360M's head
     geometry, with its time, bound, plain time and the library yardstick;
  4. full-width SmolLM-360M split-model serving (cut at unit 16) through
     both kernels: launch counts, split == unsplit greedy tokens, one
     decode step's logits on the kernel path against the plain path.
The last two lines are the kernels' JSON record and the result JSON.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, decode_attn, flash_attn, ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.serve.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serve_fleet.engine import SplitDecodeEngine  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}    # as the CPU tests
H, KV, D = 15, 5, 64                                 # SmolLM-360M heads
PREFILL_S = (1, 77, 512, 1000)
DECODE_B, DECODE_S = 8, 2048
DECODE_LENS = [1, 2048, 100, 513, 1024, 37, 2000, 777]
# One decode step's logits, kernel path vs plain path, both in bf16
# activations: the attention outputs round to bf16 at different sums, and
# the 1-ulp differences travel through 32 layers. Held to 3% of the
# largest logit (PERF.md, "Findings").
LOGITS_TOL_OF_MAX = 0.03


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


def check_prefill(dtype, S, gen, flush):
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
        shape=f"prefill B=1 S={S} {str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: flash_attn.flash_attention_fwd(q, k, v),
                   flush=flush),
        plain_ms=time_ms(lambda: flash_attn.flash_attention_plain(q, k, v),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def check_decode(dtype, gen, flush):
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
        shape=f"decode B={DECODE_B} s_max={DECODE_S} lengths={DECODE_LENS} "
              f"{str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: decode_attn.decode_attention(q, k, v, lengths),
                   flush=flush),
        plain_ms=time_ms(lambda: decode_attn.decode_attention_plain(
            q, k, v, lengths), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask), flush=flush),
        bound_ms=b_ms, bound_by=b_by)


def serve_full_width(label):
    cfg = configs.get("smollm_360m")
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == (32, 960, 49152),
          "full-width SmolLM-360M config")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    kw = dict(n_slots=8, s_max=2048, act_dtype=torch.bfloat16, device="cuda")
    split = SplitDecodeEngine(cfg, params, cut_units=16, **kw)
    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, 16)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in plens]
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]

    # warm-up on a throwaway engine (cuBLAS handles, allocator)
    SplitDecodeEngine(cfg, params, cut_units=16, **kw).submit_and_run(
        reqs()[:2])

    prefill_ms, step_ms = [], []

    def timed(fn, out):
        def wrapper(*a):
            t0 = time.perf_counter()
            r = fn(*a)                      # returns host values: synced
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return wrapper

    split._prefill = timed(split._prefill, prefill_ms)
    split._step = timed(split._step, step_ms)
    flash_attn.flash_attention_fwd.launches = 0
    decode_attn.decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = split.submit_and_run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attn.flash_attention_fwd.launches,
                "decode_attn": decode_attn.decode_attention.launches}
    check(all(n > 0 for n in launches.values()), launches)

    check(sorted(out) == list(range(16)), "every request served")
    check(all(len(t) == 32 and all(0 <= x < cfg.vocab for x in t)
              for t in out.values()), "32 in-vocabulary tokens per request")
    unsplit = DecodeEngine(cfg, params, **kw).submit_and_run(reqs())
    check(unsplit == out, "split and unsplit greedy tokens differ")

    # one decode step's f32 logits: kernel path vs plain path, same state
    tokens = torch.tensor(split.last_tok[:, None], device="cuda")
    positions = torch.tensor(np.minimum(plens[:8] + 3, 2047), device="cuda")
    ctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.bfloat16)
    cache0 = {k: {s: {n: t.clone() for n, t in kv.items()}
                  for s, kv in blk.items()} for k, blk in split.cache.items()}
    with torch.no_grad():
        lk, _, _ = lm.decode_step_split(cfg, split.params_sat,
                                        split.params_gnd, split.cache,
                                        tokens, positions, ctx=ctx)
        kernel_decode = ops.decode_attention
        ops.decode_attention = decode_attn.decode_attention_plain
        try:
            lp, _, _ = lm.decode_step_split(cfg, split.params_sat,
                                            split.params_gnd, cache0,
                                            tokens, positions, ctx=ctx)
        finally:
            ops.decode_attention = kernel_decode
    check(lk.dtype == torch.float32 and bool(torch.isfinite(lk).all()),
          "finite f32 logits")
    logit_err = (lk - lp).abs().max().item()
    logit_max = lp.abs().max().item()
    check(logit_err <= LOGITS_TOL_OF_MAX * logit_max, (logit_err, logit_max))
    same_argmax = int((lk.argmax(-1) == lp.argmax(-1)).sum())

    n_tok = sum(len(t) for t in out.values())
    print(f"serve smollm_360m split@16, 8 slots, s_max 2048, 16 requests "
          f"(prompts {plens.min()}-{plens.max()}), 32 new tokens each [{label}]")
    print(f"  {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s "
          f"[{label}]")
    print(f"  prefill median {statistics.median(prefill_ms):.2f} ms over "
          f"{len(prefill_ms)} prompts [{label}]")
    print(f"  decode step median {statistics.median(step_ms):.2f} ms over "
          f"{len(step_ms)} steps [{label}]")
    print(f"  launches on this run: {launches}; split tokens == unsplit; "
          f"logits kernel vs plain max abs err {logit_err:.3e} of max "
          f"|logit| {logit_max:.3e} (tol {LOGITS_TOL_OF_MAX:.0%}), argmax "
          f"equal in {same_argmax}/8 rows")
    profile_decode(split, label)
    return launches


def profile_decode(engine, label, steps=5):
    """Kernel time by name over a few decode steps of the served engine
    (torch.profiler), against the same steps' host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    toks = engine.last_tok.reshape(-1, 1).astype(np.int32)
    pos = np.minimum(engine.positions, engine.s_max - 2)
    engine._step(toks, pos)
    t0 = time.perf_counter()
    for _ in range(steps):
        engine._step(toks, pos)
    step = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine._step(toks, pos)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    busy = sum(dev_us(e) for e in kern) / steps / 1e3
    if busy == 0:
        print(f"profile: decode step {step:.2f} ms; device time not measured "
              "(the profiler saw no kernels)")
        return
    print(f"profile of {steps} decode steps [{label}]: step {step:.2f} ms "
          f"(host clock, unprofiled), kernels {busy:.3f} ms/step, device "
          f"idle {1 - busy / step:.1%}")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / steps / 1e3:8.4f} ms/step  "
              f"{e.count // steps:4d}x  {e.key[:90]}")


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
    rows = {"flash_attn_fwd": [], "decode_attn": []}
    for dtype in (torch.bfloat16, torch.float32):
        for S in PREFILL_S:
            rows["flash_attn_fwd"].append(check_prefill(dtype, S, gen, flush))
        rows["decode_attn"].append(check_decode(dtype, gen, flush))
    print(f"kernels vs plain on {smi} (ms, median of 20, L2 flushed):")
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} plain "
                  f"{r['plain_ms']:.4f} sdpa {r['library_ms']:.4f} bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err "
                  f"{r['max_abs_err']:.3e}")
    del flush

    launches = serve_full_width(smi)

    # the kernels at the main path's largest shapes, bf16
    pick = {"flash_attn_fwd": rows["flash_attn_fwd"][2],      # S=512
            "decode_attn": rows["decode_attn"][0]}
    meta = {"flash_attn_fwd": ("src/repro_torch/csrc/flash_attn_fwd.cu",
                               "src/repro/kernels/flash_attn.py:126"),
            "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                            "src/repro/kernels/decode_attn.py:88")}
    kernels = [dict(name=n, route="cuda", source=meta[n][0],
                    replaces=meta[n][1], launches=launches[n],
                    max_abs_err=max(r["max_abs_err"] for r in rows[n]
                                    if "bfloat16" in r["shape"]),
                    ms=pick[n]["ms"], plain_ms=pick[n]["plain_ms"],
                    bound_ms=pick[n]["bound_ms"], bound_by=pick[n]["bound_by"],
                    library_ms=pick[n]["library_ms"])
               for n in ("flash_attn_fwd", "decode_attn")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
