"""Serving CLI: batched greedy decoding with the continuous-batching
engine over an arch's smoke config, seeded random weights.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \
      --requests 6 --new-tokens 12 --cut 1 --device cuda
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", choices=("bulk", "loop"), default="bulk",
                    help="prompt ingestion: one prefill forward + cache "
                    "splice (bulk) or the token-by-token loop")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the reference's TPU-kernel switch: accepted and "
                    "ignored (the card always takes the Hopper kernels)")
    ap.add_argument("--cut", type=int, default=None,
                    help="serve the SPLIT model cut at this unit boundary "
                    "(satellite half + boundary downlink + ground half), in "
                    "[1, units - 1]: the smoke configs have two units, "
                    "xlstm_1_3b's one, so it takes no cut")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(cfg, gen)
    kw = dict(n_slots=args.slots, s_max=args.s_max, prefill=args.prefill,
              device=device)
    if args.cut is None:
        engine = DecodeEngine(cfg, params, **kw)
    else:
        from repro_torch.serve_fleet.engine import SplitDecodeEngine
        engine = SplitDecodeEngine(cfg, params, cut_units=args.cut, **kw)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    out = engine.submit_and_run(reqs)
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    for rid in sorted(out):
        print(f"req {rid}: {out[rid]}")
    mode = f"{args.prefill} prefill on {device}"
    if args.cut is not None:
        mode += f", split at unit {args.cut}"
    print(f"served {len(out)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, {args.slots} slots, {mode})")
    return out


if __name__ == "__main__":
    main()
