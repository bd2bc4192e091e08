"""Batched serving demo (the port of ``examples/serve_batched.py``):
continuous-batching greedy decode over the KV cache of an arch's smoke
config with seeded random weights (full attention; ``--arch
mixtral_8x7b`` for the sliding-window ring, ``xlstm_1_3b`` for
recurrent-state decoding). On the card attention runs on kernels B2
(prefill) and B3 (decode); ``--device cpu`` takes their plain versions.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_batched --arch smollm_360m
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request


def serve(cfg, params, *, requests: int = 6, slots: int = 3,
          new_tokens: int = 10, prompt_len: int = 6, s_max: int = 96,
          act_dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """The example's requests (prompts of ``prompt_len`` tokens from
    ``np.random.default_rng(seed)``) through a :class:`DecodeEngine`.
    Returns {rid: generated tokens}."""
    engine = DecodeEngine(cfg, params, n_slots=slots, s_max=s_max,
                          act_dtype=act_dtype, device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt_len)
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(requests)]
    return engine.submit_and_run(reqs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    params = lm.init(cfg, torch.Generator(device=device).manual_seed(0))
    t0 = time.time()
    out = serve(cfg, params, requests=args.requests, slots=args.slots,
                new_tokens=args.new_tokens, device=device)
    dt = time.time() - t0
    for rid in sorted(out):
        print(f"req {rid}: {out[rid]}")
    tok = sum(map(len, out.values()))
    print(f"{len(out)} requests, {tok} tokens, {dt:.2f}s "
          f"({tok/dt:.1f} tok/s on {args.slots} slots, arch={cfg.name}, "
          f"{device})")
    return out


if __name__ == "__main__":
    main()
