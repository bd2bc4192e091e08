"""End-to-end LM training entry point (the port of ``repro/launch/train.py``).

Trains an arch (full or smoke config) with the train step of
:mod:`repro_torch.train.step`: synthetic token shards through
``prefetch``, checkpoint/restart through :mod:`repro_torch.ckpt`,
optional gradient compression. A vision config's step gets a zero
``frontend_embed`` and an audio config's (Whisper) zero ``enc_frames``,
(batch, frontend_len, d_model) bf16, as the reference's does. On the
card unless ``--device cpu``.
``--model-parallel`` other than 1 is refused: the reference's model
sharding is not ported (one card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import ckpt as ckptlib
from repro_torch import configs, resolve_device
from repro_torch.data.synthetic import TokenShards, prefetch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig, TrainState, make_train_step


def _ckpt_tree(state: TrainState):
    """The state as a checkpoint tree (no None leaf)."""
    tree = {"params": state.params, "opt": tuple(state.opt)}
    if state.ef is not None:
        tree["ef"] = state.ef
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError("--model-parallel: model sharding is not ported "
                         "(one card)")

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 1)),
        remat=args.remat, compression=args.compression)

    step, _, _, init_state = make_train_step(cfg, tcfg=tcfg, device=device)
    state = init_state(args.seed)

    start = 0
    if args.ckpt_dir:
        last = ckptlib.latest_step(args.ckpt_dir)
        if last is not None:
            tree, meta = ckptlib.restore(args.ckpt_dir, last,
                                         _ckpt_tree(state))
            state = TrainState(tree["params"], type(state.opt)(*tree["opt"]),
                               tree.get("ef"))
            start = int(meta.get("step", last))
            print(f"restored checkpoint step {last} (resuming at {start})")

    shards = TokenShards(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                         seed=args.seed)
    it = prefetch(shards.iterate(shard=0, start=start), device=device)

    # the front ends' stubs, as the reference hands its step: a zero
    # vision prefix, or zero encoder frames (Whisper)
    stub = {"vision": "frontend_embed", "audio": "enc_frames"}.get(
        cfg.frontend)
    extra = {} if stub is None else {stub: torch.zeros(
        (args.batch, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16,
        device=device)}

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step(state, {**next(it), **extra})
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {i+1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({dt/args.log_every:.2f}s/step)")
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckptlib.save(args.ckpt_dir, i + 1, _ckpt_tree(state),
                         meta={"step": i + 1, "arch": cfg.name})

    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        print("no steps to run (checkpoint already at target step)")
    return losses


if __name__ == "__main__":
    main()
