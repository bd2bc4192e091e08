"""End-to-end LM training entry point (the port of ``repro/launch/train.py``).

Trains an arch (full or smoke config) with the train step of
:mod:`repro_torch.train.step`: synthetic token shards through
``prefetch``, checkpoint/restart through :mod:`repro_torch.ckpt`,
optional gradient compression. A vision config's step gets a zero
``frontend_embed`` and an audio config's (Whisper) zero ``enc_frames``,
(batch, frontend_len, d_model) bf16, as the reference's does. On the
card unless ``--device cpu``.

As the reference's, the step runs on :func:`repro_torch.launch.mesh.
make_host_mesh` (``--model-parallel m``): a ``(world // m, m)`` mesh of
the ranks ``torchrun`` starts (one card each, NCCL; gloo ranks under
``--device cpu``), or of one rank under a plain ``python -m``. Every rank
draws the same global batch and takes its rows. Only rank 0 prints and
saves. A checkpoint holds the whole state, gathered from the ranks, in
the one-process format, so it resumes on any mesh shape.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
      --device cpu --model-parallel 2
"""
from __future__ import annotations

import argparse
import time

import torch

import torch.distributed as dist

from repro_torch import ckpt as ckptlib
from repro_torch import configs
from repro_torch.data.synthetic import TokenShards, prefetch
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models import lm
from repro_torch.models import parallel as par
from repro_torch.models.param import ShardingRules, map_tree
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.step import TrainConfig, TrainState, make_train_step
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten


def _whole_like(cfg, state: TrainState):
    """Empty host tensors shaped like the whole checkpoint tree."""
    abstract = lm.abstract_params(cfg)
    f32 = lambda: map_tree(lambda s: torch.empty(s.shape), abstract)
    tree = {"params": map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype),
                               abstract),
            "opt": (torch.empty((), dtype=state.opt.step.dtype), f32(),
                    f32())}
    if state.ef is not None:
        tree["ef"] = f32()
    return tree


def gather_state(state: TrainState, place, mesh):
    """The whole state on every rank, as one process holds it (the
    checkpoint tree; mu and nu gathered over ``data`` too)."""
    def whole(tree, zero):
        return tree_unflatten(tree, [
            par.gather_full(t, leaf, mesh, zero)
            for t, leaf in zip(tree_leaves(tree), tree_leaves(place))])
    tree = {"params": whole(state.params, False),
            "opt": (state.opt.step, whole(state.opt.mu, True),
                    whole(state.opt.nu, True))}
    if state.ef is not None:
        tree["ef"] = whole(state.ef, False)
    return tree


def shard_state(whole, place, mesh, device) -> TrainState:
    """This rank's pieces of a whole checkpoint tree, on ``device``."""
    def cut(tree, zero):
        return map_tree(lambda t: t.to(device),
                        par.shard_tree(tree, place, mesh, zero))
    step, mu, nu = whole["opt"]
    return TrainState(cut(whole["params"], False),
                      AdamWState(step.to(device), cut(mu, True),
                                 cut(nu, True)),
                      cut(whole["ef"], False) if "ef" in whole else None)


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
                    help="cuda (hand-written kernels, one card a rank) or "
                    "cpu (their plain PyTorch versions, gloo ranks)")
    args = ap.parse_args(argv)
    with process_group(args.device) as device:
        return _train(args, device)


def _train(args, device):
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    mesh = make_host_mesh(args.model_parallel, device)
    rules = ShardingRules()
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 1)),
        remat=args.remat, compression=args.compression)
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    step, _, _, init_state = make_train_step(cfg, mesh, rules, tcfg,
                                             device=device)
    state = init_state(args.seed)
    place = par.placement(lm.abstract_params(cfg), rules, mesh)

    start = 0
    if args.ckpt_dir:
        last = ckptlib.latest_step(args.ckpt_dir)
        if last is not None:
            tree, meta = ckptlib.restore(args.ckpt_dir, last,
                                         _whole_like(cfg, state))
            state = shard_state(tree, place, mesh, device)
            start = int(meta.get("step", last))
            say(f"restored checkpoint step {last} (resuming at {start})")

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
            say(f"step {i+1:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({dt/args.log_every:.2f}s/step)")
            t0 = time.time()
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            whole = gather_state(state, place, mesh)
            if lead:
                ckptlib.save(args.ckpt_dir, i + 1, whole,
                             meta={"step": i + 1, "arch": cfg.name})
            del whole

    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        say("no steps to run (checkpoint already at target step)")
    return losses


if __name__ == "__main__":
    main()
