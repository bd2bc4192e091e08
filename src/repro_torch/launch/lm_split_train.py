"""LM track: split-learning SmolLM-360M between the "satellite" (embedding
+ lower units) and the "ground" (upper units + head) — the port of
``examples/lm_split_train.py``.

Prints the pass allocation of the cut (``lm_plan`` through problem (13),
``core.resource_opt.solve``), then trains one memorised batch with the
SL step, whose loss must fall. The smoke config by default; ``--full``
takes the published 360M shapes. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.lm_split_train --steps 10
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.energy import PassBudget
from repro_torch.core.resource_opt import solve
from repro_torch.core.sl_step import lm_adapter, make_sl_step
from repro_torch.core.train_state import SLTrainState
from repro_torch.data.synthetic import TokenShards
from repro_torch.train.optimizer import resolve_optimizer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cut-units", type=int, default=1)
    ap.add_argument("--optimizer", choices=("sgd", "adamw"), default="sgd",
                    help="pluggable optimizer; adamw uses the LM lr schedule")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the real smollm-360m config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get("smollm_360m") if args.full \
        else configs.get_smoke("smollm_360m")
    print(f"arch {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"({cfg.param_count()/1e6:.1f}M params)")

    adapter = lm_adapter(cfg, cut_units=args.cut_units, seq_len=args.seq)
    costs = adapter.plan.costs_at(adapter.cut_index)
    rep = solve(PassBudget(n_items=args.batch * args.steps), costs)
    print(f"pass allocation: E={rep.allocation.e_total:.4g} J "
          f"feasible={rep.allocation.feasible} "
          f"(W1={costs.w1_flops:.3g} W2={costs.w2_flops:.3g} FLOPs/seq, "
          f"D_tx={costs.dtx_bits/1e6:.2f} Mb/seq)")

    pa, pb = adapter.init(torch.Generator(device=device).manual_seed(args.seed))
    step = make_sl_step(adapter)
    shards = TokenShards(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    opt = resolve_optimizer(args.optimizer, lr=args.lr)
    state = SLTrainState.create(pa, pb, opt)
    batch0 = {k: torch.as_tensor(v, device=device)
              for k, v in shards.batch_at(0, 0).items()}
    losses = []
    for i in range(args.steps):
        # memorise one batch: the loss must fall
        res = step(state.params_a, state.params_b, batch0)
        state = state.apply_updates(res.grads_a, res.grads_b, opt)
        losses.append(float(res.loss))
        print(f"  step {i}: loss {losses[-1]:.4f} "
              f"boundary {res.dtx_bits_down/8/1024:.0f} KiB/way")
    print(f"done ({opt.name}: loss should be decreasing).")
    return losses


if __name__ == "__main__":
    main()
