"""Quickstart: the paper in a few steps (the port of
``examples/quickstart.py``).

1. The Table-I constellation's geometry (eqs. 1-5).
2. The autoencoder split at its latent (cut 5) and problem (13) solved
   for one pass, against downloading the raw images directly.
3. Three SL train steps with the int8 boundary (kernel B1 on the card),
   satellite encoder and ground decoder, SGD.

On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.energy import PassBudget, direct_download_costs
from repro_torch.core.orbits import PAPER_PLANE
from repro_torch.core.resource_opt import solve
from repro_torch.core.sl_step import autoencoder_adapter, make_sl_step
from repro_torch.core.train_state import SLTrainState
from repro_torch.data.synthetic import ImageryShards
from repro_torch.train.optimizer import sgd


def plan(img: int = 64, n_items: int = 64):
    """Problem (13) on the autoencoder split at img px: (the split's
    allocation report, the direct download's, the saving in %)."""
    costs = autoencoder_adapter(cut=5, img=img).costs()
    budget = PassBudget(n_items=n_items)
    rep = solve(budget, costs)
    rep_dd = solve(budget, direct_download_costs(
        img * img * 3 * 32, costs.w1_flops + costs.w2_flops))
    saving = 100 * (1 - rep.allocation.e_total / rep_dd.allocation.e_total)
    return rep, rep_dd, saving


def sl_steps(img: int = 64, steps: int = 3, batch: int = 8, device="cuda",
             init=None, seed: int = 0):
    """``steps`` SL steps (int8 boundary, SGD lr 1e-2) on satellite 0's
    shard; ``init`` = (params_a, params_b) or seeded weights. Returns the
    [(loss, boundary bits each way)] of each step."""
    dev = resolve_device(device)
    adapter = autoencoder_adapter(cut=5, img=img)
    pa, pb = init if init is not None else adapter.init(
        torch.Generator(device=dev).manual_seed(seed))
    step = make_sl_step(adapter, quantize_boundary=True)
    shards = ImageryShards(img=img, batch=batch)
    opt = sgd(lr=1e-2)
    state = SLTrainState.create(pa, pb, opt)
    out = []
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in shards.batch_at(0, i).items()}
        res = step(state.params_a, state.params_b, b)
        state = state.apply_updates(res.grads_a, res.grads_b, opt)
        out.append((float(res.loss), float(res.dtx_bits_down)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== constellation ==")
    for k, v in PAPER_PLANE.summary().items():
        print(f"  {k:24s} {v:.3f}" if isinstance(v, float) else f"  {k}: {v}")

    rep, rep_dd, saving = plan(args.img)
    print("\n== problem (13), autoencoder split ==")
    for k, v in rep.allocation.summary().items():
        print(f"  {k:12s} {v}")
    print(f"  vs direct download: {rep_dd.allocation.e_total:.4g} J "
          f"({saving:.1f}% savings)")

    print("\n== split-learning steps (satellite encoder / ground decoder) ==")
    steps = sl_steps(args.img, args.steps, args.batch, device)
    for i, (loss, bits) in enumerate(steps):
        print(f"  step {i}: loss {loss:.4f}, boundary "
              f"{bits / 8 / 1024:.1f} KiB (int8) each way")
    print("done.")
    return {"plane": PAPER_PLANE.summary(),
            "allocation": rep.allocation.summary(), "saving_pct": saving,
            "steps": steps}


if __name__ == "__main__":
    main()
