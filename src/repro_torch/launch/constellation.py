"""Constellation CLI: the paper's system, running — the port's
counterpart of ``examples/constellation_online_learning.py``.

A 25-satellite ring (Table I), each satellite with a non-IID local
imagery shard, trains a split model round-robin: the satellite runs
segment A, the ground terminal segment B, with the int8 boundary;
problem (13) allocates (f, p) per pass; the ISL handoff is an
integrity-checked checkpoint; random failures and battery limits
exercise the restore and skip policies.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.constellation \
      --model resnet18 --img 224 --passes 6 --device cuda
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.constellation import ConstellationConfig, ConstellationSim
from repro_torch.core.energy import PassBudget
from repro_torch.core.sl_step import autoencoder_adapter, resnet18_adapter
from repro_torch.core.splitting import RESNET18_PAPER_CUTS
from repro_torch.data.synthetic import ImageryShards


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("autoencoder", "resnet18"),
                    default="autoencoder")
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--passes", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    if args.model == "autoencoder":
        adapter = autoencoder_adapter(cut=5, img=args.img)
    else:
        adapter = resnet18_adapter(cut=RESNET18_PAPER_CUTS["l2"],
                                   img=args.img)
    shards = ImageryShards(img=args.img, batch=8, n_shards=27)
    with tempfile.TemporaryDirectory() as handoff_dir:
        sim = ConstellationSim(
            adapter, PassBudget(n_items=64), shards.batch_at,
            cfg=ConstellationConfig(
                n_passes=args.passes, optimizer="sgd",
                quantize_boundary=True, fail_prob=0.08, battery_j=2_000.0,
                recharge_w=5.0, reserve_j=100.0, handoff_dir=handoff_dir,
                join_events={12: 2}),
            device=args.device)
        records = sim.run()

    print(f"{'pass':>4} {'sat':>4} {'action':15s} {'loss':>8} "
          f"{'E_total[J]':>11} {'E_comm[J]':>10} {'D_ISL[Mb]':>10}")
    for r in records:
        loss = f"{r.loss:.4f}" if r.loss is not None else "-"
        print(f"{r.pass_idx:4d} {r.sat_id:4d} {r.action:15s} {loss:>8} "
              f"{r.e_total_j:11.4g} {r.e_comm_j:10.4g} "
              f"{r.d_isl_bits / 1e6:10.2f}")
    summary = sim.summary()
    print(f"\n{args.model} at {args.img} px on {sim.device}: {summary}")
    print(f"planner: {sim.planner.solve_calls} batched solve(s), "
          f"{sim.planner.invalidations} invalidation(s) "
          f"for {len(records)} passes")
    return summary


if __name__ == "__main__":
    main()
