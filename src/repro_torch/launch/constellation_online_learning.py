"""End to end: the paper's system, running (the port of
``examples/constellation_online_learning.py``).

A 25-satellite ring (Table I), each satellite with a non-IID imagery
shard, trains the split autoencoder round-robin: the satellite runs the
encoder, the ground terminal the decoder; problem (13) allocates (f, p)
per pass; the ISL handoff is an integrity-checked checkpoint; random
failures, a battery reserve and two satellites joining at pass 12
exercise the skip and restore policies. Prints a table of passes, the
summary and the planner's counts. The int8 boundary runs on kernel B1
on the card. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.constellation_online_learning
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.constellation import ConstellationConfig, ConstellationSim
from repro_torch.core.energy import PassBudget
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.core.train_state import SLTrainState
from repro_torch.data.synthetic import ImageryShards


def run(n_passes: int = 25, img: int = 64, batch: int = 8,
        n_items: int = 64, device="cuda", init=None, handoff_dir=None):
    """The example's ring for ``n_passes`` passes (failures at 0.08, a
    2 kJ battery recharged at 5 W above a 100 J reserve, 2 satellites
    joining at pass 12); ``init`` = (params_a, params_b) or seeded
    weights. Returns the simulator after its run (records in
    ``sim.records``)."""
    shards = ImageryShards(img=img, batch=batch, n_shards=25)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ConstellationConfig(
            n_passes=n_passes, batch_size=batch, optimizer="sgd",
            quantize_boundary=True, fail_prob=0.08, battery_j=2_000.0,
            recharge_w=5.0, reserve_j=100.0, join_events={12: 2},
            handoff_dir=handoff_dir or tmp)
        sim = ConstellationSim(
            autoencoder_adapter(cut=5, img=img), PassBudget(n_items=n_items),
            shards.batch_at, cfg, device=device)
        if init is not None:
            sim.state = SLTrainState.create(*init, sim.optimizer)
        sim.run()
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=25,
                    help="passes (25 = one revolution of the ring)")
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--items", type=int, default=64,
                    help="items a pass (SL steps = items / batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    sim = run(args.passes, args.img, args.batch, args.items, args.device)
    print(f"{'pass':>4} {'sat':>4} {'action':15s} {'loss':>8} "
          f"{'E_total[J]':>11} {'E_comm[J]':>10} {'D_ISL[Mb]':>10}")
    for r in sim.records:
        loss = f"{r.loss:.4f}" if r.loss is not None else "-"
        print(f"{r.pass_idx:4d} {r.sat_id:4d} {r.action:15s} {loss:>8} "
              f"{r.e_total_j:11.4g} {r.e_comm_j:10.4g} "
              f"{r.d_isl_bits / 1e6:10.2f}")
    print("\nsummary:", sim.summary())
    print(f"planner: {sim.planner.solve_calls} batched solve(s), "
          f"{sim.planner.invalidations} invalidation(s) "
          f"for {len(sim.records)} passes")
    return sim


if __name__ == "__main__":
    main()
