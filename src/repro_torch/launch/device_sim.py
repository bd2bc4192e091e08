"""Constellation-scale closed loop on the device: the port's counterpart
of ``examples/constellation_device_sim.py``.

Default: a 1000-satellite ring trains the split autoencoder (32 px,
batch 2) for 8 revolutions, 8000 passes of [problem-(13) allocation →
reserve-skip policy → masked SL steps on batches generated on the device
→ battery drain → solar recharge], with one host read of the telemetry
per revolution. The item budget makes a pass drain ~48 J against 200 J
batteries with slow recharge, so satellites cycle between training and
reserve skips across revolutions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.device_sim [--small] \\
      [--device cuda|cpu]

``--small`` runs 64 satellites for 4 revolutions. ``--planes P > 1`` (the
reference's sharded fleet) needs the fleet engine, the next slice of the
port, and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.sim.data import DeviceImageryShards
from repro_torch.sim.device_sim import (ACTION_SKIPPED,
                                        DeviceConstellationSim,
                                        DeviceSimConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="64 sats x 4 revolutions")
    ap.add_argument("--planes", type=int, default=1,
                    help="orbital planes; > 1 needs the fleet engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.planes > 1:
        raise NotImplementedError(
            "--planes > 1 runs the sharded fleet engine, the next slice of "
            "the port (ROADMAP queue A, the fleet slice)")

    n_sats, n_revolutions = (64, 4) if args.small else (1000, 8)
    shards = DeviceImageryShards(img=32, batch=2, device=args.device)
    adapter = autoencoder_adapter(cut=5, img=32)
    budget = PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=4e6)
    t0 = time.perf_counter()
    engine = DeviceConstellationSim(
        adapter, budget, shards, DeviceSimConfig(
            n_revolutions=n_revolutions,
            battery_j=200.0,          # per-sat battery [J]
            recharge_w=1e-4,          # slow solar recharge: skips emerge
            reserve_j=150.0,          # skip threshold
            max_steps_per_pass=2),    # simulated compute cap
        device=args.device)
    print(f"device: {engine.device}; single ring, {n_sats} sats x "
          f"{n_revolutions} revolutions ({n_sats * n_revolutions} passes)")
    plan = engine.plan.to_host()
    print(f"plan (solved on the device): {plan.n_steps[0]} SL steps/pass "
          f"({engine.scan_steps} executed, masked beyond), drain "
          f"{plan.drain_j[0]:.1f} J/pass, E_pass {plan.e_total_j[0]:.1f} J, "
          f"kept {plan.kept_fraction[0]:.3f}")

    print(f"\n{'rev':>4} {'trained':>8} {'skipped':>8} {'mean loss':>10} "
          f"{'battery J (min/med/max)':>24} {'s/rev':>6}")
    rows = []
    t_rev = time.perf_counter()
    for rev in range(n_revolutions):
        res = engine.run(1, stream_telemetry=True)   # ONE host sync per rev
        bat = res.energy.battery_j
        trained = res.action != ACTION_SKIPPED
        loss = float(np.nanmean(res.loss)) if trained.any() else float("nan")
        now = time.perf_counter()
        rows.append({"trained": int(trained.sum()),
                     "skipped": int((~trained).sum()), "loss": loss,
                     "s": now - t_rev})
        print(f"{rev:4d} {rows[-1]['trained']:8d} {rows[-1]['skipped']:8d} "
              f"{loss:10.4f} {bat.min():7.1f}/{np.median(bat):7.1f}/"
              f"{bat.max():7.1f} {now - t_rev:6.2f}")
        t_rev = now

    es = res.energy
    print(f"\nenergy after {n_revolutions} revolutions: fleet spent "
          f"{float(es.energy_spent_j.sum()):,.0f} J (eq. 11, incl. ground + "
          f"ISL); passes served {int(es.passes_served.sum())}, skipped "
          f"{int(es.passes_skipped.sum())} (reserve policy); batteries "
          f"{float(es.battery_j.min()):.1f}..{float(es.battery_j.max()):.1f}"
          f" J; {int(engine.state.step)} SL steps")
    print(f"host contact: {engine.traces} program build, "
          f"{engine.device_calls} dispatches, {engine.host_syncs} telemetry "
          f"syncs for {n_sats * n_revolutions} passes "
          f"({time.perf_counter() - t0:.1f} s in all)")
    return {"revolutions": rows, "traces": engine.traces,
            "device_calls": engine.device_calls,
            "host_syncs": engine.host_syncs}


if __name__ == "__main__":
    main()
