"""Compressed, staleness-tolerant inter-plane exchange over a modeled ISL
(the port of ``examples/isl_exchange.py``).

A 2-plane fleet trains the split autoencoder twice over the same
revolutions, exchanging checkpoints over the inter-satellite link two
ways:

* **sync / full float**: the revolution-boundary barrier
  (``ExchangeConfig(mode="sync")``, codec ``none``), the free average's
  result, metered: every exchange pays its wire bits and drains
  ``isl_pw * bits / rate`` joules from the pushing satellite's battery;
* **async / top-k 1%**: contact-window gossip (``mode="async"``): every
  ``period`` passes each plane pushes its error-feedback-compressed
  checkpoint delta to the neighbour plane and merges what it received
  with the staleness-discounted weight ``mix / (1 + lam * staleness)``,
  with no barrier and far fewer wire bits; the compressed volume feeds
  problem (13)'s ``d_isl_bits``.

Each run replays bit for bit on the NumPy host-prefix oracle
(``repro_torch.isl.oracle_exchange``), which this script asserts; it
prints the two runs' wire bits and their ratio. Both planes run on one
card (the reference forces a 2-device mesh; that placement is not
ported). On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.isl_exchange
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.fleet import FleetConfig, FleetEngine
from repro_torch.isl import (CodecConfig, ContactConfig, ExchangeConfig,
                             exchange_events, oracle_exchange)
from repro_torch.obs.timeline import timeline_summary
from repro_torch.sim.data import DeviceImageryShards

COLUMNS = ("t", "slot", "bits", "e_isl_j", "staleness", "weight")


def final_loss(res):
    """Mean over satellites of each one's last finite loss."""
    return float(np.mean([row[np.isfinite(row)][-1] for row in res.loss
                          if np.isfinite(row).any()]))


def run(revolutions: int = 3, sats: int = 8, device="cuda", verbose=True):
    """Both runs, each asserted against its NumPy oracle. Returns {name:
    {"final_loss", "contacts", "wire_bits", "isl_j", "host_syncs"}}."""
    dev = resolve_device(device)
    shards = DeviceImageryShards(img=32, batch=4, device=dev)
    adapter = autoencoder_adapter(cut=5, img=32)
    budget = PassBudget(plane=OrbitalPlane(n_sats=sats), n_items=4e6)
    base = dict(n_planes=2, n_revolutions=revolutions, max_steps_per_pass=2,
                seed=0)
    runs = {
        "sync full-float barrier": FleetConfig(
            avg_every=1, exchange=ExchangeConfig(mode="sync"), **base),
        "async top-k 1% gossip": FleetConfig(
            avg_every=0, exchange=ExchangeConfig(
                mode="async", codec=CodecConfig("topk", topk_ratio=0.01),
                contact=ContactConfig(period=2), mix=0.5,
                staleness_lam=0.1), **base),
    }
    out = {}
    for name, cfg in runs.items():
        fleet = FleetEngine(adapter, budget, shards, cfg, device=dev)
        expect = oracle_exchange(fleet)          # host-prefix replay, first
        res = fleet.run()
        got = exchange_events(fleet.recorder)
        for col in COLUMNS:
            np.testing.assert_array_equal(got[col], expect[col], col)
        s = res.summary()
        out[name] = dict(final_loss=final_loss(res),
                         contacts=int(res.isl_contacts.sum()),
                         wire_bits=float(s["ISL_exchange_bits"]),
                         isl_j=float(s["ISL_exchange_J"]),
                         host_syncs=fleet.host_syncs)
        if not verbose:
            continue
        print(f"\n== {name} ==")
        print(f"  final loss        {out[name]['final_loss']:.5f}")
        print(f"  contacts          {out[name]['contacts']} "
              f"(oracle parity bit-exact)")
        print(f"  wire bits         {s['ISL_exchange_bits']:.3g}")
        print(f"  ISL energy        {s['ISL_exchange_J']:.3g} J "
              f"(drained from the serving batteries)")
        print(f"  planned d_isl     "
              f"{float(fleet.plan.d_isl_bits.float().mean()):.4g} "
              f"bits/pass (problem-(13) input)")
        print(f"  host syncs        {fleet.host_syncs} "
              f"(traces={fleet.traces})")
        print("  " + timeline_summary(fleet.recorder.events())
              .replace("\n", "\n  "))
    sync, gossip = out.values()
    if verbose and gossip["wire_bits"] > 0:
        print(f"\nwire bits, sync full float / async top-k 1%: "
              f"{sync['wire_bits'] / gossip['wire_bits']:.1f}x")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--revolutions", type=int, default=3)
    ap.add_argument("--sats", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    return run(args.revolutions, args.sats, args.device)


if __name__ == "__main__":
    main()
