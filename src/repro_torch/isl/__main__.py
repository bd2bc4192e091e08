"""``python -m repro_torch.isl [--device cuda|cpu]``: the ISL exchange
smoke, on a small 2-plane fleet (the reference smoke's checks):

1. codec bits are monotone (none > int8 > top-k 10% > top-k 1%);
2. a ``mode="sync"``, ``scheme="none"`` exchange gives the free average's
   actions and final checkpoints bit for bit, while metering its wire
   bits, and its exchange rows equal the NumPy oracle's;
3. an async top-k gossip exchange equals its NumPy oracles bit for bit:
   every action and every contact's ``{t, slot, bits, e_isl_j,
   staleness, weight}`` row; losses stay finite, the meter moved, and
   each revolution takes one host sync.

It runs on the card unless ``--device cpu`` is given. Environment knobs,
as the reference's: ``REPRO_ISL_SMOKE_SATS`` (default 4),
``REPRO_ISL_SMOKE_PLANES`` (2), ``REPRO_ISL_SMOKE_REVS`` (2).
"""
import argparse
import os
import time

import numpy as np
import torch

EXCHANGE_COLUMNS = ("t", "slot", "bits", "e_isl_j", "staleness", "weight")


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _same_rows(got, expect, what):
    _check(got["t"].size == expect["t"].size > 0,
           f"{what}: {got['t'].size} exchanges, oracle {expect['t'].size}")
    for col in EXCHANGE_COLUMNS:
        _check(np.array_equal(got[col], expect[col]),
               f"{what}: column {col} {got[col]} != oracle {expect[col]}")


def _smoke(n_sats: int = 4, n_planes: int = 2, n_revolutions: int = 2,
           device="cuda"):
    from repro_torch.core.energy import PassBudget
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.core.train_state import _leaves
    from repro_torch.fleet import FleetConfig, FleetEngine, oracle_actions
    from repro_torch.isl import (CodecConfig, ContactConfig, ExchangeConfig,
                                 codec_label, delta_payload_bits,
                                 exchange_events, oracle_exchange)
    from repro_torch.obs.timeline import timeline_summary
    from repro_torch.sim.data import DeviceImageryShards

    shards = DeviceImageryShards(img=32, batch=4, device=device)
    adapter = autoencoder_adapter(cut=5, img=32)
    budget = PassBudget(plane=OrbitalPlane(n_sats=n_sats), n_items=4e6)
    base = dict(n_planes=n_planes, n_revolutions=n_revolutions,
                max_steps_per_pass=2, seed=0)
    t0 = time.perf_counter()

    # 1 ---- codec bits are monotone -------------------------------------
    pa, pb = adapter.init(torch.Generator().manual_seed(0))
    codecs = [CodecConfig("none"), CodecConfig("int8"),
              CodecConfig("topk", topk_ratio=0.10),
              CodecConfig("topk", topk_ratio=0.01)]
    bits = [delta_payload_bits((pa, pb), c) for c in codecs]
    labels = [codec_label(c) for c in codecs]
    _check(bits == sorted(bits, reverse=True) and bits[-1] > 0,
           f"payload bits not monotone: {dict(zip(labels, bits))}")
    print("isl: payload bits " +
          " > ".join(f"{lb}={b:.3g}" for lb, b in zip(labels, bits)))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # 2 ---- sync scheme="none" == the free average ------------------
        legacy = FleetEngine(adapter, budget, shards,
                             FleetConfig(avg_every=1, **base), device=device)
        res_l = legacy.run()
        syncf = FleetEngine(adapter, budget, shards, FleetConfig(
            avg_every=1, exchange=ExchangeConfig(mode="sync"), **base),
            device=device)
        expect_sync = oracle_exchange(syncf)
        res_s = syncf.run()

        # 3 ---- async compressed gossip against the oracles -------------
        af = FleetEngine(adapter, budget, shards, FleetConfig(
            avg_every=0, exchange=ExchangeConfig(
                mode="async", codec=CodecConfig("topk", topk_ratio=0.01),
                contact=ContactConfig(period=2, offsets=(1,)),
                mix=0.5, staleness_lam=0.1), **base), device=device)
        expect_act = oracle_actions(af)
        expect_ex = oracle_exchange(af)
        res_a = af.run(stream_telemetry=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    _check(np.array_equal(res_l.action, res_s.action),
           "sync/none actions differ from the free average's")
    for s_l, s_s in zip(res_l.state, res_s.state):
        for a, b in zip(_leaves((s_l.params_a, s_l.params_b)),
                        _leaves((s_s.params_a, s_s.params_b))):
            _check(torch.equal(a, b), "sync/none checkpoints differ from "
                   "the free average's")
    _same_rows(exchange_events(syncf.recorder), expect_sync, "sync")
    s = res_s.summary()
    _check(s["ISL_exchange_bits"] > 0 and s["ISL_exchange_J"] > 0, str(s))
    _check(res_l.summary()["ISL_exchange_bits"] == 0.0,
           "the free average metered bits")
    _check(syncf.traces == 1 and syncf.host_syncs == 1,
           "more than one host sync for the run")
    print(f"isl: sync/none == the free average (checkpoints bit for bit), "
          f"metered {s['ISL_exchange_bits']:.3g} bits / "
          f"{s['ISL_exchange_J']:.2e} J")

    _check(np.array_equal(res_a.action, expect_act),
           f"async actions {res_a.action.tolist()} != oracle "
           f"{expect_act.tolist()}")
    _same_rows(exchange_events(af.recorder), expect_ex, "async")
    finite = res_a.loss[np.isfinite(res_a.loss)]
    _check(finite.size > 0, "no pass trained under gossip")
    _check(res_a.isl_bits.sum() > 0 and res_a.isl_e_j.sum() > 0,
           "the gossip meter did not move")
    _check(int(res_a.isl_contacts.sum()) == expect_ex["t"].size * n_planes,
           "contacts differ from the oracle's")
    _check(af.traces == 1 and af.host_syncs == n_revolutions,
           "more than one host sync per revolution")
    print(f"isl: async top-k 1% gossip: {expect_ex['t'].size} contacts, "
          f"action and exchange oracle parity bit for bit, "
          f"{float(res_a.isl_bits.sum()):.3g} bits / "
          f"{float(res_a.isl_e_j.sum()):.2e} J over ISL")
    print("  " + timeline_summary(af.recorder.events())
          .replace("\n", "\n  "))
    print(f"isl: smoke OK ({time.perf_counter() - t0:.1f} s on "
          f"{af.device})")
    return {"sync": s, "async": res_a.summary(),
            "contacts": int(expect_ex["t"].size)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.isl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    return _smoke(
        n_sats=int(os.environ.get("REPRO_ISL_SMOKE_SATS", "4")),
        n_planes=int(os.environ.get("REPRO_ISL_SMOKE_PLANES", "2")),
        n_revolutions=int(os.environ.get("REPRO_ISL_SMOKE_REVS", "2")),
        device=args.device)


if __name__ == "__main__":
    main()
