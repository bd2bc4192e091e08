"""Serve-fleet smoke: ``python -m repro_torch.serve_fleet [--device cpu]``
(the reference's ``python -m repro.serve_fleet``), on Granite-3.0-2B's
smoke config with seeded random weights:

1. split-vs-full decode parity: the split engine (satellite half +
   boundary downlink + ground half) generates the exact greedy tokens of
   the unsplit engine;
2. about 300 synthetic requests, Poisson-drawn per pass window (25,000
   users/day, 90 s windows at the diurnal peak: 39 a window on average;
   prompts of 5 tokens, 4 new tokens each) and
   routed FIFO to the satellite overhead, served to completion by the
   split engine, which measures one satellite's tokens/s;
3. the serving fleet (2 planes x 8 sats, 24 windows) under eclipses and
   a concurrent training load, priced at that rate, held to the NumPy
   host oracle (:func:`~repro_torch.serve_fleet.engine.assert_host_parity`)
   with one host sync.

It runs on the card unless ``--device cpu`` is given. Returns the fleet's
summary.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.fleet.scenarios import EclipseConfig
from repro_torch.models import lm
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve_fleet.engine import (
    FleetServeEngine, ServeFleetConfig, SplitDecodeEngine, TrainLoad, _sync,
    assert_host_parity, serve_cost)
from repro_torch.serve_fleet.traffic import PassWindowTraffic, TrafficConfig


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def serve_windows(engine, windows: PassWindowTraffic, arrivals, vocab: int,
                  plane: int = 0):
    """Serve each window's arrivals (their prompts from
    ``windows.prompts``) to completion on ``engine``, window by window,
    request ids counting up from 0; returns ({rid: generated tokens},
    seconds), the clock stopped after a device sync."""
    out = {}
    _sync(engine.device)
    t0 = time.perf_counter()
    for k, n in enumerate(arrivals):
        batch = windows.prompts(plane, k, int(n), vocab)
        out.update(engine.submit_and_run(
            [Request(rid=len(out) + i, prompt=batch[i],
                     max_new_tokens=windows.cfg.decode_len)
             for i in range(int(n))]))
    _sync(engine.device)
    return out, time.perf_counter() - t0


#: the reference smoke's pass-window traffic (step 2) and the fleet's
#: concurrent training load (step 3)
SMOKE_TRAFFIC = TrafficConfig(users_per_day=25_000.0, prompt_len=5,
                              decode_len=4, peak_utc_s=0.0, seed=1)
SMOKE_TRAIN = TrainLoad(drain_j=8.0, e_total_j=12.0)


def smoke_fleet(cost, device) -> FleetServeEngine:
    """The reference smoke's fleet: 2 planes x 8 sats, 24 windows of 90 s,
    eclipses (period 6, duty 0.5) and a concurrent training load, at
    ``cost``."""
    scfg = ServeFleetConfig(
        n_planes=2, n_sats=8, n_windows=24, battery_j=60.0,
        recharge_w=0.02, reserve_serve_j=5.0, reserve_train_j=30.0,
        eclipse=EclipseConfig(period=6, duty=0.5), window_s=90.0)
    return FleetServeEngine(scfg, TrafficConfig(
        users_per_day=60_000.0, decode_len=4, seed=2), cost,
        train=SMOKE_TRAIN, device=device)


def _smoke(device="cuda"):
    device = resolve_device(device)
    t0 = time.perf_counter()
    cfg = configs.get_smoke("granite_3_2b")
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    cut = max(1, cfg.n_units // 2)
    kw = dict(act_dtype=torch.float32, device=device)

    # -- 1. split decode == full decode (greedy token parity) -------------
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 5).astype(np.int32)
               for _ in range(4)]
    full = DecodeEngine(cfg, params, n_slots=2, s_max=48, **kw)
    split = SplitDecodeEngine(cfg, params, cut_units=cut, n_slots=2,
                              s_max=48, **kw)
    reqs = lambda: [Request(rid=i, prompt=p, max_new_tokens=5)  # noqa: E731
                    for i, p in enumerate(prompts)]
    _check(full.submit_and_run(reqs()) == split.submit_and_run(reqs()),
           "split and full greedy tokens differ")
    print(f"[smoke] split-vs-full greedy parity OK (cut={cut})")

    # -- 2. a few hundred requests through pass-window routing ------------
    windows = PassWindowTraffic(SMOKE_TRAFFIC, window_s=90.0, n_planes=1)
    eng = SplitDecodeEngine(cfg, params, cut_units=cut, n_slots=8,
                            s_max=32, **kw)
    arrivals = windows.realize(8)[0]            # ~300 requests over 8 windows
    total_req = int(arrivals.sum())
    _check(total_req >= 150, f"traffic too thin for the smoke: {total_req}")
    out, dt = serve_windows(eng, windows, arrivals, cfg.vocab)
    n_req, served_tok = len(out), sum(len(t) for t in out.values())
    _check(n_req == total_req
           and served_tok == total_req * SMOKE_TRAFFIC.decode_len,
           f"served {n_req} requests / {served_tok} tokens of {total_req}")
    rate = served_tok / dt
    print(f"[smoke] served {total_req} requests / {served_tok} tokens "
          f"through 8 pass windows: {rate:.1f} tok/s on {device}")

    # -- 3. fleet loop vs NumPy oracle (f32 energy parity) ----------------
    cost = serve_cost(cfg, params, cut, tokens_per_s=rate)
    fleet = smoke_fleet(cost, device)
    res = fleet.run()
    assert_host_parity(res, SMOKE_TRAIN)
    _check(fleet.traces == 1 and fleet.host_syncs == 1,
           f"traces {fleet.traces}, host syncs {fleet.host_syncs}")
    s = res.summary()
    print(f"[smoke] fleet 2x8, 24 windows: arrivals={s['arrived_requests']} "
          f"served={s['served_requests']:.0f} "
          f"sustained={s['sustained_tokens_per_s']:.2f} tok/s "
          f"p99={s['p99_latency_s']:.1f}s trained={s['trained_passes']} "
          f"skipped={s['skipped_passes']}")
    print("[smoke] host-vs-device f32 energy parity OK "
          f"({time.perf_counter() - t0:.1f}s total)")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_fleet")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    return _smoke(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
