"""``python -m repro_torch.obs``: the flight-recorder smoke and the timeline
render CLI (the port of ``python -m repro.obs``).

With no subcommand it runs the record → flush → render smoke:

1. a 2-plane × 8-sat degraded fleet run (eclipse + epidemic) under a
   :func:`~repro_torch.obs.metrics.sync_budget` guard: every pass
   produced exactly one ring event, whose action payload equals the
   dense telemetry;
2. a delegated ``ConstellationSim.run(engine="device")``: the recorder's
   events equal the host-facing ``PassRecord`` list;
3. a serving-fleet run: one ``EV_SERVE`` event per (plane, window);
4. a merged Chrome-trace render, structurally validated.

``python -m repro_torch.obs render`` runs a fresh fleet (optionally with
the degraded scenario and/or a concurrent serving fleet) and writes the
Perfetto/Chrome-trace JSON; the acceptance path is::

    python -m repro_torch.obs render --planes 4 --sats 256 \\
        --scenario degraded --serve --out trace.json

Both run on the card unless ``--device cpu`` is given. Environment knobs
of the smoke, as the reference's: ``REPRO_OBS_SMOKE_SATS`` (default 8),
``REPRO_OBS_SMOKE_PLANES`` (2), ``REPRO_OBS_SMOKE_REVS`` (2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_DEVICE_HELP = ("cuda (hand-written kernels) or cpu (their plain PyTorch "
                "versions)")


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _fleet_engine(n_planes: int, n_sats: int, n_revolutions: int,
                  scenario: str, device, seed: int = 0):
    from repro_torch.core.energy import PassBudget
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.fleet.engine import FleetConfig, FleetEngine
    from repro_torch.fleet.scenarios import (EclipseConfig, EpidemicConfig,
                                             ScenarioConfig)
    from repro_torch.sim.data import DeviceImageryShards

    scn = None
    if scenario == "degraded":
        scn = ScenarioConfig(
            eclipse=EclipseConfig(period=4, duty=0.5, stagger=1),
            epidemic=EpidemicConfig(beta=0.6, ttl=2, init_slots=(0,),
                                    start=0))
    cfg = FleetConfig(
        n_planes=n_planes, n_revolutions=n_revolutions,
        battery_j=200.0, recharge_w=0.02, reserve_j=180.0,
        max_steps_per_pass=2, seed=seed, avg_every=1, scenario=scn,
        aggregate="median" if scn is not None and n_planes > 1 else "mean")
    return FleetEngine(autoencoder_adapter(cut=5, img=32),
                       PassBudget(plane=OrbitalPlane(n_sats=n_sats),
                                  n_items=4e6),
                       DeviceImageryShards(img=32, batch=4, device=device),
                       cfg, device=device)


def _serve_engine(n_planes: int, n_sats: int, n_windows: int, device,
                  seed: int = 2):
    from repro_torch.fleet.scenarios import EclipseConfig
    from repro_torch.serve_fleet.engine import (FleetServeEngine, ServeCost,
                                                ServeFleetConfig, TrainLoad)
    from repro_torch.serve_fleet.traffic import TrafficConfig

    cost = ServeCost(tokens_per_s=400.0, e_token_j=0.05,
                     dtx_bits_token=16_384.0)
    scfg = ServeFleetConfig(
        n_planes=n_planes, n_sats=n_sats, n_windows=n_windows,
        battery_j=60.0, recharge_w=0.02, reserve_serve_j=5.0,
        reserve_train_j=30.0, eclipse=EclipseConfig(period=6, duty=0.5),
        window_s=90.0)
    train = TrainLoad(drain_j=8.0, e_total_j=12.0)
    return FleetServeEngine(scfg, TrafficConfig(users_per_day=60_000.0,
                                                decode_len=4, seed=seed),
                            cost, train=train, device=device)


def _smoke(device="cuda") -> dict:
    import tempfile

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.obs.metrics import sync_budget
    from repro_torch.obs.ring import (EV_EXCHANGE, EV_PASS, EV_SERVE,
                                      merge_events)
    from repro_torch.obs.timeline import (timeline_summary,
                                          validate_chrome_trace,
                                          write_chrome_trace)

    device = resolve_device(device)
    n_sats = int(os.environ.get("REPRO_OBS_SMOKE_SATS", "8"))
    n_planes = int(os.environ.get("REPRO_OBS_SMOKE_PLANES", "2"))
    n_revs = int(os.environ.get("REPRO_OBS_SMOKE_REVS", "2"))
    t0 = time.perf_counter()

    # -- 1. degraded fleet run under a sync budget ------------------------
    fleet = _fleet_engine(n_planes, n_sats, n_revs, "degraded", device)
    with sync_budget(n_revs, registry=fleet.metrics):
        res = fleet.run(stream_telemetry=True)
    ev = fleet.recorder.events()
    n_pass = int((ev["kind"] == EV_PASS).sum())
    _check(n_pass == res.action.size, (n_pass, res.action.shape))
    _check(fleet.recorder.dropped == 0, "the fleet's rings dropped events")
    # payload actions must equal the dense telemetry
    for p in range(n_planes):
        sel = (ev["kind"] == EV_PASS) & (ev["plane"] == p)
        order = np.argsort(ev["t"][sel])
        np.testing.assert_array_equal(
            ev["payload"][sel][order][:, 0].astype(np.int32),
            res.action[p])
    n_exch = int((ev["kind"] == EV_EXCHANGE).sum())
    print(f"[obs] fleet {n_planes}x{n_sats}x{n_revs}: {n_pass} pass "
          f"events + {n_exch} exchange markers, payload==telemetry, "
          f"host_syncs={fleet.host_syncs}<= {n_revs} "
          f"({time.perf_counter() - t0:.1f}s)")

    # -- 2. delegated sim run: events must equal PassRecords --------------
    t1 = time.perf_counter()
    from repro_torch.core.constellation import (ConstellationConfig,
                                                ConstellationSim)
    from repro_torch.core.energy import PassBudget
    from repro_torch.core.orbits import OrbitalPlane
    from repro_torch.core.sl_step import autoencoder_adapter
    from repro_torch.sim.data import DeviceImageryShards
    from repro_torch.sim.device_sim import ACTION_NAMES

    sim = ConstellationSim(
        autoencoder_adapter(cut=5, img=32),
        PassBudget(plane=OrbitalPlane(n_sats=4), n_items=4e6),
        DeviceImageryShards(img=32, batch=4, device=device),
        ConstellationConfig(n_passes=8, batch_size=4, battery_j=200.0,
                            recharge_w=0.01, reserve_j=150.0,
                            max_steps_per_pass=4), device=device)
    sim.run(engine="device")
    eng = sim.device_engine
    _check(len(eng.recorder) == len(sim.records),
           (len(eng.recorder), len(sim.records)))
    sim_ev = eng.recorder.events()
    code = {v: k for k, v in ACTION_NAMES.items()}
    rec_act = np.array([code[r.action] for r in sim.records], np.int32)
    np.testing.assert_array_equal(
        sim_ev["payload"][:, 0].astype(np.int32), rec_act)
    print(f"[obs] delegated sim: {len(eng.recorder)} events == "
          f"{len(sim.records)} PassRecords ({time.perf_counter() - t1:.1f}s)")

    # -- 3. serving fleet: one EV_SERVE per (plane, window) ---------------
    t2 = time.perf_counter()
    serve = _serve_engine(n_planes, n_sats, 24, device)
    with sync_budget(1, registry=serve.metrics):
        sres = serve.run()
    sev = serve.recorder.events()
    n_serve = int((sev["kind"] == EV_SERVE).sum())
    _check(n_serve == sres.arrivals.size, (n_serve, sres.arrivals.shape))
    print(f"[obs] serve fleet: {n_serve} serve events == "
          f"{sres.arrivals.size} windows ({time.perf_counter() - t2:.1f}s)")

    # -- 4. merged render -------------------------------------------------
    merged = merge_events(ev, sev)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        write_chrome_trace(path, merged, window_s=90.0)
        with open(path) as fh:
            validate_chrome_trace(json.load(fh))
    print(timeline_summary(merged))
    print(f"[obs] smoke OK: render valid on {device} "
          f"({time.perf_counter() - t0:.1f}s total)")
    return {"pass_events": n_pass, "exchange_events": n_exch,
            "sim_events": len(eng.recorder), "serve_events": n_serve}


def _render(argv) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs render",
        description="run a fleet (optionally + serving) and write the "
                    "mission timeline as Chrome-trace/Perfetto JSON")
    ap.add_argument("--planes", type=int, default=2)
    ap.add_argument("--sats", type=int, default=8)
    ap.add_argument("--revolutions", type=int, default=1)
    ap.add_argument("--windows", type=int, default=24,
                    help="serve windows (with --serve)")
    ap.add_argument("--scenario", choices=("none", "degraded"),
                    default="none")
    ap.add_argument("--serve", action="store_true",
                    help="also run a serve fleet on the same plane "
                         "layout and merge its windows into the trace")
    ap.add_argument("--window-s", type=float, default=90.0,
                    help="seconds of trace time per pass/window index")
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--events", default=None,
                    help="also save the raw event table (.npz)")
    ap.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.obs.ring import merge_events
    from repro_torch.obs.timeline import (timeline_summary,
                                          validate_chrome_trace,
                                          write_chrome_trace)

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    fleet = _fleet_engine(args.planes, args.sats, args.revolutions,
                          args.scenario, device)
    fleet.run()
    tables = [fleet.recorder.events()]
    recorders = [fleet.recorder]
    print(f"[render] fleet {args.planes}x{args.sats}x{args.revolutions} "
          f"({args.scenario}) on {device}: {len(fleet.recorder)} events, "
          f"host_syncs={fleet.host_syncs} ({time.perf_counter() - t0:.1f}s)")
    if args.serve:
        t1 = time.perf_counter()
        serve = _serve_engine(args.planes, args.sats, args.windows, device)
        serve.run()
        tables.append(serve.recorder.events())
        recorders.append(serve.recorder)
        print(f"[render] serve fleet {args.planes}x{args.sats}, "
              f"{args.windows} windows: {len(serve.recorder)} events "
              f"({time.perf_counter() - t1:.1f}s)")

    merged = merge_events(*tables)
    trace = write_chrome_trace(args.out, merged, window_s=args.window_s)
    validate_chrome_trace(trace)
    _check(sum(r.dropped for r in recorders) == 0, "events were dropped")
    if args.events:
        import numpy as np
        np.savez(args.events, dropped=np.int64(0), **merged)
        print(f"[render] event table -> {args.events}")
    print(timeline_summary(merged))
    print(f"[render] {len(trace['traceEvents'])} trace events -> "
          f"{args.out} (open in ui.perfetto.dev or chrome://tracing)")
    return {"events": int(merged["kind"].size),
            "trace_events": len(trace["traceEvents"])}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "render":
        return _render(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="the flight-recorder smoke; 'render ...' writes a "
                    "fleet's timeline (see 'render --help')")
    ap.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    return _smoke(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
