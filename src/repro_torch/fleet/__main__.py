"""``python -m repro_torch.fleet [--scenario baseline] [--device cuda|cpu]``:
the baseline fleet smoke (:func:`repro_torch.fleet.engine._smoke`), two
planes of 8 satellites with a join, a leave and seeded failures over two
revolutions, held against the host engine plane by plane. It runs on the
card unless ``--device cpu`` is given. ``--scenario degraded`` (eclipse
windows, a Byzantine slot and epidemic faults) is slice 10 of the port
and raises ``NotImplementedError``.

Environment knobs, as the reference's: ``REPRO_FLEET_SMOKE_SATS`` (default
8), ``REPRO_FLEET_SMOKE_PLANES`` (2), ``REPRO_FLEET_SMOKE_REVS`` (2).
"""
import argparse
import os

from repro_torch.fleet.engine import NEXT_SLICE, _smoke


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet")
    ap.add_argument("--scenario", choices=("baseline", "degraded"),
                    default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.scenario == "degraded":
        raise NotImplementedError(
            f"the degraded-ops smoke (--scenario degraded) is {NEXT_SLICE}")
    return _smoke(
        n_sats=int(os.environ.get("REPRO_FLEET_SMOKE_SATS", "8")),
        n_planes=int(os.environ.get("REPRO_FLEET_SMOKE_PLANES", "2")),
        n_revolutions=int(os.environ.get("REPRO_FLEET_SMOKE_REVS", "2")),
        device=args.device)


if __name__ == "__main__":
    main()
