"""``python -m repro_torch.fleet [--scenario baseline|degraded] [--device
cuda|cpu]``: the fleet smokes. ``baseline`` (:func:`repro_torch.fleet.
engine._smoke`) runs two planes of 8 satellites with a join, a leave and
seeded failures over two revolutions, held against the host engine plane
by plane; ``degraded`` (:func:`repro_torch.fleet.scenarios.
_smoke_degraded`) runs them under eclipse windows, a Byzantine slot and
epidemic faults, held against the NumPy action oracle. They run on the
card unless ``--device cpu`` is given.

Environment knobs, as the reference's: ``REPRO_FLEET_SMOKE_SATS`` (default
8), ``REPRO_FLEET_SMOKE_PLANES`` (2), ``REPRO_FLEET_SMOKE_REVS`` (2).
"""
import argparse
import os

from repro_torch.fleet.engine import _smoke
from repro_torch.fleet.scenarios import _smoke_degraded


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet")
    ap.add_argument("--scenario", choices=("baseline", "degraded"),
                    default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (their plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)
    smoke = _smoke_degraded if args.scenario == "degraded" else _smoke
    return smoke(
        n_sats=int(os.environ.get("REPRO_FLEET_SMOKE_SATS", "8")),
        n_planes=int(os.environ.get("REPRO_FLEET_SMOKE_PLANES", "2")),
        n_revolutions=int(os.environ.get("REPRO_FLEET_SMOKE_REVS", "2")),
        device=args.device)


if __name__ == "__main__":
    main()
