"""Roofline report: the port's dry-run JSON as a table of roofline terms
and per-cell bottleneck advice (the port of ``repro/launch/roofline.py``,
same columns and format). The terms are computed from the census on the
H100's constants, not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline results/dryrun_h100.json
  PYTHONPATH=src python -m repro_torch.launch.roofline results/dryrun_h100.json --md --advice
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

ADVICE = {
    "memory_s": ("run the plain parts as kernels that keep their tiles in "
                 "shared memory (the attention backward, the scans' "
                 "recompute and the sLSTM loop move every f32 intermediate "
                 "through HBM) and keep activations in bf16"),
    "compute_s": ("keep the products on the bf16 tensor cores (f32 "
                  "products run at 67 of 989 TFLOP/s) and cut recompute "
                  "(the remat policy)"),
    "collective_s": ("none on one card: a collective term means the count "
                     "saw a collective, which the port does not issue"),
}


def load(path: str, mesh: str = "h100x1",
         preset: Optional[str] = None) -> List[Dict]:
    with open(path) as f:
        rows = json.load(f)
    out = [r for r in rows if r.get("mesh") == mesh]
    if preset is not None:
        out = [r for r in out if r.get("preset") == preset]
    return out


def _fmt(x, digits=3):
    if x == 0:
        return "0"
    if x < 1e-3 or x >= 1e4:
        return f"{x:.{digits}e}"
    return f"{x:.{digits}g}"


def table(rows: List[Dict], md: bool = False) -> str:
    hdr = ["arch", "shape", "preset", "T_comp[s]", "T_mem[s]", "T_coll[s]",
           "dominant", "6ND[s]", "MODEL/HLO", "roofline"]
    lines = []
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    else:
        lines.append(",".join(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"],
                                         r.get("preset", ""))):
        if r.get("status") == "skipped":
            row = [r["arch"], r["shape"], r.get("preset", ""), "-", "-", "-",
                   "skipped", "-", "-", "-"]
        elif r.get("status") != "ok":
            row = [r["arch"], r["shape"], r.get("preset", ""), "-", "-", "-",
                   "ERROR", "-", "-", "-"]
        else:
            rf = r["roofline"]
            row = [r["arch"], r["shape"], r.get("preset", ""),
                   _fmt(rf["compute_s"]), _fmt(rf["memory_s"]),
                   _fmt(rf["collective_s"]),
                   rf["dominant"].replace("_s", ""),
                   _fmt(rf["useful_s"]),
                   _fmt(rf["flops_ratio_useful"], 2),
                   _fmt(rf["roofline_fraction"], 3)]
        if md:
            lines.append("| " + " | ".join(map(str, row)) + " |")
        else:
            lines.append(",".join(map(str, row)))
    return "\n".join(lines)


def advice(rows: List[Dict]) -> str:
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        lines.append(f"- {r['arch']} x {r['shape']}: {rf['dominant']} "
                     f"dominates ({_fmt(rf[rf['dominant']])} s vs useful "
                     f"{_fmt(rf['useful_s'])} s) -> "
                     f"{ADVICE[rf['dominant']]}.")
    return "\n".join(lines)


def interesting_cells(rows: List[Dict]) -> Dict[str, Dict]:
    """The three hillclimb picks: worst roofline fraction, most
    collective-bound (on one card every term is 0: the first cell),
    most representative of the paper's technique."""
    ok = [r for r in rows if r.get("status") == "ok"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
    # "most representative": the runnable SL driver arch at train shape
    rep = next((r for r in ok if r["arch"] == "smollm_360m"
                and r["shape"] == "train_4k"), ok[0])
    return {"worst_roofline": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--mesh", default="h100x1")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--advice", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.path, args.mesh, args.preset)
    print(table(rows, md=args.md))
    if args.advice:
        print()
        print(advice(rows))
        picks = interesting_cells(rows)
        print("\nhillclimb picks:")
        for k, r in picks.items():
            print(f"  {k}: {r['arch']} x {r['shape']} "
                  f"(fraction {r['roofline']['roofline_fraction']:.4f})")


if __name__ == "__main__":
    main()
