"""The paper's tables and figures on the port: the counterpart of
``benchmarks/paper_tables.py``.

One function per artifact; each prints a CSV-ish block and returns a
dict, the reference's keys and values:

  table1      — constellation geometry (T_pass ≈ 3.8 min check)
  table2      — ResNet-18 split points (ours vs paper; both D_ISL conventions)
  fig3_top    — autoencoder SL vs direct download energy (the 97% claim)
  fig3_bottom — ResNet split-point energy sweep
  beyond_paper — int8 boundary, microbatch pipelining, auto split search

The scalar solves (:func:`~repro_torch.core.resource_opt.solve`,
``solve_pipelined``) run in NumPy float64, as in the reference. The
batched solves of ``fig3_bottom`` and ``beyond_paper`` run on the port's
float64 tensor solver (``backend="torch"``) on ``device``: the card
unless the caller asks for the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.paper_tables [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch import resolve_device
from repro_torch.core.energy import (PassBudget, SplitCosts,
                                     direct_download_costs)
from repro_torch.core.orbits import PAPER_PLANE
from repro_torch.core.resource_opt import (best_split_batch, solve,
                                           solve_batch, solve_pipelined)
from repro_torch.core.splitting import RESNET18_PAPER_CUTS, resnet18_plan

# Paper-published numbers (§V-A, Table II).
PAPER_AE = dict(w1=302e9, w2=39e6, dtx=4.7e3, d_isl=168.8e3)
PAPER_TABLE2 = {
    "l1": dict(w1=1.765e9, w2=3.714e9, dtx=6.423e6, d_isl=369.056e6),
    "l2": dict(w1=3.006e9, w2=2.474e9, dtx=3.211e6, d_isl=352.224e6),
    "l3": dict(w1=4.243e9, w2=1.237e9, dtx=1.605e6, d_isl=285.024e6),
}
RAW_IMAGE_BITS = 1.605e6           # Table I "average image size D"


def table1() -> Dict:
    s = PAPER_PLANE.summary()
    print("== Table 1 / constellation geometry ==")
    for k, v in s.items():
        print(f"  {k:24s} {v:.4f}" if isinstance(v, float) else
              f"  {k:24s} {v}")
    print(f"  paper claim: T_pass ~ 3.8 min -> ours "
          f"{s['pass_duration_min']:.3f} min "
          f"(eq. 4 erratum: /(2*pi), see DESIGN.md)")
    return s


def table2() -> Dict:
    """ResNet-18 split costs: our analytic model vs the paper's values."""
    plan = resnet18_plan(img=224, n_classes=1000)
    total_param_bits = 8.0 * (sum(l.param_bytes for l in plan.layers))
    print("== Table 2 / ResNet-18 split points ==")
    print("cut, W1_ours_GF, W1_paper_GF, W2_ours_GF, W2_paper_GF, "
          "Dtx_ours_Mb, Dtx_paper_Mb, Disl_segA_Mb, Disl_paper(segB)_Mb")
    out = {}
    for name, cut in RESNET18_PAPER_CUTS.items():
        c = plan.costs_at(cut)
        p = PAPER_TABLE2[name]
        # The paper counts W in GMAC-units (fvcore counts MACs): W_paper =
        # 3 x GMACs. Our fwd_flops are 2 FLOPs/MAC, so ours/2 x 3 = theirs.
        w1_ours = c.w1_flops / 2.0
        w2_ours = c.w2_flops / 2.0
        disl_segb = total_param_bits - c.d_isl_bits
        row = dict(w1_ours=w1_ours, w2_ours=w2_ours,
                   dtx_ours=c.dtx_bits, d_isl_segA=c.d_isl_bits,
                   d_isl_segB=disl_segb, **{f"{k}_paper": v
                                            for k, v in p.items()})
        out[name] = row
        print(f"{name}, {w1_ours/1e9:.3f}, {p['w1']/1e9:.3f}, "
              f"{w2_ours/1e9:.3f}, {p['w2']/1e9:.3f}, "
              f"{c.dtx_bits/1e6:.3f}, {p['dtx']/1e6:.3f}, "
              f"{c.d_isl_bits/1e6:.1f}, {p['d_isl']/1e6:.1f}")
    print("  NOTE (erratum #2, DESIGN.md): the paper's D_ISL column matches "
          "the GROUND segment's parameter bytes (total - segA); the handoff "
          "the architecture ships is segment A. Both reported.")
    return out


def _budget(n_items=400.0) -> PassBudget:
    return PassBudget(n_items=n_items)


def fig3_top() -> Dict:
    """Autoencoder: SL vs direct download, two W interpretations."""
    print("== Fig. 3 (top) / autoencoder SL vs direct download ==")
    out = {}

    for label, scale in [("paper_W_per_image", 1.0),
                         ("W_as_total(/400)", 1.0 / 400.0)]:
        sl = SplitCosts(w1_flops=PAPER_AE["w1"] * scale,
                        w2_flops=PAPER_AE["w2"] * scale,
                        dtx_bits=PAPER_AE["dtx"],
                        d_isl_bits=PAPER_AE["d_isl"], name="ae-sl")
        dd = direct_download_costs(
            RAW_IMAGE_BITS, (PAPER_AE["w1"] + PAPER_AE["w2"]) * scale)
        b = _budget()
        r_sl = solve(b, sl)
        r_dd = solve(b, dd)
        e_sl, e_dd = r_sl.allocation.e_total, r_dd.allocation.e_total
        sav = 100.0 * (1.0 - e_sl / e_dd)
        out[label] = dict(
            e_sl=e_sl, e_dd=e_dd, savings_pct=sav,
            sl=r_sl.allocation.summary(), dd=r_dd.allocation.summary())
        a = r_sl.allocation
        print(f"  [{label}] E_SL={e_sl:.4g} J (proc "
              f"{a.e_proc_sat + a.e_proc_gs:.3g} / comm "
              f"{a.e_comm_down + a.e_comm_up + a.e_isl:.3g})"
              f"  E_DD={e_dd:.4g} J  savings={sav:.1f}%")
    print("  paper claim: ~97% savings — reproduced in the comm-dominated "
          "regime (W-as-total row); with W per-image the processing term "
          "dominates both systems and savings shrink (DESIGN.md erratum #3).")
    return out


def fig3_bottom(device="cuda") -> Dict:
    """ResNet-18 energy at the three split points (+ direct download):
    one batched solve on the float64 tensor solver on ``device``."""
    print("== Fig. 3 (bottom) / ResNet-18 split-point sweep ==")
    plan = resnet18_plan(img=224, n_classes=1000)
    b = _budget()
    names = list(RESNET18_PAPER_CUTS)
    cands = [plan.costs_at(RESNET18_PAPER_CUTS[nm]) for nm in names]
    cands.append(direct_download_costs(
        RAW_IMAGE_BITS, plan.costs_at(0).w2_flops / 3.0 * 3.0))
    rep = solve_batch(b, cands, backend="torch", device=device)
    out = {}
    for i, name in enumerate(names):
        a = rep.report_at(i).allocation
        out[name] = dict(e_total=a.e_total, e_comm=a.e_comm_down
                         + a.e_comm_up + a.e_isl,
                         e_proc=a.e_proc_sat + a.e_proc_gs,
                         feasible=a.feasible)
        print(f"  {name}: E={a.e_total:.4g} J (comm "
              f"{out[name]['e_comm']:.3g}, proc {out[name]['e_proc']:.3g}) "
              f"Dtx={cands[i].dtx_bits/1e6:.2f} Mb")
    out["direct"] = dict(e_total=float(rep.e_total[len(names)]))
    print(f"  direct download: E={out['direct']['e_total']:.4g} J")
    order = [out[k]["e_total"] for k in ("l1", "l2", "l3")]
    print(f"  paper claim: deeper split (l3) wins -> ours "
          f"{'monotone decreasing OK' if order[0] > order[1] > order[2] else order}")
    return out


def beyond_paper(device="cuda") -> Dict:
    """Beyond-paper rows: int8 boundary, pipelining, auto split search
    (the split search one batched solve on ``device``)."""
    print("== beyond-paper optimizations (energy model) ==")
    plan = resnet18_plan(img=224, n_classes=1000)
    b = _budget()
    base = solve(b, plan.costs_at(5))                       # l2
    q = solve(b, plan.with_boundary_compression(0.25).costs_at(5))
    pipe = solve_pipelined(b, plan.costs_at(5), n_microbatches=8)
    cbest, rbest = best_split_batch(b, plan.enumerate_cuts(),
                                    backend="torch", device=device)
    out = dict(
        base=base.allocation.e_total,
        int8=q.allocation.e_total,
        pipelined=pipe.allocation.e_total,
        auto_split=dict(cut=cbest.name, e=rbest.allocation.e_total))
    print(f"  l2 baseline            E={out['base']:.4g} J")
    print(f"  + int8 boundary (4x)   E={out['int8']:.4g} J "
          f"({100*(1-out['int8']/out['base']):.1f}% vs base)")
    print(f"  + microbatch pipeline  E={out['pipelined']:.4g} J "
          f"({100*(1-out['pipelined']/out['base']):.1f}% vs base)")
    print(f"  auto split search      {cbest.name} "
          f"E={rbest.allocation.e_total:.4g} J")
    return out


def run_all(device="cuda") -> Dict:
    device = resolve_device(device)
    return {
        "table1": table1(),
        "table2": table2(),
        "fig3_top": fig3_top(),
        "fig3_bottom": fig3_bottom(device),
        "beyond_paper": beyond_paper(device),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.launch.paper_tables")
    ap.add_argument("--device", default="cuda",
                    help="where the batched float64 solves run: cuda, or "
                    "cpu")
    return run_all(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
