"""The paper's tables on the port (``repro_torch.launch.paper_tables``)
against the values the reference's ``repro.core`` gives for the same
calls (``benchmarks/paper_tables.py``'s, rebuilt here so the test does
not import ``benchmarks/``): every leaf of ``run_all(device="cpu")``
within rtol 1e-9 where the port solves in NumPy (Table I, Table II,
Fig. 3 top, the scalar rows of the beyond-paper block) and within
test_torch_solver's rtol 1e-6 where it solves on the float64 tensor
solver (Fig. 3 bottom, the split search), and the claims of the
reference's ``test_fig3_claims``."""
import math

import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import resource_opt as jro
from repro.core import splitting as jsplit
from repro_torch.launch import paper_tables

NUMPY_RTOL, TORCH_RTOL = 1e-9, 1e-6
AE = paper_tables.PAPER_AE
RAW = paper_tables.RAW_IMAGE_BITS


def _reference():
    """The reference's run_all() dict from repro.core, call for call."""
    plan = jsplit.resnet18_plan(img=224, n_classes=1000)
    b = jenergy.PassBudget(n_items=400.0)
    total_bits = 8.0 * sum(l.param_bytes for l in plan.layers)
    t2 = {}
    for name, cut in jsplit.RESNET18_PAPER_CUTS.items():
        c = plan.costs_at(cut)
        t2[name] = dict(
            w1_ours=c.w1_flops / 2.0, w2_ours=c.w2_flops / 2.0,
            dtx_ours=c.dtx_bits, d_isl_segA=c.d_isl_bits,
            d_isl_segB=total_bits + AE["d_isl"] * 0 - c.d_isl_bits,
            **{f"{k}_paper": v
               for k, v in paper_tables.PAPER_TABLE2[name].items()})
    top = {}
    for label, scale in [("paper_W_per_image", 1.0),
                         ("W_as_total(/400)", 1.0 / 400.0)]:
        sl = jenergy.SplitCosts(w1_flops=AE["w1"] * scale,
                                w2_flops=AE["w2"] * scale,
                                dtx_bits=AE["dtx"], d_isl_bits=AE["d_isl"],
                                name="ae-sl")
        dd = jenergy.direct_download_costs(RAW,
                                           (AE["w1"] + AE["w2"]) * scale)
        r_sl, r_dd = jro.solve(b, sl), jro.solve(b, dd)
        e_sl, e_dd = r_sl.allocation.e_total, r_dd.allocation.e_total
        top[label] = dict(e_sl=e_sl, e_dd=e_dd,
                          savings_pct=100.0 * (1.0 - e_sl / e_dd),
                          sl=r_sl.allocation.summary(),
                          dd=r_dd.allocation.summary())
    names = list(jsplit.RESNET18_PAPER_CUTS)
    cands = [plan.costs_at(jsplit.RESNET18_PAPER_CUTS[n]) for n in names]
    cands.append(jenergy.direct_download_costs(
        RAW, plan.costs_at(0).w2_flops / 3.0 * 3.0))
    rep = jro.solve_batch(b, cands, backend="numpy")
    bot = {}
    for i, name in enumerate(names):
        a = rep.report_at(i).allocation
        bot[name] = dict(e_total=a.e_total,
                         e_comm=a.e_comm_down + a.e_comm_up + a.e_isl,
                         e_proc=a.e_proc_sat + a.e_proc_gs,
                         feasible=a.feasible)
    bot["direct"] = dict(e_total=float(rep.e_total[len(names)]))
    cbest, rbest = jro.best_split_batch(b, plan.enumerate_cuts(),
                                        backend="numpy")
    beyond = dict(
        base=jro.solve(b, plan.costs_at(5)).allocation.e_total,
        int8=jro.solve(b, plan.with_boundary_compression(0.25)
                       .costs_at(5)).allocation.e_total,
        pipelined=jro.solve_pipelined(b, plan.costs_at(5),
                                      n_microbatches=8).allocation.e_total,
        auto_split=dict(cut=cbest.name, e=rbest.allocation.e_total))
    return {"table1": jorbits.PAPER_PLANE.summary(), "table2": t2,
            "fig3_top": top, "fig3_bottom": bot, "beyond_paper": beyond}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def tables():
    return paper_tables.run_all(device="cpu"), _reference()


def test_run_all_matches_reference_leaf_by_leaf(tables):
    got, want = tables
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    n_torch = 0
    for path, v in w.items():
        torch_row = path[0] == "fig3_bottom" or path[:2] == (
            "beyond_paper", "auto_split")
        n_torch += torch_row
        if isinstance(v, float) and not isinstance(v, bool):
            assert g[path] == pytest.approx(
                v, rel=TORCH_RTOL if torch_row else NUMPY_RTOL,
                abs=1e-15), path
        else:
            assert g[path] == v, path
    assert n_torch == 15


def test_fig3_claims(tables):
    got, _ = tables
    top, bot = got["fig3_top"], got["fig3_bottom"]
    # the paper's ~97% savings reproduces in the comm-dominated regime
    assert top["W_as_total(/400)"]["savings_pct"] > 90.0
    assert bot["l1"]["e_total"] > bot["l2"]["e_total"] > bot["l3"]["e_total"]
    assert math.isclose(got["table1"]["pass_duration_min"], 3.8, rel_tol=0.01)


def test_cli_prints_the_tables(capsys):
    out = paper_tables.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for block in ("Table 1", "Table 2", "Fig. 3 (top)", "Fig. 3 (bottom)",
                  "beyond-paper"):
        assert f"== {block}" in text
    assert "monotone decreasing OK" in text
    assert set(out) == {"table1", "table2", "fig3_top", "fig3_bottom",
                        "beyond_paper"}


def test_refuses_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        paper_tables.run_all()
    assert np.isfinite(paper_tables.fig3_bottom("cpu")["direct"]["e_total"])
