"""The port's serving cost model (``ServeCost``, ``serve_cost``,
``TrainLoad`` in ``repro_torch.serve_fleet.engine``) against the
reference's, with the reference's weights carried across: joules per
generated token and boundary bits per token within 1e-12 on the smoke
configs of SmolLM-360M, Zamba2-1.2B (its shared block counts on the
satellite) and xLSTM-1.3B (at the two-unit variant, since the smoke
config has one unit and cannot be cut), and the window capacity and
the training load read from a plan."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy
from repro import configs as jconfigs
from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.models import lm as jlm
from repro.serve_fleet import engine as jengine
from repro_torch import configs
from repro_torch.core import energy, orbits
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params
from repro_torch.serve_fleet import engine

CASES = [("smollm_360m", {}, 1), ("zamba2_1_2b", {}, 1),
         ("xlstm_1_3b", {"n_layers": 8}, 1)]


@pytest.mark.parametrize("arch,over,cut", CASES)
@pytest.mark.parametrize("kw", [
    dict(tokens_per_s=40.0),
    dict(tokens_per_s=123.5, tx_power_w=5.0, act_bits=8),
    dict(tokens_per_s=10.0, budget="plane8"),
])
def test_serve_cost_matches_reference(arch, over, cut, kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke(arch), **over)
    tree = jax_tree_to_numpy(jlm.init(jcfg, jax.random.key(0)))
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("budget") == "plane8":
        jkw["budget"] = jenergy.PassBudget(
            plane=jorbits.OrbitalPlane(n_sats=8), n_items=100.0)
        tkw["budget"] = energy.PassBudget(
            plane=orbits.OrbitalPlane(n_sats=8), n_items=100.0)
    want = jengine.serve_cost(jcfg, jax.tree.map(np.asarray, tree), cut,
                              **jkw)
    got = engine.serve_cost(cfg, from_jax_params(tree), cut, **tkw)
    assert got.tokens_per_s == want.tokens_per_s
    assert got.e_token_j == pytest.approx(want.e_token_j, rel=1e-12)
    assert got.dtx_bits_token == pytest.approx(want.dtx_bits_token,
                                               rel=1e-12)
    assert got.e_token_j > 0
    if arch == "zamba2_1_2b":       # the shared block is priced too
        pa, _ = lm.split_serve_params(cfg, from_jax_params(tree), cut)
        assert "shared" in pa


@pytest.mark.parametrize("tps,window,toks", [(50.0, 90.0, 4.0),
                                             (33.3, 120.5, 7.0),
                                             (1e-3, 90.0, 12.0)])
def test_window_capacity_requests(tps, window, toks):
    got = engine.ServeCost(tps, 0.02, 2048.0)
    want = jengine.ServeCost(tps, 0.02, 2048.0)
    assert got.window_capacity_requests(window, toks) == \
        want.window_capacity_requests(window, toks)


def test_train_load_from_plan():
    class Plan:
        drain_j = np.array([48.25, 50.0, 47.5], np.float32)
        e_total_j = np.array([240.1, 241.0, 239.9], np.float32)

    class TensorPlan:
        drain_j = torch.from_numpy(Plan.drain_j)
        e_total_j = torch.from_numpy(Plan.e_total_j)

    want = jengine.TrainLoad.from_plan(Plan)
    assert engine.TrainLoad.from_plan(Plan) == engine.TrainLoad(
        want.drain_j, want.e_total_j)
    assert engine.TrainLoad.from_plan(TensorPlan) == \
        engine.TrainLoad.from_plan(Plan)
