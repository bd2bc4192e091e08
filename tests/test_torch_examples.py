"""The ports of the four remaining examples (``repro_torch.launch.
quickstart``, ``constellation_online_learning``, ``serve_batched`` and
``isl_exchange``) on the CPU at short sizes, against the reference's
functions: the plane summary, problem (13)'s allocation and the direct
download's saving exactly, the quickstart's SL steps and the example
ring's passes from the reference's weights, the batched serving's
tokens from the reference's weights, and the ISL comparison with its
oracle replay (asserted inside the example)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, one_torch_thread
from repro import configs as jconfigs
from repro.core import constellation as jcon
from repro.core import energy as jenergy
from repro.core import orbits as jorbits
from repro.core import resource_opt as jro
from repro.core import sl_step as jsl
from repro.core.train_state import SLTrainState as JSLTrainState
from repro.data.synthetic import ImageryShards
from repro.models import lm as jlm
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import Request as JRequest
from repro.train.optimizer import sgd as jsgd
from repro_torch import configs
from repro_torch.launch import (constellation_online_learning, isl_exchange,
                                quickstart, serve_batched)
from repro_torch.models.param import from_jax_params


def _jplan(img, n_items=64):
    costs = jsl.autoencoder_adapter(cut=5, img=img).costs()
    budget = jenergy.PassBudget(n_items=n_items)
    rep = jro.solve(budget, costs)
    rep_dd = jro.solve(budget, jenergy.direct_download_costs(
        img * img * 3 * 32, costs.w1_flops + costs.w2_flops))
    return rep, rep_dd


@pytest.mark.parametrize("img", [64, 224])
def test_quickstart_plan_is_the_references(img):
    """Problem (13) on the autoencoder split and the direct download: the
    allocation's summary and the saving, as the reference computes them
    (rtol 1e-12, the solvers' parity)."""
    rep, rep_dd, saving = quickstart.plan(img)
    jrep, jrep_dd = _jplan(img)
    got, want = rep.allocation.summary(), jrep.allocation.summary()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    jsaving = 100 * (1 - jrep.allocation.e_total / jrep_dd.allocation.e_total)
    np.testing.assert_allclose(saving, jsaving, rtol=1e-12)
    assert 0 < saving < 100


def test_quickstart_sl_steps_match_the_reference():
    """Three SL steps (int8 boundary, SGD) from the reference's weights on
    the same batches: losses within 1e-3, the same boundary bits."""
    img, steps, batch = 32, 3, 4
    jad = jsl.autoencoder_adapter(cut=5, img=img)
    jpa, jpb = jad.init(jax.random.key(0))
    init = tuple(from_jax_params(jax_tree_to_numpy(p)) for p in (jpa, jpb))
    with one_torch_thread():
        got = quickstart.sl_steps(img, steps, batch, device="cpu", init=init)
    jstep = jsl.make_sl_step(jad, quantize_boundary=True)
    shards = ImageryShards(img=img, batch=batch)
    opt = jsgd(lr=1e-2)
    state = JSLTrainState.create(jpa, jpb, opt)
    for i, (loss, bits) in enumerate(got):
        b = jax.tree.map(jnp.asarray, shards.batch_at(0, i))
        res = jstep(state.params_a, state.params_b, b)
        state = state.apply_updates(res.grads_a, res.grads_b, opt)
        np.testing.assert_allclose(loss, float(res.loss), rtol=1e-3)
        assert bits == float(res.dtx_bits_down)
    assert got[-1][0] < got[0][0]


def test_quickstart_main_prints_the_sections(capsys):
    with one_torch_thread():
        out = quickstart.main(["--img", "32", "--steps", "2", "--batch", "2",
                               "--device", "cpu"])
    text = capsys.readouterr().out
    for section in ("== constellation ==", "== problem (13)",
                    "savings", "step 1: loss", "done."):
        assert section in text
    assert out["plane"] == jorbits.PAPER_PLANE.summary()
    assert len(out["steps"]) == 2


def test_constellation_example_matches_the_reference(tmp_path):
    """The example's ring (failures, reserve, two satellites joining at
    pass 12, handoffs) over 13 passes at 32 px, 2 SL steps a pass, from
    the reference's weights: the same actions, satellites and planner
    counts, losses within 1e-3."""
    passes, img, batch, items = 13, 32, 4, 8
    shards = ImageryShards(img=img, batch=batch, n_shards=25)
    kw = dict(n_passes=passes, batch_size=batch, optimizer="sgd",
              quantize_boundary=True, fail_prob=0.08, battery_j=2_000.0,
              recharge_w=5.0, reserve_j=100.0, join_events={12: 2},
              handoff_dir=str(tmp_path / "ref"))
    jsim = jcon.ConstellationSim(
        jsl.autoencoder_adapter(cut=5, img=img),
        jenergy.PassBudget(n_items=items),
        lambda s, i: jax.tree.map(jnp.asarray, shards.batch_at(s, i)),
        jcon.ConstellationConfig(**kw))
    init = tuple(from_jax_params(jax_tree_to_numpy(p))
                 for p in (jsim.state.params_a, jsim.state.params_b))
    want = jsim.run()
    with one_torch_thread():
        sim = constellation_online_learning.run(
            passes, img, batch, items, device="cpu", init=init,
            handoff_dir=str(tmp_path / "port"))
    got = sim.records
    assert [r.action for r in got] == [r.action for r in want]
    assert [r.sat_id for r in got] == [r.sat_id for r in want]
    assert {"trained", "failed"} <= {r.action for r in got}
    assert len(sim.sats) == len(jsim.sats) == 27      # 25 + 2 joined
    for g, w in zip(got, want):
        if w.loss is None:
            assert g.loss is None
        else:
            np.testing.assert_allclose(g.loss, w.loss, rtol=1e-3)
    assert (sim.planner.solve_calls, sim.planner.invalidations) == \
        (jsim.planner.solve_calls, jsim.planner.invalidations)
    assert sim.summary()["trained"] == jsim.summary()["trained"]


def test_constellation_example_main(capsys):
    with one_torch_thread():
        sim = constellation_online_learning.main(
            ["--passes", "3", "--img", "32", "--batch", "4", "--items", "8",
             "--device", "cpu"])
    text = capsys.readouterr().out
    assert "summary:" in text and "batched solve(s)" in text
    assert len(sim.records) == 3


@pytest.mark.parametrize("arch", ["smollm_360m", "mixtral_8x7b"])
def test_serve_batched_tokens_are_the_references(arch):
    """The example's requests (6 prompts of 6 tokens, 3 slots, 10 new
    tokens) from the reference's weights: the same greedy tokens (f32
    activations on both sides)."""
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jlm.init(jcfg, jax.random.key(0))
    with one_torch_thread():
        got = serve_batched.serve(cfg, from_jax_params(
            jax_tree_to_numpy(jparams)), act_dtype=torch.float32,
            device="cpu")
    rng = np.random.default_rng(0)
    reqs = [JRequest(rid=i, prompt=rng.integers(0, cfg.vocab, 6)
                     .astype(np.int32), max_new_tokens=10) for i in range(6)]
    want = JDecodeEngine(jcfg, jparams, n_slots=3, s_max=96,
                         act_dtype=jnp.float32).submit_and_run(reqs)
    assert got == want
    assert all(len(t) == 10 for t in got.values())


def test_serve_batched_main(capsys):
    with one_torch_thread():
        out = serve_batched.main(["--requests", "2", "--new-tokens", "3",
                                  "--device", "cpu"])
    assert sorted(out) == [0, 1] and "tok/s" in capsys.readouterr().out


def test_isl_exchange_example(capsys):
    """Both runs replay on the NumPy oracle (asserted inside), one host
    sync a revolution, finite losses, and the top-k gossip moves far
    fewer wire bits than the full-float barrier."""
    with one_torch_thread():
        out = isl_exchange.main(["--revolutions", "1", "--sats", "4",
                                 "--device", "cpu"])
    text = capsys.readouterr().out
    sync, gossip = out["sync full-float barrier"], out["async top-k 1% gossip"]
    for r in (sync, gossip):
        assert np.isfinite(r["final_loss"]) and r["host_syncs"] == 1
        assert r["contacts"] > 0 and r["wire_bits"] > 0 and r["isl_j"] > 0
    assert sync["wire_bits"] > 10 * gossip["wire_bits"]
    assert "oracle parity bit-exact" in text and "wire bits, sync" in text


@pytest.mark.parametrize("module", [quickstart, constellation_online_learning,
                                    serve_batched, isl_exchange])
def test_examples_run_on_the_card_unless_the_cpu_is_asked(monkeypatch,
                                                          module):
    """Without a card and without ``--device cpu`` each example raises
    before it computes anything; there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])
