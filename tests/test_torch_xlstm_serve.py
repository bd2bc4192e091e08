"""The port's serving engines on xLSTM (mLSTM and sLSTM blocks) against
the JAX engines in f32 from the reference's weights, at a two-unit
variant of the smoke config (eight layers, so the model can be cut):
unsplit and split at unit 1, bulk prefill that leaves other slots'
recurrent state alone, the loop prefill, the engine's weight cast in
bf16 (the leaves the reference reads in f32 stay f32), and the serving
CLI on the smoke config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, np32
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import Request as JRequest
from repro.serve_fleet.engine import SplitDecodeEngine as JSplitDecodeEngine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params
from repro_torch.serve.engine import (F32_LEAVES, DecodeEngine, Request,
                                      _cast_matmul_weights)
from repro_torch.serve_fleet.engine import SplitDecodeEngine

ARCH = "xlstm_1_3b"
TWO_UNITS = dict(n_layers=8)
KW = dict(n_slots=3, s_max=32)


def _tree(seed=0):
    """The reference's two-unit weights as numpy, with the gate bias
    b_if and the sLSTM bias drawn off their zero init so that rounding
    them would show."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), **TWO_UNITS)
    tree = jax_tree_to_numpy(jlm.init(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 5)
    for key, sub, name in (("0:mlstm", "mlstm", "b_if"),
                           ("3:slstm", "slstm", "bias")):
        leaf = tree["units"][key][sub]
        leaf[name] = (rng.standard_normal(leaf[name].shape) * 0.5).astype(
            np.float32)
    return tree


@pytest.fixture(scope="module")
def model():
    tree = _tree()
    return (dataclasses.replace(jconfigs.get_smoke(ARCH), **TWO_UNITS),
            jax.tree.map(jnp.asarray, tree),
            dataclasses.replace(configs.get_smoke(ARCH), **TWO_UNITS),
            from_jax_params(tree))


def _prompts(n=5, seed=0):
    """Prompts of lengths 2..6 so the slots finish at different steps."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, 2 + i).astype(np.int32) for i in range(n)]


def _port(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=torch.float32, device="cpu",
                     **{**KW, **kw})
    return eng.submit_and_run([Request(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


def _jax(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=jnp.float32, **{**KW, **kw})
    return eng.submit_and_run([JRequest(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


def test_engine_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts()
    got = _port(DecodeEngine, cfg, params, prompts)
    assert set(got) == set(range(5)) and all(len(v) == 6 for v in got.values())
    assert got == _jax(JDecodeEngine, jcfg, jparams, prompts)


def test_split_engine_matches_jax_and_unsplit(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts(seed=1)
    got = _port(SplitDecodeEngine, cfg, params, prompts, cut_units=1)
    assert got == _jax(JSplitDecodeEngine, jcfg, jparams, prompts,
                       cut_units=1)
    assert got == _port(DecodeEngine, cfg, params, prompts)


def test_bulk_prefill_isolates_recurrent_slots(model):
    """Multi-slot output == one-request-at-a-time output: bulk prefill
    leaves the other live slots' mLSTM and sLSTM states untouched."""
    _, _, cfg, params = model
    prompts = _prompts(3, seed=2)
    solo = {}
    for i, p in enumerate(prompts):
        solo[i] = _port(DecodeEngine, cfg, params, [p], new=4, n_slots=1)[0]
    assert _port(DecodeEngine, cfg, params, prompts, new=4) == solo


def test_loop_prefill_matches_jax_loop(model):
    """The token-by-token prefill equals the reference's own loop token
    for token (like Zamba2's, it carries a refilled slot's recurrent
    state into the next request in both packages)."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(3, seed=4)
    got = _port(DecodeEngine, cfg, params, prompts, n_slots=1,
                prefill="loop")
    assert got == _jax(JDecodeEngine, jcfg, jparams, prompts, n_slots=1,
                       prefill="loop")


def test_bf16_engine_keeps_f32_leaves_and_matches_reference(model):
    jcfg, jparams, cfg, params = model
    eng = DecodeEngine(cfg, params, act_dtype=torch.bfloat16, device="cpu",
                       **KW)
    mlstm = eng.params["units"]["0:mlstm"]["mlstm"]
    slstm = eng.params["units"]["3:slstm"]["slstm"]
    assert "b_if" in F32_LEAVES and mlstm["b_if"].dtype == torch.float32
    assert torch.equal(mlstm["b_if"], params["units"]["0:mlstm"]["mlstm"]
                       ["b_if"])
    for name in ("w_x", "w_h", "bias"):
        assert ("slstm", name) in F32_LEAVES
        assert slstm[name].dtype == torch.float32
        assert torch.equal(slstm[name],
                           params["units"]["3:slstm"]["slstm"][name])
    for name in ("w_qkv", "w_if", "w_out"):          # cast at use, as bf16
        assert mlstm[name].dtype == torch.bfloat16, name
    assert eng.params["final_norm"]["scale"].dtype == torch.float32

    # bf16 prefill logits. Both packages round activations to bf16, at
    # places that differ (the scans' and the matmuls' f32 sums are taken
    # in other orders), and xLSTM's recurrences amplify where the rounding
    # falls: on these weights the reference's own bf16 logits lie 0.76 of
    # a largest |logit| of 3.9 from its f32 ones (the port's bf16 ones lie
    # 0.25 from the reference's). The port's bf16 logits are held no
    # farther from the reference's bf16 ones than that, and the port's
    # f32 path to the reference's within 1e-4 (test_torch_xlstm_lm.py).
    tokens = np.random.default_rng(3).integers(0, 128, (2, 40)).astype(
        np.int32)
    want, want32 = (np32(jlm.forward(
        jcfg, jparams, jnp.asarray(tokens), remat="none",
        ctx=JCtx(cfg=jcfg, mode="prefill", act_dtype=dt))[0])
        for dt in (jnp.bfloat16, jnp.float32))
    got, _, _ = lm.forward(cfg, eng.params, torch.from_numpy(tokens),
                           ctx=Ctx(cfg=cfg, mode="prefill",
                                   act_dtype=torch.bfloat16))
    assert got.dtype == torch.float32
    assert np.abs(np32(got) - want).max() <= np.abs(want - want32).max()


def test_block_keyed_f32_rule_leaves_other_biases_alone():
    """(block, name) entries of F32_LEAVES match only inside that block:
    a ``bias`` or ``w_h`` elsewhere is cast like any weight."""
    tree = {"slstm": {"bias": torch.ones(4), "w_h": torch.ones(2, 4)},
            "attn": {"bias": torch.ones(4), "w_h": torch.ones(2, 4)},
            "norm": {"scale": torch.ones(4)}}
    got = _cast_matmul_weights(tree, torch.bfloat16, torch.device("cpu"))
    assert got["slstm"]["bias"].dtype == got["slstm"]["w_h"].dtype \
        == torch.float32
    assert got["attn"]["bias"].dtype == got["attn"]["w_h"].dtype \
        == torch.bfloat16
    assert got["norm"]["scale"].dtype == torch.float32


def test_serve_cli_on_the_cpu():
    out = serve.main(["--arch", ARCH, "--requests", "3", "--new-tokens", "3",
                      "--device", "cpu"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(t) == 3 and all(0 <= x < 128 for x in t)
               for t in out.values())


def test_serve_cli_refuses_a_cut_of_the_one_unit_smoke_model():
    with pytest.raises(ValueError, match="cut_units"):
        serve.main(["--arch", ARCH, "--requests", "1", "--new-tokens", "1",
                    "--cut", "1", "--device", "cpu"])
