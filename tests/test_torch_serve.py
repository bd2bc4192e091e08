"""The port's serving engines against the JAX engines, token for token,
at the SmolLM smoke config in f32 from the reference's weights: FIFO
refill of 3 slots by 5 requests, bulk against loop prefill, the split
engine, and the reference's edge cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import Request as JRequest
from repro.serve_fleet.engine import SplitDecodeEngine as JSplitDecodeEngine
from repro_torch import configs
from repro_torch.models.param import from_jax_params
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve_fleet.engine import (SplitDecodeEngine,
                                            measure_decode_rate)

KW = dict(n_slots=3, s_max=32)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("smollm_360m")
    jparams = jlm.init(jcfg, jax.random.key(0))
    return (jcfg, jparams, configs.get_smoke("smollm_360m"),
            from_jax_params(jax_tree_to_numpy(jparams)))


def _prompts(n=5, seed=0):
    """Prompts of lengths 3..7 so the slots finish at different steps."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, 3 + i).astype(np.int32) for i in range(n)]


def _port(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=torch.float32, device="cpu",
                     **{**KW, **kw})
    return eng.submit_and_run([Request(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


def _jax(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=jnp.float32, **{**KW, **kw})
    return eng.submit_and_run([JRequest(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


@pytest.mark.parametrize("prefill", ["bulk", "loop"])
def test_engine_matches_jax(model, prefill):
    jcfg, jparams, cfg, params = model
    prompts = _prompts()
    got = _port(DecodeEngine, cfg, params, prompts, prefill=prefill)
    assert set(got) == set(range(5)) and all(len(v) == 6 for v in got.values())
    assert got == _jax(JDecodeEngine, jcfg, jparams, prompts, prefill=prefill)


def test_split_engine_matches_jax_and_unsplit(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts(seed=1)
    got = _port(SplitDecodeEngine, cfg, params, prompts, cut_units=1)
    assert got == _jax(JSplitDecodeEngine, jcfg, jparams, prompts,
                       cut_units=1)
    assert got == _port(DecodeEngine, cfg, params, prompts)


def test_bulk_prefill_matches_loop_reference(model):
    _, _, cfg, params = model
    prompts = _prompts(seed=2)
    assert (_port(DecodeEngine, cfg, params, prompts, prefill="bulk")
            == _port(DecodeEngine, cfg, params, prompts, prefill="loop"))


def test_more_requests_than_slots_fifo_refill(model):
    _, _, cfg, params = model
    filled = []

    class Tracing(DecodeEngine):
        def _prefill_into_slot(self, slot, req):
            filled.append(req.rid)
            super()._prefill_into_slot(slot, req)

    prompts = _prompts(seed=3)
    out = _port(Tracing, cfg, params, prompts, new=3, n_slots=1)
    assert filled == [0, 1, 2, 3, 4]             # FIFO refill order
    for i, p in enumerate(prompts):              # each equals its solo run
        assert _port(DecodeEngine, cfg, params, [p], new=3)[0] == out[i]


# --------------------------------------------------------------------------
# Edge cases (the reference's, tests/test_serve_engine.py).
# --------------------------------------------------------------------------

def test_zero_new_tokens_completes_immediately(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts(3)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=0 if i == 1 else 6)
            for i, p in enumerate(prompts)]
    eng = DecodeEngine(cfg, params, act_dtype=torch.float32, device="cpu",
                       n_slots=2, s_max=32)
    out = eng.submit_and_run(reqs)
    assert out[1] == [] and len(out[0]) == 6 and len(out[2]) == 6
    jeng = JDecodeEngine(jcfg, jparams, act_dtype=jnp.float32, n_slots=2,
                         s_max=32)
    assert out == jeng.submit_and_run(
        [JRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs])


def test_all_zero_budget_and_empty_request_list(model):
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, act_dtype=torch.float32, device="cpu",
                       n_slots=2, s_max=32)
    assert eng.submit_and_run([]) == {}
    out = eng.submit_and_run([Request(rid=i, prompt=p, max_new_tokens=0)
                              for i, p in enumerate(_prompts(2))])
    assert out == {0: [], 1: []}


def test_prompt_at_least_s_max_raises(model):
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, act_dtype=torch.float32, device="cpu",
                       n_slots=1, s_max=8)
    with pytest.raises(ValueError, match="s_max"):
        eng.submit_and_run([Request(rid=0, prompt=np.zeros(8, np.int32))])


def test_split_engine_payload_and_rate(model):
    jcfg, jparams, cfg, params = model
    eng = SplitDecodeEngine(cfg, params, cut_units=1, device="cpu",
                            act_dtype=torch.bfloat16, n_slots=2, s_max=32)
    jeng = JSplitDecodeEngine(jcfg, jparams, cut_units=1,
                              act_dtype=jnp.bfloat16, n_slots=2, s_max=32)
    assert eng.boundary_bits_per_token == jeng.boundary_bits_per_token
    assert measure_decode_rate(eng, n_requests=2, new_tokens=2) > 0
    with pytest.raises(ValueError, match="cut_units"):
        SplitDecodeEngine(cfg, params, cut_units=0, device="cpu")
