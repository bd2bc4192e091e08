"""The port's dense LM against ``repro.models.lm`` at the SmolLM smoke
config in f32, from the reference's own weights: prefill logits and
caches, the decode cache, one decode step, and the split decode step."""
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
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params, map_tree

TOL = dict(atol=1e-4, rtol=1e-4)
S_MAX = 24


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke("smollm_360m")
    cfg = configs.get_smoke("smollm_360m")
    jparams = jlm.init(jcfg, jax.random.key(0))
    params = from_jax_params(jax_tree_to_numpy(jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                      ctx=jctx, remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, _, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                   ctx=ctx)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                tokens=tokens, jlogits=jlogits, jcaches=jcaches,
                logits=logits, caches=caches)


def _decode_inputs(m):
    """The prefill caches as decode caches (both packages), plus the next
    tokens and ragged positions (row 1 rewinds three positions)."""
    jcache = jlm.cache_from_prefill(m["jcfg"], m["jcaches"], S_MAX,
                                    jnp.float32)
    cache = lm.cache_from_prefill(m["cfg"], m["caches"], S_MAX, torch.float32)
    nxt = np.array([[5], [7]], np.int32)
    pos = np.array([9, 6], np.int32)
    return jcache, cache, nxt, pos


def test_prefill_logits_and_caches(model):
    m = model
    assert m["logits"].dtype == torch.float32
    np.testing.assert_allclose(np32(m["logits"]), np32(m["jlogits"]), **TOL)
    for name in ("k", "v"):
        got = m["caches"]["0:attn"]["attn"][name]
        want = m["jcaches"]["0:attn"]["attn"][name]
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_cache_from_prefill(model, window):
    m = model
    jcfg = dataclasses.replace(m["jcfg"], window=window)
    cfg = dataclasses.replace(m["cfg"], window=window)
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((2, 2, 1, 9, 32)).astype(np.float32)
    jc = {"0:attn": {"attn": {"k": jnp.asarray(kv), "v": jnp.asarray(-kv)}}}
    tc = {"0:attn": {"attn": {"k": torch.from_numpy(kv),
                              "v": torch.from_numpy(-kv)}}}
    want = jlm.cache_from_prefill(jcfg, jc, S_MAX, jnp.float32)
    got = lm.cache_from_prefill(cfg, tc, S_MAX, torch.float32)
    for name in ("k", "v"):
        np.testing.assert_array_equal(np32(got["0:attn"]["attn"][name]),
                                      np32(want["0:attn"]["attn"][name]))


def test_decode_step(model):
    m = model
    jcache, cache, nxt, pos = _decode_inputs(m)
    jctx = JCtx(cfg=m["jcfg"], mode="decode", act_dtype=jnp.float32)
    jlogits, jnew = jlm.decode_step(m["jcfg"], m["jparams"], jcache,
                                    jnp.asarray(nxt), jnp.asarray(pos),
                                    ctx=jctx)
    ctx = Ctx(cfg=m["cfg"], mode="decode", act_dtype=torch.float32)
    logits, new = lm.decode_step(m["cfg"], m["params"], cache,
                                 torch.from_numpy(nxt), torch.from_numpy(pos),
                                 ctx=ctx)
    assert tuple(logits.shape) == (2, 1, m["cfg"].vocab)
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(new["0:attn"]["attn"][name]),
                                   np32(jnew["0:attn"]["attn"][name]), **TOL)


def test_decode_step_split(model):
    m = model
    jcache, cache, nxt, pos = _decode_inputs(m)
    jctx = JCtx(cfg=m["jcfg"], mode="decode", act_dtype=jnp.float32)
    jpa, jpb = jlm.split_serve_params(m["jcfg"], m["jparams"], 1)
    jlogits, jnew, jbound = jlm.decode_step_split(
        m["jcfg"], jpa, jpb, jcache, jnp.asarray(nxt), jnp.asarray(pos),
        ctx=jctx)
    ctx = Ctx(cfg=m["cfg"], mode="decode", act_dtype=torch.float32)
    pa, pb = lm.split_serve_params(m["cfg"], m["params"], 1)
    full_cache = map_tree(torch.clone, cache)
    logits, new, bound = lm.decode_step_split(
        m["cfg"], pa, pb, cache, torch.from_numpy(nxt), torch.from_numpy(pos),
        ctx=ctx)
    assert tuple(bound.shape) == (2, 1, m["cfg"].d_model)
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    np.testing.assert_allclose(np32(bound), np32(jbound), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(new["0:attn"]["attn"][name]),
                                   np32(jnew["0:attn"]["attn"][name]), **TOL)
    # the port's split step equals its own unsplit step
    full_logits, full_new = lm.decode_step(
        m["cfg"], m["params"], full_cache, torch.from_numpy(nxt),
        torch.from_numpy(pos), ctx=ctx)
    torch.testing.assert_close(logits, full_logits, atol=0, rtol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(new["0:attn"]["attn"][name],
                                   full_new["0:attn"]["attn"][name],
                                   atol=0, rtol=0)


def test_split_rejects_bad_cut(model):
    with pytest.raises(ValueError, match="cut_units"):
        lm.split_serve_params(model["cfg"], model["params"], 2)
