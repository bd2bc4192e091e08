"""The port's hybrid LM (Mamba-2 blocks + Zamba2's shared attention
block) against ``repro.models.lm`` at the Zamba2 smoke config in f32,
from the reference's own weights: prefill logits and caches (a 2-token
prompt included), the decode cache, one decode step, and the split
decode step."""
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
from repro_torch.utils.treeutil import tree_flatten_with_names

TOL = dict(atol=1e-4, rtol=1e-4)
S_MAX = 24
ARCH = "zamba2_1_2b"


def _prefill(jcfg, jparams, cfg, params, tokens):
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                      ctx=jctx, remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, _, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                   ctx=ctx)
    return jlogits, jcaches, logits, caches


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke(ARCH)
    cfg = configs.get_smoke(ARCH)
    jparams = jlm.init(jcfg, jax.random.key(0))
    params = from_jax_params(jax_tree_to_numpy(jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jlogits, jcaches, logits, caches = _prefill(jcfg, jparams, cfg, params,
                                                tokens)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                tokens=tokens, jlogits=jlogits, jcaches=jcaches,
                logits=logits, caches=caches)


def _assert_trees_close(got, want, **tol):
    """Every leaf of the port's cache tree against the reference's."""
    g = dict(tree_flatten_with_names(got))
    w = dict(tree_flatten_with_names(jax_tree_to_numpy(want)))
    assert g.keys() == w.keys()
    for name, leaf in w.items():
        assert tuple(g[name].shape) == leaf.shape, name
        np.testing.assert_allclose(np32(g[name]), leaf, err_msg=name,
                                   **(tol or TOL))


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
    assert set(m["caches"]) == {"0:mamba2", "1:shared_attn"}
    _assert_trees_close(m["caches"], m["jcaches"])


@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompt_prefill(model, S):
    """Prompts shorter than the conv's 3-token tail."""
    m = model
    tokens = m["tokens"][:, :S]
    jlogits, jcaches, logits, caches = _prefill(m["jcfg"], m["jparams"],
                                                m["cfg"], m["params"], tokens)
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    _assert_trees_close(caches, jcaches)


def test_cache_from_prefill(model):
    jcache, cache, _, _ = _decode_inputs(model)
    _assert_trees_close(cache, jcache)
    # the recurrent states pass through as copies (decode updates them in
    # place); attention K/V pad to S_MAX
    h, h_prefill = (c["0:mamba2"]["mamba"]["h"]
                    for c in (cache, model["caches"]))
    assert torch.equal(h, h_prefill) and h.data_ptr() != h_prefill.data_ptr()
    assert cache["1:shared_attn"]["attn"]["k"].shape[3] == S_MAX


def test_init_cache_matches_reference_layout(model):
    jc = jlm.init_cache(model["jcfg"], 3, S_MAX, jnp.bfloat16)
    c = lm.init_cache(model["cfg"], 3, S_MAX, torch.bfloat16, "cpu")
    g, w = dict(tree_flatten_with_names(c)), dict(
        tree_flatten_with_names(jax_tree_to_numpy(jc)))
    assert g.keys() == w.keys()
    for name, leaf in w.items():
        assert tuple(g[name].shape) == leaf.shape, name
        assert g[name].dtype == (torch.float32 if leaf.dtype == np.float32
                                 else torch.bfloat16), name
        assert not g[name].any(), name


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
    _assert_trees_close(new, jnew)


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
    assert pa["shared"] is m["params"]["shared"] is pb["shared"]
    full_cache = map_tree(torch.clone, cache)
    logits, new, bound = lm.decode_step_split(
        m["cfg"], pa, pb, cache, torch.from_numpy(nxt), torch.from_numpy(pos),
        ctx=ctx)
    assert tuple(bound.shape) == (2, 1, m["cfg"].d_model)
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    np.testing.assert_allclose(np32(bound), np32(jbound), **TOL)
    _assert_trees_close(new, jnew)
    # the port's split step equals its own unsplit step exactly
    full_logits, full_new = lm.decode_step(
        m["cfg"], m["params"], full_cache, torch.from_numpy(nxt),
        torch.from_numpy(pos), ctx=ctx)
    torch.testing.assert_close(logits, full_logits, atol=0, rtol=0)
    for (name, a), (_, b) in zip(tree_flatten_with_names(new),
                                 tree_flatten_with_names(full_new)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_split_rejects_bad_cut(model):
    for cut in (0, 2):
        with pytest.raises(ValueError, match="cut_units"):
            lm.split_serve_params(model["cfg"], model["params"], cut)


@pytest.mark.parametrize("refused", ["enc_dec", "enc_frames"])
def test_unported_blocks_raise(model, refused):
    """What the port once refused, now as the reference does it: an
    enc-dec variant of the hybrid config builds the reference's tree
    (cross-attention in the shared block, an encoder stack), and encoder
    frames given to a decoder-only config are ignored."""
    if refused == "enc_dec":
        cfg = dataclasses.replace(model["cfg"], enc_dec=True, n_enc_layers=1)
        jcfg = dataclasses.replace(model["jcfg"], enc_dec=True,
                                   n_enc_layers=1)
        got = {n: s.shape for n, s in
               tree_flatten_with_names(lm.abstract_params(cfg))}
        want = {n: s.shape for n, s in
                tree_flatten_with_names(jlm.abstract_params(jcfg))}
        assert got == want and "shared.cross.wq" in got
        assert "units.0:mamba2.cross.wq" not in got
        return
    cfg = model["cfg"]
    frames = torch.zeros((2, 4, cfg.d_model))
    ctx = Ctx(cfg=cfg, act_dtype=torch.float32)
    tokens = torch.from_numpy(model["tokens"])
    got, _, _ = lm.forward(cfg, model["params"], tokens, ctx=ctx,
                           enc_frames=frames)
    want, _, _ = lm.forward(cfg, model["params"], tokens, ctx=ctx)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
