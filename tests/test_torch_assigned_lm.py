"""The port's LM at the smoke configs of the five architectures that
share GQA attention at head dim 128 at full width (Llama-3-8B,
InternLM2-20B, Mixtral-8x7B, Phi-3.5-MoE, Qwen2-VL-7B) against
``repro.models.lm`` on the CPU in f32, from the reference's own weights
carried across by ``from_jax_params``: prefill logits, MoE aux and
caches, one decode step and one split decode step, ``forward_segment``,
``lm.loss`` and its gradients under every remat mode (Qwen2-VL with a
vision prefix), Mixtral's sliding-window decode ring wrapping, both MoE
dispatch layouts, the serving and training CLIs at smoke size, the
parameter counts and ``lm_plan``, and the ten assigned configs at their
published widths. What of Whisper (enc-dec) stays refused: split serving
and the engines (tests/test_torch_whisper.py holds the rest)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, np32, one_torch_thread
from repro import configs as jconfigs
from repro.core import splitting as jsplitting
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro_torch import configs
from repro_torch.core import splitting
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params, map_tree
from repro_torch.utils.treeutil import tree_flatten_with_names, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=5e-4)
S_MAX = 24
NEW = ("llama3_8b", "internlm2_20b", "mixtral_8x7b", "phi35_moe",
       "qwen2_vl_7b")
MOE = ("mixtral_8x7b", "phi35_moe")


def _port(jtree):
    return from_jax_params(jax_tree_to_numpy(jtree))


def _assert_trees_close(got, want, **tol):
    """A port tree of tensors against a reference tree, leaf by leaf."""
    g = dict(tree_flatten_with_names(got))
    w = dict(tree_flatten_with_names(_port(want)))
    assert g.keys() == w.keys()
    for name in g:
        assert tuple(g[name].shape) == tuple(w[name].shape), name
        np.testing.assert_allclose(np32(g[name]), np32(w[name]),
                                   err_msg=name, **tol)


def _frontend(cfg, B, seed=5):
    """A vision prefix (B, frontend_len, d) for Qwen2-VL, else None."""
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.frontend_len, cfg.d_model)) \
        .astype(np.float32) * 0.1


@pytest.fixture(scope="module", params=NEW)
def model(request):
    name = request.param
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jlm.init(jcfg, jax.random.key(0))
    params = _port(jparams)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, jaux, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                         ctx=jctx, remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, aux, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                     ctx=ctx)
    return dict(name=name, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params, tokens=tokens, jlogits=jlogits, jaux=jaux,
                jcaches=jcaches, logits=logits, aux=aux, caches=caches)


def _decode_inputs(m, s_max=S_MAX):
    jcache = jlm.cache_from_prefill(m["jcfg"], m["jcaches"], s_max,
                                    jnp.float32)
    cache = lm.cache_from_prefill(m["cfg"], m["caches"], s_max, torch.float32)
    nxt = np.array([[5], [7]], np.int32)
    pos = np.array([9, 6], np.int32)
    return jcache, cache, nxt, pos


def test_params_carry_across_leaf_by_leaf(model):
    """from_jax_params gives the port's own tree: the same names and
    shapes as lm.abstract_params (router, expert wi/wo stacked per unit),
    and the reference's values."""
    m = model
    spec = dict(tree_flatten_with_names(lm.abstract_params(m["cfg"])))
    got = dict(tree_flatten_with_names(m["params"]))
    want = dict(tree_flatten_with_names(jax_tree_to_numpy(m["jparams"])))
    assert got.keys() == spec.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == spec[name].shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
    if m["name"] in MOE:
        E, d, f = m["cfg"].n_experts, m["cfg"].d_model, m["cfg"].d_ff
        assert tuple(got["units.0:moe.mlp.wi"].shape) == (2, E, d, 2 * f)
        assert tuple(got["units.0:moe.mlp.router"].shape) == (2, d, E)


def test_prefill_logits_aux_and_caches(model):
    m = model
    assert m["logits"].dtype == torch.float32
    np.testing.assert_allclose(np32(m["logits"]), np32(m["jlogits"]), **TOL)
    np.testing.assert_allclose(float(m["aux"]), float(m["jaux"]), **TOL)
    assert (float(m["aux"]) > 0) == (m["name"] in MOE)
    _assert_trees_close(m["caches"], m["jcaches"], **TOL)


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
    _assert_trees_close(new, jnew, **TOL)


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
    _assert_trees_close(new, jnew, **TOL)
    # the port's split step equals its own unsplit step exactly
    full_logits, full_new = lm.decode_step(
        m["cfg"], m["params"], full_cache, torch.from_numpy(nxt),
        torch.from_numpy(pos), ctx=ctx)
    torch.testing.assert_close(logits, full_logits, atol=0, rtol=0)
    for (name, a), (_, b) in zip(tree_flatten_with_names(new),
                                 tree_flatten_with_names(full_new)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_forward_segment(model):
    m = model
    jctx = JCtx(cfg=m["jcfg"], mesh=None, act_dtype=jnp.float32)
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    tokens = m["tokens"]
    jz = jlm.forward_segment(m["jcfg"], m["jparams"], None, 0, 1, ctx=jctx,
                             tokens=jnp.asarray(tokens))
    z = lm.forward_segment(m["cfg"], m["params"], None, 0, 1, ctx=ctx,
                           tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(np32(z), np32(jz), atol=1e-5, rtol=1e-5)
    n = lm.n_blocks(m["cfg"])
    jl = jlm.forward_segment(m["jcfg"], m["jparams"], jz, 1, n, ctx=jctx)
    lg = lm.forward_segment(m["cfg"], m["params"], z, 1, n, ctx=ctx)
    np.testing.assert_allclose(np32(lg), np32(jl), **TOL)


@pytest.fixture(scope="module", params=NEW)
def smoke(request):
    """The reference's loss and gradients (remat none) on a batch with
    padding; Qwen2-VL's with a vision prefix."""
    name = request.param
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jlm.init(jcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels[1, -3:] = -1                                  # padding
    front = _frontend(cfg, 2)
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)
    jfront = None if front is None else jnp.asarray(front)
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels),
                           ctx=jctx, frontend_embed=jfront, remat="none"),
        has_aux=True)(jparams)
    return dict(name=name, cfg=cfg, jparams=jparams, tokens=tokens,
                labels=labels, front=front, jv=jv, jm=jm, jg=jg)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_vs_reference(smoke, remat):
    m = smoke
    params = _port(m["jparams"])
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_names(params)]
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    front = None if m["front"] is None else torch.from_numpy(m["front"])
    with one_torch_thread():
        v, metrics = lm.loss(m["cfg"], params, torch.from_numpy(m["tokens"]),
                             torch.from_numpy(m["labels"]), ctx=ctx,
                             frontend_embed=front, remat=remat)
        grads = torch.autograd.grad(v, leaves)
    np.testing.assert_allclose(float(v.detach()), float(m["jv"]), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(m["jm"][key]), rtol=1e-5, atol=1e-7)
    # Qwen2-VL's loss leaves out the 8 prefix positions of both rows
    want_ntok = 21 - (2 * m["cfg"].frontend_len if m["front"] is not None
                      else 0)
    assert int(metrics["ntok"]) == int(m["jm"]["ntok"]) == want_ntok
    _assert_trees_close(tree_unflatten(params, grads), m["jg"], **GRAD)
    if m["name"] in MOE:                  # router and experts learn
        g = dict(tree_flatten_with_names(tree_unflatten(params, grads)))
        for leaf in ("router", "wi", "wo"):
            assert bool((g[f"units.0:moe.mlp.{leaf}"] != 0).any()), leaf


def test_qwen2_vl_vision_prefix_prefill():
    """A vision prefix: its embeddings replace the first frontend_len
    tokens', and M-RoPE gives those positions grid ids, so the logits
    differ from a text-only prompt's and match the reference's."""
    jcfg, cfg = jconfigs.get_smoke("qwen2_vl_7b"), \
        configs.get_smoke("qwen2_vl_7b")
    jparams = jlm.init(jcfg, jax.random.key(3))
    params = _port(jparams)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12)) \
        .astype(np.int32)
    front = _frontend(cfg, 2)
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                      ctx=jctx,
                                      frontend_embed=jnp.asarray(front),
                                      remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, _, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                   ctx=ctx,
                                   frontend_embed=torch.from_numpy(front))
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    _assert_trees_close(caches, jcaches, **TOL)
    text, _, _ = lm.forward(cfg, params, torch.from_numpy(tokens), ctx=ctx)
    assert not torch.allclose(text[:, cfg.frontend_len:],
                              logits[:, cfg.frontend_len:])
    # the grid ids alone (same embeddings) change the logits too
    embeds = params["embed"][torch.from_numpy(tokens[:, :cfg.frontend_len])
                             .long()]
    grid, _, _ = lm.forward(cfg, params, torch.from_numpy(tokens), ctx=ctx,
                            frontend_embed=embeds)
    assert not torch.allclose(grid, text)


def test_mixtral_window_ring_wraps():
    """Mixtral's smoke window (32) with a 40-token prompt and s_max 48:
    the prefill cache scatters the last 32 positions into their ring
    slots, and four decode steps write past the ring's end, against the
    reference step by step."""
    jcfg, cfg = jconfigs.get_smoke("mixtral_8x7b"), \
        configs.get_smoke("mixtral_8x7b")
    assert cfg.window == 32
    jparams = jlm.init(jcfg, jax.random.key(6))
    params = _port(jparams)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                      ctx=jctx, remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, _, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                   ctx=ctx)
    np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
    jcache = jlm.cache_from_prefill(jcfg, jcaches, 48, jnp.float32)
    cache = lm.cache_from_prefill(cfg, caches, 48, torch.float32)
    assert tuple(cache["0:moe"]["attn"]["k"].shape)[3] == 32    # s_eff
    _assert_trees_close(cache, jcache, **TOL)
    jdctx = JCtx(cfg=jcfg, mode="decode", act_dtype=jnp.float32)
    dctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.float32)
    pos = np.array([40, 40], np.int32)
    nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jcache = jlm.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                     jnp.asarray(pos), ctx=jdctx)
        tl, cache = lm.decode_step(cfg, params, cache, torch.from_numpy(nxt),
                                   torch.from_numpy(pos), ctx=dctx)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        _assert_trees_close(cache, jcache, **TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("name", MOE)
def test_batch_local_dispatch_vs_reference(name):
    """The whole forward with ``moe_dispatch="batch_local"`` and a
    capacity that drops tokens."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), capacity_factor=0.5)
    cfg = dataclasses.replace(configs.get_smoke(name), capacity_factor=0.5)
    jparams = jlm.init(jcfg, jax.random.key(8))
    params = _port(jparams)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (3, 10)) \
        .astype(np.int32)
    for dispatch in ("global", "batch_local"):
        jctx = JCtx(cfg=jcfg, act_dtype=jnp.float32, moe_dispatch=dispatch)
        ctx = Ctx(cfg=cfg, act_dtype=torch.float32, moe_dispatch=dispatch)
        jlogits, jaux, _ = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                       ctx=jctx, remat="none")
        logits, aux, _ = lm.forward(cfg, params, torch.from_numpy(tokens),
                                    ctx=ctx)
        np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dispatch", ["global", "batch_local"])
def test_train_step_takes_moe_dispatch(name, dispatch):
    """TrainConfig.moe_dispatch reaches the blocks: the step's loss is the
    reference's lm.loss under that layout."""
    from repro_torch.train.step import TrainConfig, loss_and_grads
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), capacity_factor=0.5)
    cfg = dataclasses.replace(configs.get_smoke(name), capacity_factor=0.5)
    jparams = jlm.init(jcfg, jax.random.key(10))
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (3, 11)) \
        .astype(np.int32)
    jv, _ = jlm.loss(jcfg, jparams, jnp.asarray(toks[:, :-1]),
                     jnp.asarray(toks[:, 1:]),
                     ctx=JCtx(cfg=jcfg, act_dtype=jnp.float32,
                              moe_dispatch=dispatch), remat="none")
    tcfg = TrainConfig(act_dtype=torch.float32, remat="none",
                       moe_dispatch=dispatch)
    with one_torch_thread():
        v, metrics, grads = loss_and_grads(
            cfg, tcfg, _port(jparams),
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)


@pytest.mark.parametrize("name", NEW)
def test_serve_cli_split_on_the_cpu(name):
    from repro_torch.launch import serve
    with one_torch_thread():
        out = serve.main(["--arch", name, "--requests", "3",
                          "--new-tokens", "3", "--cut", "1",
                          "--device", "cpu"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 3 for t in out.values())


@pytest.mark.parametrize("name", NEW)
def test_train_cli_smoke_on_the_cpu(name):
    from repro_torch.launch import train
    with one_torch_thread():
        losses = train.main(["--arch", name, "--smoke", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--log-every",
                             "1", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("name", NEW)
def test_counts_flops_and_lm_plan_vs_reference(name):
    jcfg, cfg = jconfigs.get(name), configs.get(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for kind in set(cfg.block_kinds()):
        assert cfg.block_param_count(kind) == jcfg.block_param_count(kind)
        assert (cfg.block_active_param_count(kind)
                == jcfg.block_active_param_count(kind))
    plan, jplan = splitting.lm_plan(cfg, 512), jsplitting.lm_plan(jcfg, 512)
    assert [(l.name, l.fwd_flops, l.param_bytes, l.out_bits)
            for l in plan.layers] == [(l.name, l.fwd_flops, l.param_bytes,
                                       l.out_bits) for l in jplan.layers]


ASSIGNMENT = {
    "xlstm_1_3b": (48, 2048, 4, 4, 0, 50304),
    "granite_3_2b": (40, 2048, 32, 8, 8192, 49155),
    "llama3_8b": (32, 4096, 32, 8, 14336, 128256),
    "smollm_360m": (32, 960, 15, 5, 2560, 49152),
    "internlm2_20b": (48, 6144, 48, 8, 16384, 92544),
    "phi35_moe": (32, 4096, 32, 8, 6400, 32064),
    "mixtral_8x7b": (32, 4096, 32, 8, 14336, 32000),
    "qwen2_vl_7b": (28, 3584, 28, 4, 18944, 152064),
    "zamba2_1_2b": (36, 2048, 32, 32, 8192, 32000),
    "whisper_small": (12, 768, 12, 12, 3072, 51865),
}


@pytest.mark.parametrize("name", configs.ASSIGNED)
def test_arch_full_config_matches_assignment(name):
    cfg = configs.get(name)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == ASSIGNMENT[name]
    # the port's copy holds the reference's values, field by field
    asdict = dataclasses.asdict
    assert asdict(cfg) == asdict(jconfigs.get(name))
    assert asdict(configs.get_smoke(name)) == asdict(jconfigs.get_smoke(name))


def test_assigned_lists_and_all_assigned():
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert configs.PAPER_MODELS == jconfigs.PAPER_MODELS
    got = configs.all_assigned()
    assert list(got) == configs.ASSIGNED
    assert all(dataclasses.asdict(got[n]) == dataclasses.asdict(
        jconfigs.get(n)) for n in got)


def test_mixtral_published_layer_and_depth_cut():
    """The reference's formula at Mixtral's published widths: 1,451,270,144
    parameters a layer, more than 80 GB in bf16 at 32 layers; 16 layers
    (the card's serving cell) fit."""
    cfg = configs.get("mixtral_8x7b")
    assert cfg.block_param_count("moe") == 1_451_270_144
    assert 2 * cfg.param_count() > 80e9
    half = dataclasses.replace(cfg, n_layers=16)
    assert 2 * half.param_count() < 48e9


def test_whisper_is_still_refused():
    """What of Whisper stays refused, as in the reference: split serving
    and the serving engines. Its parameters and decode caches are built
    (tests/test_torch_whisper.py holds them to the reference)."""
    from repro_torch.serve.engine import DecodeEngine
    cfg = configs.get_smoke("whisper_small")
    assert cfg.enc_dec
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    assert "enc_units" in params and "cross" in params["units"]["0:attn"]
    cache = lm.init_cache(cfg, 1, 8, torch.float32, "cpu")
    assert set(cache["0:attn"]) == {"attn", "cross"}
    with pytest.raises(NotImplementedError, match="enc-dec"):
        lm.split_serve_params(cfg, params, 1)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        DecodeEngine(cfg, params, n_slots=1, s_max=8, device="cpu")


def test_engine_casts_the_router_and_keeps_the_norms_f32():
    """The reference reads the router with ``.astype(dt)``, so the engine
    casts it with the other matmul weights (F32_LEAVES keeps only what
    the reference reads in f32)."""
    from repro_torch.serve.engine import DecodeEngine
    cfg = configs.get_smoke("mixtral_8x7b")
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    eng = DecodeEngine(cfg, params, n_slots=1, s_max=8,
                       act_dtype=torch.bfloat16, device="cpu")
    blk = eng.params["units"]["0:moe"]
    assert all(blk["mlp"][k].dtype == torch.bfloat16
               for k in ("router", "wi", "wo"))
    assert blk["norm1"]["scale"].dtype == torch.float32
    assert blk["norm2"]["scale"].dtype == torch.float32
