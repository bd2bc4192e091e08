"""The port's Whisper encoder-decoder at the smoke config against
``repro.models.lm`` on the CPU in f32, from the reference's own weights
carried across by ``from_jax_params``: the parameter tree, prefill
logits and both caches (self-attention and the encoder memory's
cross-attention K/V), a decode step, prefill-then-decode, ``lm.loss``
and its gradients under every remat mode, the sinusoid rows, and
``forward_segment``; the serving steps of ``train.step``; what stays
refused (split serving, the engines, ``launch.serve``); B2's plain
version at Whisper's cross-attention shape (Sq != Skv, non-causal,
values, lse and backward) and B3's over a fixed memory at full length,
against the reference's jnp path and its Pallas kernels in interpret
mode; and the front-end stubs that ``launch.train`` hands its step
(a zero vision prefix for Qwen2-VL, zero encoder frames for Whisper)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, jax_tree_to_numpy, np32, one_torch_thread
from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro_torch import configs
from repro_torch.kernels import decode_attn, flash_attn, ops
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params, map_tree
from repro_torch.utils.treeutil import tree_flatten_with_names, tree_unflatten

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=5e-4)
S_MAX = 24
ARCH = "whisper_small"


def _port(jtree):
    return from_jax_params(jax_tree_to_numpy(jtree))


def _assert_trees_close(got, want, **tol):
    g = dict(tree_flatten_with_names(got))
    w = dict(tree_flatten_with_names(_port(want)))
    assert g.keys() == w.keys()
    for name in g:
        assert tuple(g[name].shape) == tuple(w[name].shape), name
        np.testing.assert_allclose(np32(g[name]), np32(w[name]),
                                   err_msg=name, **tol)


def _frames(cfg, B, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
            * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jparams = jlm.init(jcfg, jax.random.key(0))
    params = _port(jparams)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    frames = _frames(cfg, 2)
    jctx = JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.float32)
    jlogits, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens),
                                      ctx=jctx, enc_frames=jnp.asarray(frames),
                                      remat="none")
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    logits, aux, caches = lm.forward(cfg, params, torch.from_numpy(tokens),
                                     ctx=ctx,
                                     enc_frames=torch.from_numpy(frames))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                tokens=tokens, frames=frames, jlogits=jlogits,
                jcaches=jcaches, logits=logits, aux=aux, caches=caches)


@pytest.mark.parametrize("smoke", [True, False])
def test_params_tree_is_the_references(smoke):
    """The enc-dec tree leaf for leaf: decoder blocks with ``norm_x`` and
    ``cross``, ``enc_units`` stacked n_enc_layers deep, ``enc_norm``; at
    the smoke config and at the published widths (shapes only)."""
    get = jconfigs.get_smoke if smoke else jconfigs.get
    want = {n: s.shape for n, s in
            tree_flatten_with_names(jlm.abstract_params(get(ARCH)))}
    cfg = (configs.get_smoke if smoke else configs.get)(ARCH)
    got = {n: s.shape for n, s in
           tree_flatten_with_names(lm.abstract_params(cfg))}
    assert got == want
    assert {"units.0:attn.cross.wk", "units.0:attn.norm_x.scale",
            "enc_units.0:attn.attn.wq", "enc_norm.scale"} <= set(got)
    assert "enc_units.0:attn.cross.wq" not in got
    assert got["enc_units.0:attn.mlp.wi"][0] == cfg.n_enc_layers
    if not smoke:        # 12 + 12 layers at d 768: about 2.4e8 parameters
        n = sum(int(np.prod(s)) for s in got.values())
        assert 2.3e8 < n < 2.5e8


def test_params_carry_across_leaf_by_leaf(model):
    got = dict(tree_flatten_with_names(model["params"]))
    want = dict(tree_flatten_with_names(jax_tree_to_numpy(model["jparams"])))
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def test_prefill_logits_and_caches(model):
    m = model
    assert m["logits"].dtype == torch.float32
    np.testing.assert_allclose(np32(m["logits"]), np32(m["jlogits"]), **TOL)
    assert float(m["aux"]) == 0.0
    cfg = m["cfg"]
    cross = m["caches"]["0:attn"]["cross"]["k"]
    assert tuple(cross.shape) == (cfg.n_units, 2, cfg.n_kv_heads,
                                  cfg.frontend_len, cfg.head_dim)
    _assert_trees_close(m["caches"], m["jcaches"], **TOL)


def test_forward_needs_enc_frames(model):
    with pytest.raises(ValueError, match="enc_frames"):
        lm.forward(model["cfg"], model["params"],
                   torch.from_numpy(model["tokens"]),
                   ctx=Ctx(cfg=model["cfg"], act_dtype=torch.float32))


def _decode_inputs(m, s_max=S_MAX):
    jcache = jlm.cache_from_prefill(m["jcfg"], m["jcaches"], s_max,
                                    jnp.float32)
    cache = lm.cache_from_prefill(m["cfg"], m["caches"], s_max, torch.float32)
    nxt = np.array([[5], [7]], np.int32)
    pos = np.array([9, 6], np.int32)
    return jcache, cache, nxt, pos


def test_cache_from_prefill_and_init_cache(model):
    """The cross cache passes through in act_dtype as a copy (no ring, no
    pad); init_cache holds zeros of the reference's shapes."""
    m = model
    jcache, cache, _, _ = _decode_inputs(m)
    _assert_trees_close(cache, jcache, **TOL)
    src = m["caches"]["0:attn"]["cross"]["k"]
    assert cache["0:attn"]["cross"]["k"].data_ptr() != src.data_ptr()
    bf = lm.cache_from_prefill(m["cfg"], m["caches"], S_MAX, torch.bfloat16)
    assert bf["0:attn"]["cross"]["v"].dtype == torch.bfloat16
    zero = lm.init_cache(m["cfg"], 3, S_MAX, torch.float32, "cpu")
    jzero = jlm.init_cache(m["jcfg"], 3, S_MAX, jnp.float32)
    _assert_trees_close(zero, jzero, atol=0, rtol=0)


def test_decode_step(model):
    """One decode step against the reference's: self-attention writes its
    cache, cross-attention reads the encoder memory and leaves it as it
    was, bit for bit."""
    m = model
    jcache, cache, nxt, pos = _decode_inputs(m)
    cross0 = map_tree(torch.clone, cache["0:attn"]["cross"])
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
    for kk in ("k", "v"):
        assert torch.equal(new["0:attn"]["cross"][kk], cross0[kk])


def test_prefill_then_decode():
    """The reference's test_prefill_then_decode property on the port
    (prefill of 9, decode of 5, against the full forward of 14), and
    each decode step's logits against the reference's."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jparams = jlm.init(jcfg, jax.random.key(0))
    params = _port(jparams)
    B, S, T0 = 2, 14, 9
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    frames = np.full((B, cfg.frontend_len, cfg.d_model), 0.01, np.float32)
    ctx = Ctx(cfg=cfg, act_dtype=torch.float32)
    jctx = JCtx(cfg=jcfg, act_dtype=jnp.float32)
    tok = torch.from_numpy(tokens)
    fr = torch.from_numpy(frames)
    full, _, _ = lm.forward(cfg, params, tok, ctx=ctx, enc_frames=fr)
    _, _, caches = lm.forward(cfg, params, tok[:, :T0],
                              ctx=dataclasses.replace(ctx, mode="prefill"),
                              enc_frames=fr)
    _, _, jcaches = jlm.forward(jcfg, jparams, jnp.asarray(tokens[:, :T0]),
                                ctx=dataclasses.replace(jctx, mode="prefill"),
                                enc_frames=jnp.asarray(frames))
    cache = lm.cache_from_prefill(cfg, caches, S + 4, torch.float32)
    jcache = jlm.cache_from_prefill(jcfg, jcaches, S + 4, jnp.float32)
    dctx = dataclasses.replace(ctx, mode="decode")
    jdctx = dataclasses.replace(jctx, mode="decode")
    for t in range(T0, S):
        pos = np.full((B,), t, np.int32)
        logits, cache = lm.decode_step(cfg, params, cache, tok[:, t:t + 1],
                                       torch.from_numpy(pos), ctx=dctx)
        jlogits, jcache = jlm.decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(tokens[:, t:t + 1]),
                                          jnp.asarray(pos), ctx=jdctx)
        np.testing.assert_allclose(np32(logits[:, 0]), np32(full[:, t]),
                                   atol=2e-3, rtol=2e-3, err_msg=f"t={t}")
        np.testing.assert_allclose(np32(logits), np32(jlogits), **TOL)


def test_serving_steps_pass_enc_frames(model):
    """train.step's prefill and decode steps on Whisper: the prefill step
    gives the last position's logits and the caches of lm.forward; the
    decode step's zero cache has the cross entry."""
    from repro_torch.train.step import make_decode_step, make_prefill_step
    m = model
    prefill, _ = make_prefill_step(m["cfg"], act_dtype=torch.float32)
    last, caches = prefill(m["params"], {
        "tokens": torch.from_numpy(m["tokens"]),
        "enc_frames": torch.from_numpy(m["frames"])})
    torch.testing.assert_close(last, m["logits"][:, -1:], atol=0, rtol=0)
    _assert_trees_close(caches, m["jcaches"], **TOL)
    step, _, _, cache = make_decode_step(m["cfg"], batch=2, s_max=S_MAX,
                                         act_dtype=torch.float32,
                                         device="cpu")
    assert tuple(cache["0:attn"]["cross"]["k"].shape[2:4]) == (
        m["cfg"].n_kv_heads, m["cfg"].frontend_len)
    cache = lm.cache_from_prefill(m["cfg"], caches, S_MAX, torch.float32)
    _, jcache, nxt, pos = _decode_inputs(m)
    logits, _ = step(m["params"], cache, torch.from_numpy(nxt),
                     torch.from_numpy(pos))
    want, _ = lm.decode_step(m["cfg"], m["params"], jcache,
                             torch.from_numpy(nxt), torch.from_numpy(pos),
                             ctx=Ctx(cfg=m["cfg"], mode="decode",
                                     act_dtype=torch.float32))
    torch.testing.assert_close(logits, want, atol=0, rtol=0)


@pytest.fixture(scope="module")
def smoke():
    """The reference's loss and gradients (remat none) on a padded batch
    with encoder frames."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jparams = jlm.init(jcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels[1, -3:] = -1                                  # padding
    frames = _frames(cfg, 2, seed=3)
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels),
                           ctx=jctx, enc_frames=jnp.asarray(frames),
                           remat="none"),
        has_aux=True)(jparams)
    return dict(cfg=cfg, jparams=jparams, tokens=tokens, labels=labels,
                frames=frames, jv=jv, jm=jm, jg=jg)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_vs_reference(smoke, remat):
    """Loss and every gradient against jax.grad, the encoder's and the
    cross-attention's included (all nonzero)."""
    m = smoke
    params = _port(m["jparams"])
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_names(params)]
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    with one_torch_thread():
        v, metrics = lm.loss(m["cfg"], params, torch.from_numpy(m["tokens"]),
                             torch.from_numpy(m["labels"]), ctx=ctx,
                             enc_frames=torch.from_numpy(m["frames"]),
                             remat=remat)
        grads = torch.autograd.grad(v, leaves)
    np.testing.assert_allclose(float(v.detach()), float(m["jv"]), rtol=1e-5)
    assert int(metrics["ntok"]) == int(m["jm"]["ntok"]) == 21
    _assert_trees_close(tree_unflatten(params, grads), m["jg"], **GRAD)
    g = dict(tree_flatten_with_names(tree_unflatten(params, grads)))
    for name in ("units.0:attn.cross.wq", "units.0:attn.cross.wk",
                 "units.0:attn.cross.wv", "units.0:attn.cross.wo",
                 "enc_units.0:attn.attn.wq", "enc_units.0:attn.mlp.wi",
                 "enc_norm.scale"):
        assert bool((g[name] != 0).any()), name


@pytest.mark.parametrize("d", [16, 64, 768])
def test_sinusoid_rows_are_the_reference_tables(d):
    """The rows the port computes at decode positions against the
    reference's table of 2^17 rows (the one its decode_step gathers
    from), and against the port's own table bit for bit. Held to 1 ulp
    of each angle plus 1e-6: the reference's f32 power is an ulp off at
    one frequency of d = 768 (there the angle at 2^17 - 1 moves by 2^-8)."""
    positions = np.array([0, 447, 1499, (1 << 17) - 1])
    table = np.asarray(jlm._sinusoid(1 << 17, d))[positions]
    rows = lm._sinusoid_at(torch.from_numpy(positions), d).numpy()
    assert rows.shape == (4, d) and rows.dtype == np.float32
    tol = np.spacing(positions.astype(np.float32))[:, None] + 1e-6
    assert (np.abs(rows - table) <= tol).all()
    assert np.abs(rows[:3] - table[:3]).max() <= 1.3e-4
    own = lm._sinusoid(1500, d)
    assert torch.equal(torch.from_numpy(rows[:3]), own[positions[:3]])


def test_forward_segment_and_n_blocks(model):
    """What the reference computes: no sinusoid, and with no enc_out each
    cross-attention reads the decoder's own states."""
    m = model
    assert lm.n_blocks(m["cfg"]) == jlm.n_blocks(m["jcfg"]) == 2
    jctx = JCtx(cfg=m["jcfg"], mesh=None, act_dtype=jnp.float32)
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    tokens = m["tokens"]
    jz = jlm.forward_segment(m["jcfg"], m["jparams"], None, 0, 1, ctx=jctx,
                             tokens=jnp.asarray(tokens))
    z = lm.forward_segment(m["cfg"], m["params"], None, 0, 1, ctx=ctx,
                           tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(np32(z), np32(jz), atol=1e-5, rtol=1e-5)
    jl = jlm.forward_segment(m["jcfg"], m["jparams"], jz, 1, 2, ctx=jctx)
    lg = lm.forward_segment(m["cfg"], m["params"], z, 1, 2, ctx=ctx)
    np.testing.assert_allclose(np32(lg), np32(jl), **TOL)


def _refuse_split_params(cfg, params):
    lm.split_serve_params(cfg, params, 1)


def _refuse_split_step(cfg, params):
    cache = lm.init_cache(cfg, 1, 8, torch.float32, "cpu")
    lm.decode_step_split(cfg, params, params, cache,
                         torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1,), dtype=torch.int32),
                         ctx=Ctx(cfg=cfg, mode="decode",
                                 act_dtype=torch.float32))


def _refuse_engine(cfg, params):
    from repro_torch.serve.engine import DecodeEngine
    DecodeEngine(cfg, params, n_slots=1, s_max=8, device="cpu")


def _refuse_split_engine(cfg, params):
    from repro_torch.serve_fleet.engine import SplitDecodeEngine
    SplitDecodeEngine(cfg, params, cut_units=1, n_slots=1, s_max=8,
                      device="cpu")


def _refuse_serve_cli(cfg, params):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1"])


@pytest.mark.parametrize("call", [_refuse_split_params, _refuse_split_step,
                                  _refuse_engine, _refuse_split_engine,
                                  _refuse_serve_cli])
def test_what_stays_refused(model, call):
    """Split serving and the engines refuse enc-dec, as the reference's
    do (its split_serve_params raises; its engine passes no frames)."""
    with pytest.raises(NotImplementedError, match="enc-dec"):
        call(model["cfg"], model["params"])
    with pytest.raises(NotImplementedError):
        jlm.split_serve_params(model["jcfg"], model["jparams"], 1)


# --------------------------------------------------------------------------
# B2 and B3 plain at Whisper's shapes (the smoke's heads, 600 frames: the
# backward's 512-row blocks leave a ragged tail, as 1,500 does on the card).
# --------------------------------------------------------------------------

CROSS_CASES = [
    # (B, H, KV, Sq, Skv, D): the encoder against itself, the decoder's
    # queries against the frames, one query row
    (1, 4, 4, 600, 600, 16),
    (2, 4, 4, 70, 600, 16),
    (2, 4, 4, 1, 600, 16),
]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,D", CROSS_CASES)
def test_flash_plain_non_causal_vs_reference(B, H, KV, Sq, Skv, D):
    """Values (f32 and bf16), lse and the backward of B2's plain version
    non-causal at Sq != Skv against ref.attention, the Pallas kernel in
    interpret mode, the reference's chunked forward and jax.grad."""
    rng = np.random.default_rng(Sq + Skv)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D),
                      (B, H, Sq, D))]
    for dtype, tol in ((jnp.float32, 2e-5), (jnp.bfloat16, 2e-2)):
        (qj, qt), (kj, kt), (vj, vt) = [both(a, dtype) for a in arrs[:3]]
        got = ops.flash_attention(qt, kt, vt, causal=False)
        for want in (jref.attention(qj, kj, vj, causal=False),
                     jops.flash_attention(qj, kj, vj, causal=False,
                                          use_pallas=True)):
            np.testing.assert_allclose(np32(got), np32(want), atol=tol,
                                       rtol=tol)
    q, k, v, w = arrs
    jo, jlse = jops._chunked_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, None, 512,
        512)
    t = torch.from_numpy
    o, lse = flash_attn.flash_attention_lse_plain(t(q), t(k), t(v),
                                                  causal=False)
    np.testing.assert_allclose(np32(o), np32(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np32(lse), np32(jlse)[..., 0], atol=2e-5,
                               rtol=2e-5)
    jg = jax.grad(lambda q, k, v: jnp.sum(jops.flash_attention(
        q, k, v, causal=False, use_pallas=False) * w), argnums=(0, 1, 2))(
            q, k, v)
    got = flash_attn.flash_attention_bwd_plain(t(q), t(k), t(v), o, lse, t(w),
                                               causal=False)
    for g, want in zip(got, jg):
        np.testing.assert_allclose(np32(g), np32(want), **GRAD)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_decode_plain_full_memory_vs_reference(dtype, tol):
    """B3's plain version over a fixed memory, every row at full length
    (cross-attention at decode, group 1), against the reference's jnp
    path and its Pallas kernel in interpret mode."""
    B, H, S, D = 3, 4, 600, 16
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.standard_normal(s), dtype)
        for s in ((B, H, 1, D), (B, H, S, D), (B, H, S, D))]
    lens = np.full((B,), S, np.int32)
    got = decode_attn.decode_attention_plain(qt, kt, vt, torch.from_numpy(lens))
    for use_pallas in (False, True):
        want = jops.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                     use_pallas=use_pallas)
        np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# launch.train's front-end stubs.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,key", [("qwen2_vl_7b", "frontend_embed"),
                                      ("whisper_small", "enc_frames")])
def test_launch_train_hands_the_reference_stubs(monkeypatch, capsys, arch,
                                                key):
    """The batch launch.train hands its step carries the reference's
    stub, zeros (batch, frontend_len, d_model) bf16, and the first loss
    is the reference's lm.loss on the same weights and batch: in bf16
    (the step's activations) within 1e-2 relative, and in f32 within
    1e-5."""
    from repro_torch.launch import train as launch_train
    seen = {}
    make = launch_train.make_train_step

    def spy(*a, **kw):
        step, s1, s2, init_state = make(*a, **kw)

        def first(state, batch):
            if not seen:
                seen["params"] = map_tree(torch.clone, state.params)
                seen["batch"] = dict(batch)
            out = step(state, batch)
            seen.setdefault("loss", float(out[1]["loss"]))
            return out
        return first, s1, s2, init_state

    monkeypatch.setattr(launch_train, "make_train_step", spy)
    B, S = 2, 16
    with one_torch_thread():
        launch_train.main(["--arch", arch, "--smoke", "--steps", "1",
                           "--batch", str(B), "--seq", str(S), "--device",
                           "cpu", "--log-every", "1"])
    capsys.readouterr()
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    batch = seen["batch"]
    assert set(batch) == {"tokens", "labels", key}
    stub = batch[key]
    assert tuple(stub.shape) == (B, cfg.frontend_len, cfg.d_model)
    assert stub.dtype == torch.bfloat16 and not bool(stub.any())
    jparams = jax.tree.map(jnp.asarray,
                           map_tree(lambda t: t.numpy(), seen["params"]))
    tokens, labels = (jnp.asarray(batch[k].numpy()) for k in ("tokens",
                                                              "labels"))
    for act, jact, rtol in ((torch.bfloat16, jnp.bfloat16, 1e-2),
                            (torch.float32, jnp.float32, 1e-5)):
        jv, _ = jlm.loss(jcfg, jparams, tokens, labels,
                         ctx=JCtx(cfg=jcfg, act_dtype=jact),
                         **{key: jnp.zeros(stub.shape, jnp.bfloat16)})
        if act == torch.bfloat16:
            np.testing.assert_allclose(seen["loss"], float(jv), rtol=rtol)
            continue
        with torch.no_grad(), one_torch_thread():
            v, _ = lm.loss(cfg, seen["params"], batch["tokens"],
                           batch["labels"], ctx=Ctx(cfg=cfg, act_dtype=act),
                           **{key: stub})
        np.testing.assert_allclose(float(v), float(jv), rtol=rtol)
