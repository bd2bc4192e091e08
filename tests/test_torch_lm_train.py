"""LM training in the port against the reference on the CPU: the kernels'
gradients (B2's plain backward and its autograd Function, B4's and B5's
recompute Functions, each given the plain forward) against ``jax.grad``
of the reference's ops, ``lm.loss`` and its gradients under every remat
mode, ``forward_segment``, ``lm_adapter``'s SL step, the parameter
counts, the FLOP functions and ``lm_plan`` at full width, and the
reference-shaped calls of ``Ctx``, the serving engine and ``unroll``.
Tolerances are the reference's (tests/test_kernels.py): 2e-5 for f32
attention, 5e-4 for gradients and scans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, np32, one_torch_thread
from repro import configs as jconfigs
from repro.core import sl_step as jsl
from repro.core import splitting as jsplitting
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro.utils import flops as jflops
from repro_torch import configs
from repro_torch.core import sl_step, splitting
from repro_torch.kernels import flash_attn, mamba_scan, mlstm_scan, ops
from repro_torch.kernels.recompute import flat
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params
from repro_torch.utils import flops
from repro_torch.utils.treeutil import tree_flatten_with_names, tree_unflatten

GRAD = dict(atol=5e-4, rtol=5e-4)
ATTN = dict(atol=2e-5, rtol=2e-5)
PORTED = ("smollm_360m", "zamba2_1_2b", "xlstm_1_3b", "granite_3_2b")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _assert_trees_close(got, want, **tol):
    """A port tree of tensors against a reference tree, leaf by leaf."""
    g = dict(tree_flatten_with_names(got))
    w = dict(tree_flatten_with_names(from_jax_params(jax_tree_to_numpy(want))))
    assert g.keys() == w.keys()
    for name in g:
        np.testing.assert_allclose(np32(g[name]), np32(w[name]),
                                   err_msg=name, **tol)


# --------------------------------------------------------------------------
# B2: lse, the plain backward and the autograd Function.
# --------------------------------------------------------------------------

ATTN_CASES = [
    (2, 4, 2, 100, 100, 32, True, None),        # GQA, causal
    (1, 4, 2, 150, 150, 32, True, 40),          # windowed
    (1, 3, 3, 64, 130, 16, False, None),        # MHA, Sq != Skv
    (1, 2, 1, 600, 600, 16, True, None),        # Sq not a multiple of 512
    (1, 2, 1, 600, 600, 16, True, 100),         # window across the blocks
]


def _attn_inputs(B, H, KV, Sq, Skv, D):
    rng = np.random.default_rng(B * 1000 + Sq)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D),
                      (B, H, Sq, D))]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,D,causal,window", ATTN_CASES)
def test_flash_backward_and_function_vs_jax_grad(B, H, KV, Sq, Skv, D, causal,
                                                 window):
    q, k, v, w = _attn_inputs(B, H, KV, Sq, Skv, D)

    def jf(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, causal=causal,
                                            window=window, use_pallas=False)
                       * w)
    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    jo, jlse = jops._chunked_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window, 512,
        512)

    # the plain lse and output against the reference's forward
    o, lse = flash_attn.flash_attention_lse_plain(_t(q), _t(k), _t(v),
                                                  causal=causal, window=window)
    np.testing.assert_allclose(np32(o), np32(jo), **ATTN)
    np.testing.assert_allclose(np32(lse), np32(jlse)[..., 0], **ATTN)

    # the plain backward from that forward
    dq, dk, dv = flash_attn.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), o, lse, _t(w), causal=causal, window=window)
    for got, want in zip((dq, dk, dv), jg):
        np.testing.assert_allclose(np32(got), np32(want), **GRAD)

    # the Function the card runs, over the plain forward
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attn.flash_attention_grad(
        qt, kt, vt, causal=causal, window=window,
        forward_fn=flash_attn.flash_attention_lse_plain)
    (out * _t(w)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), jg):
        np.testing.assert_allclose(np32(got), np32(want), **GRAD)


def test_flash_backward_returns_the_input_dtype():
    q, k, v, w = (_t(a).to(torch.bfloat16)
                  for a in _attn_inputs(1, 2, 1, 70, 70, 16))
    o, lse = flash_attn.flash_attention_lse_plain(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = flash_attn.flash_attention_bwd_plain(q, k, v, o, lse, w)
    assert all(g.dtype == torch.bfloat16 for g in grads)


# --------------------------------------------------------------------------
# B4 and B5: the recompute Functions.
# --------------------------------------------------------------------------

def _scan_inputs(seed, B, S, H, P, N=None):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    if N is None:                                        # mLSTM
        return [r(B, S, H, P), r(B, S, H, P), r(B, S, H, P),
                r(B, S, H), r(B, S, H) + 2.0]
    dt = np.log1p(np.exp(r(B, S, H) - 1.0)).astype(np.float32)
    return [r(B, S, H, P), dt, r(H) * 0.5, r(B, S, N), r(B, S, N)]


def _ref_and_port_grads(jfn, tfn, inputs, cots):
    def jloss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(
            jax.tree.leaves(jfn(*a)), cots))
    jg = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*inputs)
    ts = [_t(a).requires_grad_() for a in inputs]
    outs = flat(tfn(*ts))
    sum((o * _t(c)).sum() for o, c in zip(outs, cots)).backward()
    return jg, [t.grad for t in ts]


@pytest.mark.parametrize("S,chunk", [(40, 16), (33, 128)])
def test_mamba_function_vs_jax_grad(S, chunk):
    B, H, P, N = 2, 3, 8, 6
    inputs = _scan_inputs(S, B, S, H, P, N)
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32)]
    jg, tg = _ref_and_port_grads(
        lambda *a: jops.mamba_scan(*a, chunk=chunk, use_pallas=False),
        lambda *a: mamba_scan.mamba_scan_grad(
            *a, chunk=chunk, forward_fn=mamba_scan.mamba_chunk_scan_plain),
        inputs, cots)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(np32(got), np32(want), **GRAD)


def test_mamba_gradient_is_finite_where_the_reference_overflows():
    """A chunk whose decay exp(cum_t - cum_s) overflows above the diagonal
    (dt * A summing past 88 within the chunk): the reference's gradient
    of dt, a_log, b and c is NaN there (ROADMAP C12), the port's is
    finite; the values and x's gradient agree."""
    B, S, H, P, N = 1, 130, 2, 8, 6
    x, dt, _, b, c = _scan_inputs(11, B, S, H, P, N)
    dt = dt + 0.5
    a_log = np.ones(H, np.float32)
    inputs = [x, dt, a_log, b, c]
    cots = [np.ones((B, S, H, P), np.float32), np.ones((B, H, P, N),
                                                       np.float32)]
    jg, tg = _ref_and_port_grads(
        lambda *a: jops.mamba_scan(*a, chunk=128, use_pallas=False),
        lambda *a: ops.mamba_scan(*a, chunk=128), inputs, cots)
    assert all(np.isnan(np.asarray(g)).any() for g in jg[1:])
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    np.testing.assert_allclose(np32(tg[0]), np32(jg[0]), **GRAD)


@pytest.mark.parametrize("S,chunk", [(40, 16), (33, 256)])
def test_mlstm_function_vs_jax_grad(S, chunk):
    B, H, P = 2, 2, 8
    inputs = _scan_inputs(S + 1, B, S, H, P)
    rng = np.random.default_rng(8)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, P), (B, H, P, P), (B, H, P), (B, H))]
    jg, tg = _ref_and_port_grads(
        lambda *a: jops.mlstm_scan(*a, chunk=chunk, use_pallas=False),
        lambda *a: mlstm_scan.mlstm_scan_grad(
            *a, chunk=chunk, forward_fn=mlstm_scan.mlstm_chunk_scan_plain),
        inputs, cots)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(np32(got), np32(want), **GRAD)


# --------------------------------------------------------------------------
# lm.loss under every remat mode, and forward_segment.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["smollm_360m", "zamba2_1_2b",
                                        "xlstm_1_3b"])
def smoke(request):
    jcfg = jconfigs.get_smoke(request.param)
    cfg = configs.get_smoke(request.param)
    jparams = jlm.init(jcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels[1, -3:] = -1                                  # padding
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)
    (jv, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss(jcfg, p, jnp.asarray(tokens), jnp.asarray(labels),
                           ctx=jctx, remat="none"), has_aux=True)(jparams)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, jparams=jparams,
                tokens=tokens, labels=labels, jv=jv, jm=jm, jg=jg)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_vs_reference(smoke, remat):
    m = smoke
    params = from_jax_params(jax_tree_to_numpy(m["jparams"]))
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_names(params)]
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    with one_torch_thread():
        v, metrics = lm.loss(m["cfg"], params, torch.from_numpy(m["tokens"]),
                             torch.from_numpy(m["labels"]), ctx=ctx,
                             remat=remat)
        grads = torch.autograd.grad(v, leaves)
    np.testing.assert_allclose(float(v.detach()), float(m["jv"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(m["jm"]["ce"]),
                               rtol=1e-5)
    assert int(metrics["ntok"]) == int(m["jm"]["ntok"]) == 21
    _assert_trees_close(tree_unflatten(params, grads), m["jg"], **GRAD)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_loss_through_the_functions_under_remat(smoke, remat, monkeypatch):
    """lm.loss with attention and the scans routed through their autograd
    Functions (the card's route), each given the plain forward, under
    both remat modes: the reference's value and gradients, and each
    Function's forward run twice per layer (the forward and the
    recompute), as the kernels are launched on the card."""
    calls = {"attn": 0, "mamba": 0, "mlstm": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    attn = counted("attn", flash_attn.flash_attention_lse_plain)
    mamba = counted("mamba", mamba_scan.mamba_chunk_scan_plain)
    mlstm = counted("mlstm", mlstm_scan.mlstm_chunk_scan_plain)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: flash_attn.flash_attention_grad(
                            q, k, v, forward_fn=attn, **kw))
    monkeypatch.setattr(ops, "mamba_scan",
                        lambda *a, **kw: mamba_scan.mamba_scan_grad(
                            *a, forward_fn=mamba, **kw))
    monkeypatch.setattr(ops, "mlstm_scan",
                        lambda *a, **kw: mlstm_scan.mlstm_scan_grad(
                            *a, forward_fn=mlstm, **kw))
    m = smoke
    params = from_jax_params(jax_tree_to_numpy(m["jparams"]))
    leaves = [t.requires_grad_() for _, t in tree_flatten_with_names(params)]
    ctx = Ctx(cfg=m["cfg"], act_dtype=torch.float32)
    tokens, labels = (torch.from_numpy(m[k]) for k in ("tokens", "labels"))
    with one_torch_thread():
        with torch.no_grad():
            lm.loss(m["cfg"], params, tokens, labels, ctx=ctx, remat="none")
        once = dict(calls)
        v, _ = lm.loss(m["cfg"], params, tokens, labels, ctx=ctx,
                       remat=remat)
        grads = torch.autograd.grad(v, leaves)
    assert sum(once.values()) > 0
    assert {k: calls[k] - once[k] for k in calls} == {
        k: 2 * n for k, n in once.items()}
    np.testing.assert_allclose(float(v.detach()), float(m["jv"]), rtol=1e-5)
    _assert_trees_close(tree_unflatten(params, grads), m["jg"], **GRAD)


@pytest.mark.parametrize("name", ["smollm_360m", "zamba2_1_2b"])
def test_forward_segment_vs_reference(name):
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jparams = jlm.init(jcfg, jax.random.key(3))
    params = from_jax_params(jax_tree_to_numpy(jparams))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 10)) \
        .astype(np.int32)
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)
    ctx = Ctx(cfg=cfg, act_dtype=torch.float32)
    n, cut = lm.n_blocks(cfg), len(cfg.pattern_unit())
    assert n == jlm.n_blocks(jcfg)
    jz = jlm.forward_segment(jcfg, jparams, None, 0, cut, ctx=jctx,
                             tokens=jnp.asarray(tokens))
    z = lm.forward_segment(cfg, params, None, 0, cut, ctx=ctx,
                           tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(np32(z), np32(jz), atol=1e-5, rtol=1e-5)
    # the ground segment on a tree of its own units (unit_offset)
    jpb = dict(jparams, units=jax.tree.map(lambda a: a[1:], jparams["units"]))
    pb = dict(params, units={k: {kk: _sub(vv) for kk, vv in v.items()}
                             for k, v in params["units"].items()})
    jl = jlm.forward_segment(jcfg, jpb, jz, cut, n, ctx=jctx, unit_offset=1)
    lg = lm.forward_segment(cfg, pb, z, cut, n, ctx=ctx, unit_offset=1)
    np.testing.assert_allclose(np32(lg), np32(jl), atol=1e-4, rtol=1e-4)
    jfull, _, _ = jlm.forward(jcfg, jparams, jnp.asarray(tokens), ctx=jctx,
                              remat="none")
    np.testing.assert_allclose(np32(lg), np32(jfull), atol=1e-4, rtol=1e-4)


def _sub(tree):
    if isinstance(tree, dict):
        return {k: _sub(v) for k, v in tree.items()}
    return tree[1:]


# --------------------------------------------------------------------------
# lm_adapter's SL step.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,cut", [("smollm_360m", 1), ("zamba2_1_2b", 1)])
@pytest.mark.parametrize("quantize", [False, True])
def test_lm_adapter_sl_step_vs_reference(name, cut, quantize):
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jad = jsl.lm_adapter(jcfg, cut_units=cut, seq_len=16)
    ad = sl_step.lm_adapter(cfg, cut_units=cut, seq_len=16)
    assert ad.cut_index == jad.cut_index
    jpa, jpb = jad.init(jax.random.key(5))
    pa = from_jax_params(jax_tree_to_numpy(jpa))
    pb = from_jax_params(jax_tree_to_numpy(jpb))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jres = jsl.make_sl_step(jad, quantize_boundary=quantize)(
        jpa, jpb, {k: jnp.asarray(v) for k, v in batch.items()})
    with one_torch_thread():
        res = sl_step.make_sl_step(ad, quantize_boundary=quantize)(
            pa, pb, batch)
    np.testing.assert_allclose(float(res.loss), float(jres.loss), rtol=1e-5)
    _assert_trees_close(res.grads_a, jres.grads_a, **GRAD)
    _assert_trees_close(res.grads_b, jres.grads_b, **GRAD)
    bits = 2 * 16 * cfg.d_model * (8 if quantize else 32)
    assert res.dtx_bits_down == jres.dtx_bits_down == bits
    assert sl_step.boundary_bits(ad, batch, quantize) == bits
    assert jsl.boundary_bits(jad, batch, quantize) == bits


@pytest.mark.parametrize("name", ["smollm_360m", "zamba2_1_2b"])
def test_lm_adapter_init_copies_the_shared_leaves(name):
    cfg = configs.get_smoke(name)
    ad = sl_step.lm_adapter(cfg, cut_units=1, seq_len=8)
    pa, pb = ad.init(torch.Generator().manual_seed(0))
    specs = [dict(tree_flatten_with_names(s)) for s in ad.specs]
    for tree, spec in zip((pa, pb), specs):
        got = dict(tree_flatten_with_names(tree))
        assert got.keys() == spec.keys()
        assert all(tuple(got[k].shape) == spec[k].shape for k in got)
    if cfg.tie_embeddings:                               # SmolLM
        assert torch.equal(pb["head_tied"], pa["embed"])
        assert pb["head_tied"].data_ptr() != pa["embed"].data_ptr()
    if "shared" in pa:                                   # Zamba2
        for (_, a), (_, b) in zip(tree_flatten_with_names(pa["shared"]),
                                  tree_flatten_with_names(pb["shared"])):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_lm_adapter_trains_in_the_ring_with_adamw():
    """The reference's test_constellation_lm_adapter_adamw on the port."""
    from repro_torch.core.constellation import (ConstellationConfig,
                                                ConstellationSim)
    from repro_torch.core.energy import PassBudget
    from repro_torch.data.synthetic import TokenShards
    cfg = configs.get_smoke("smollm_360m")
    ad = sl_step.lm_adapter(cfg, cut_units=1, seq_len=16)
    shards = TokenShards(vocab=cfg.vocab, seq_len=16, batch=2)
    with one_torch_thread():
        sim = ConstellationSim(
            ad, PassBudget(n_items=4.0), shards.batch_at,
            ConstellationConfig(n_passes=2, batch_size=2, optimizer="adamw",
                                lr=1e-3, quantize_boundary=True),
            device="cpu")
        recs = sim.run()
    assert all(r.action in ("trained", "shed") for r in recs)
    assert all(np.isfinite(r.loss) for r in recs)
    assert sim.planner.solve_calls == 1


# --------------------------------------------------------------------------
# The counts, the FLOP functions and lm_plan at full width.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_counts_flops_and_lm_plan_vs_reference(name):
    jcfg, cfg = jconfigs.get(name), configs.get(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for kind in set(cfg.block_kinds()):
        assert cfg.block_param_count(kind) == jcfg.block_param_count(kind)
        assert (cfg.block_active_param_count(kind)
                == jcfg.block_active_param_count(kind))
    for seq in (512, 4096):
        plan, jplan = splitting.lm_plan(cfg, seq), jsplitting.lm_plan(jcfg, seq)
        assert [_layer_tuple(l) for l in plan.layers] == \
            [_layer_tuple(l) for l in jplan.layers]
        for cut in (1, len(plan.layers) // 2, len(plan.layers) - 1):
            a, b = plan.costs_at(cut), jplan.costs_at(cut)
            assert (a.w1_flops, a.w2_flops, a.dtx_bits, a.d_isl_bits,
                    a.name) == (b.w1_flops, b.w2_flops, b.dtx_bits,
                                b.d_isl_bits, b.name)
        assert flops.total_fwd_flops(plan.layers) == \
            jflops.total_fwd_flops(jplan.layers)
        assert flops.total_param_bytes(plan.layers) == \
            jflops.total_param_bytes(jplan.layers)
        assert flops.lm_embed_head_fwd_flops(cfg.d_model, cfg.vocab, seq) == \
            jflops.lm_embed_head_fwd_flops(cfg.d_model, cfg.vocab, seq)


def _layer_tuple(layer):
    return (layer.name, layer.fwd_flops, layer.param_bytes, layer.out_bits,
            layer.active_param_count, layer.param_count)


@pytest.mark.parametrize("kind", ["attn", "shared_attn", "mamba2", "mlstm",
                                  "slstm", "moe"])
def test_lm_block_flops_vs_reference(kind):
    for kw in (dict(d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
                    seq=512),
               dict(d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
                    seq=4096, window=1024, n_experts=8, top_k=2,
                    d_head=128, ssm_state=64, mlp_kind="gelu")):
        assert flops.lm_block_fwd_flops(block_kind=kind, **kw) == \
            jflops.lm_block_fwd_flops(block_kind=kind, **kw)
    for args in ((7, 13, 3), (512.0, 960, 49152)):
        assert flops.matmul_flops(*args) == jflops.matmul_flops(*args)
    for kw in (dict(causal=True), dict(causal=False), dict(window=100),
               dict(window=5000, causal=True)):
        assert flops.attention_flops(512, 512, 15, 64, **kw) == \
            jflops.attention_flops(512, 512, 15, 64, **kw)


# --------------------------------------------------------------------------
# The reference-shaped calls (C11).
# --------------------------------------------------------------------------

def _smoke_model(name="smollm_360m"):
    cfg = configs.get_smoke(name)
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0))


def test_ctx_takes_every_reference_field():
    cfg, params = _smoke_model()
    tokens = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    ref_shaped = Ctx(cfg=cfg, mesh=None, rules=None, mode="train",
                     positions=None, rope=None, enc_out=None,
                     act_dtype=torch.float32, use_pallas=True, block_q=128,
                     block_k=64, mamba_chunk=64, mlstm_chunk=128,
                     attn_compute_dtype=torch.bfloat16,
                     moe_dispatch="batch_local")
    a, _, _ = lm.forward(cfg, params, tokens, ctx=ref_shaped)
    b, _, _ = lm.forward(cfg, params, tokens,
                         ctx=Ctx(cfg=cfg, act_dtype=torch.float32))
    assert torch.equal(a, b)                 # the ignored fields change nothing
    assert (Ctx(cfg=cfg).mamba_chunk, Ctx(cfg=cfg).mlstm_chunk) == (128, 256)


@pytest.mark.parametrize("name,op,field", [
    ("zamba2_1_2b", "mamba_scan", "mamba_chunk"),
    ("xlstm_1_3b", "mlstm_scan", "mlstm_chunk")])
def test_ctx_scan_chunks_are_honoured(monkeypatch, name, op, field):
    cfg, params = _smoke_model(name)
    seen = []
    real = getattr(ops, op)

    def spy(*a, chunk, **kw):
        seen.append(chunk)
        return real(*a, chunk=chunk, **kw)
    monkeypatch.setattr(ops, op, spy)
    tokens = torch.arange(14, dtype=torch.int32).reshape(2, 7) % cfg.vocab
    outs = [lm.forward(cfg, params, tokens, ctx=Ctx(
        cfg=cfg, act_dtype=torch.float32, **{field: c}))[0] for c in (3, 16)]
    assert set(seen) == {3, 16}
    # the chunkwise scans are exact for any chunk
    np.testing.assert_allclose(np32(outs[0]), np32(outs[1]), atol=1e-4,
                               rtol=1e-4)


def test_unroll_is_accepted():
    cfg, params = _smoke_model()
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    tokens = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    logits, _, caches = lm.forward(cfg, params, tokens, ctx=ctx, unroll=2,
                                   remat="none")
    cache = lm.cache_from_prefill(cfg, caches, 8, torch.float32)
    dctx = Ctx(cfg=cfg, mode="decode", act_dtype=torch.float32)
    nxt, pos = torch.tensor([[4]], dtype=torch.int32), torch.tensor([3])
    la, _ = lm.decode_step(cfg, params, _copy(cache), nxt, pos, ctx=dctx,
                           unroll=2)
    pa, pb = lm.split_serve_params(cfg, params, 1)
    lb, _, _ = lm.decode_step_split(cfg, pa, pb, _copy(cache), nxt, pos,
                                    ctx=dctx, unroll=2)
    assert torch.equal(la, lb)


def _copy(tree):
    from repro_torch.models.param import map_tree
    return map_tree(torch.clone, tree)


def test_decode_engine_takes_use_pallas():
    from repro_torch.serve.engine import DecodeEngine, Request
    cfg, params = _smoke_model()
    eng = DecodeEngine(cfg, params, n_slots=2, s_max=16, use_pallas=True,
                       device="cpu")
    with one_torch_thread():
        out = eng.submit_and_run([Request(rid=0, prompt=np.arange(
            4, dtype=np.int32), max_new_tokens=2)])
    assert len(out[0]) == 2


def test_serve_takes_use_pallas():
    from repro_torch.launch import serve
    with one_torch_thread():
        out = serve.main(["--requests", "1", "--new-tokens", "2",
                          "--use-pallas", "--device", "cpu"])
    assert list(out) == [0] and len(out[0]) == 2
