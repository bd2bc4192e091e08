"""The port's sparse experts and M-RoPE against ``repro.models.layers``
on the CPU in f32, from the same numpy inputs: ``apply_moe`` in both
dispatch layouts with a capacity small enough that (token, choice)
pairs drop, its Switch aux term and its gradients; the M-RoPE tables,
the text/vision position ids and ``apply_rope`` on (B, S, half)
tables."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import np32
from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.models import layers as L

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _moe_inputs(name, capacity_factor, B=3, S=11, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke(name),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(configs.get_smoke(name),
                              capacity_factor=capacity_factor)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
         "wi": rng.standard_normal((E, d, 2 * f)).astype(np.float32) / 8,
         "wo": rng.standard_normal((E, f, d)).astype(np.float32) / 8}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jcfg, cfg, p, x


def _drops(cfg, p, x, dispatch):
    """How many (token, choice) pairs the dispatch drops (reference
    arithmetic, recomputed in numpy)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(torch.from_numpy(x @ p["router"]), -1)
    eidx = torch.topk(probs, k, -1).indices.numpy()
    rows = eidx.reshape(B, S * k) if dispatch == "batch_local" else \
        eidx.reshape(1, B * S * k)
    C = int(np.ceil(rows.shape[1] / E * cfg.capacity_factor))
    return sum(max(0, int((r == e).sum()) - C) for r in rows for e in range(E))


@pytest.mark.parametrize("name", ["mixtral_8x7b", "phi35_moe"])
@pytest.mark.parametrize("dispatch", ["global", "batch_local"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_apply_moe_vs_reference(name, dispatch, capacity_factor):
    jcfg, cfg, p, x = _moe_inputs(name, capacity_factor)
    jctx = JL.Ctx(cfg=jcfg, act_dtype=jnp.float32, moe_dispatch=dispatch)
    ctx = L.Ctx(cfg=cfg, act_dtype=torch.float32, moe_dispatch=dispatch)
    jy, jaux = JL.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jctx)
    y, aux = L.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), ctx)
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(np32(y), np32(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if capacity_factor < 1:
        assert _drops(cfg, p, x, dispatch) > 0
        # a dropped pair contributes nothing: some token's output is
        # smaller than its full top-k mixture would be
        full_ctx = dataclasses.replace(ctx, cfg=dataclasses.replace(
            cfg, capacity_factor=100.0))
        y_full, _ = L.apply_moe({k: torch.from_numpy(v)
                                 for k, v in p.items()},
                                torch.from_numpy(x), full_ctx)
        assert not torch.allclose(y, y_full)


@pytest.mark.parametrize("dispatch", ["global", "batch_local"])
def test_apply_moe_gradients_vs_reference(dispatch):
    jcfg, cfg, p, x = _moe_inputs("mixtral_8x7b", 0.5, seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jctx = JL.Ctx(cfg=jcfg, act_dtype=jnp.float32, moe_dispatch=dispatch)

    def jf(p, x):
        y, aux = JL.apply_moe(p, x, jctx)
        return jnp.sum(y * w) + 0.01 * aux
    jg = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v)
                                       for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = L.apply_moe(tp, tx, L.Ctx(cfg=cfg, act_dtype=torch.float32,
                                       moe_dispatch=dispatch))
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + 0.01 * aux,
                                [tp[k] for k in sorted(tp)] + [tx])
    for k, g in zip(sorted(tp), grads):
        np.testing.assert_allclose(np32(g), np32(jg[0][k]), err_msg=k, **GRAD)
        assert bool((g != 0).any()), k
    np.testing.assert_allclose(np32(grads[-1]), np32(jg[1]), **GRAD)


def test_apply_moe_rejects_an_unknown_dispatch():
    _, cfg, p, x = _moe_inputs("mixtral_8x7b", 1.25)
    with pytest.raises(ValueError, match="moe_dispatch"):
        L.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x),
                    L.Ctx(cfg=cfg, moe_dispatch="expert_parallel"))


@pytest.mark.parametrize("B,S,F", [(2, 12, 8), (1, 300, 256), (3, 5, 0),
                                   (2, 9, 9)])
def test_text_mrope_positions_vs_reference(B, S, F):
    want = np.asarray(JL.text_mrope_positions(B, S, F))
    got = L.text_mrope_positions(B, S, F).numpy()
    np.testing.assert_array_equal(got, want)
    if F == 0:                             # text only: every section is RoPE
        assert (got == np.arange(S)).all()


@pytest.mark.parametrize("dim,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_mrope_tables_vs_reference(dim, theta):
    ids = np.asarray(JL.text_mrope_positions(2, 40, 16, offset=3))
    jc, js = JL.mrope_tables(jnp.asarray(ids), dim, theta)
    c, s = L.mrope_tables(torch.from_numpy(ids.copy()), dim, theta)
    assert tuple(c.shape) == (2, 40, dim // 2)
    np.testing.assert_allclose(np32(c), np32(jc), **TOL)
    np.testing.assert_allclose(np32(s), np32(js), **TOL)
    # text-only ids give RoPE's tables
    text = np.broadcast_to(np.arange(40)[None, None], (3, 1, 40)).copy()
    c, s = L.mrope_tables(torch.from_numpy(text), dim, theta)
    rc, rs = L.rope_tables(torch.arange(40), dim, theta)
    torch.testing.assert_close(c[0], rc, atol=0, rtol=0)
    torch.testing.assert_close(s[0], rs, atol=0, rtol=0)


@pytest.mark.parametrize("table", ["seq", "batch", "batch_seq"])
def test_apply_rope_vs_reference(table):
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 7, 3, 16
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    shape = {"seq": (S, D // 2), "batch": (B, D // 2),
             "batch_seq": (B, S, D // 2)}[table]
    if table == "batch":
        x = x[:, :1]
    ang = rng.standard_normal(shape).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                       torch.from_numpy(sin))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
