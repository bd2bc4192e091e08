"""Training through the kernels on a card: the autograd Functions of B2
(flash attention: the kernel's forward with its lse, the plain
backward), B4 and B5 (the kernel scans, the plain scans' gradients by
recompute) against the plain path, B3 refusing a gradient, and one train
step of the Zamba2 and xLSTM smoke configs on the card against the same
step on the CPU. Imports neither JAX nor the JAX package:
``PYTHONPATH=src python -m pytest -q -m requires_cuda
tests/test_torch_train_cuda.py``. Every test skips without a card."""
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import (decode_attn, flash_attn, mamba_scan,
                                 mlstm_scan, ops)
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import map_tree
from repro_torch.train.step import TrainConfig, loss_and_grads
from repro_torch.utils.treeutil import tree_flatten_with_names

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided inside
    the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _grads(fn, inputs, cots):
    ts = [t.detach().clone().requires_grad_(t.is_floating_point())
          for t in inputs]
    outs = fn(*ts)
    outs = [outs] if torch.is_tensor(outs) else list(outs)
    grads = torch.autograd.grad(outs, [t for t in ts if t.requires_grad],
                                cots[:len(outs)])
    return [o.detach() for o in outs], grads


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (2, 15, 5, 512, 64, None),          # SmolLM's heads, its training length
    (1, 4, 2, 600, 32, None),           # two backward blocks
    (1, 4, 4, 300, 16, 100),            # windowed, the smoke configs' heads
])
def test_flash_function_vs_plain(B, H, KV, S, D, window, dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = [torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D),
                             (B, H, S, D))]
    o, lse = flash_attn.flash_attention_fwd(q, k, v, window=window, lse=True)
    po, plse = flash_attn.flash_attention_lse_plain(q, k, v, window=window)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=TOL[dtype], rtol=TOL[dtype])
    n0 = flash_attn.flash_attention_fwd.launches
    got_o, got = _grads(lambda q, k, v: ops.flash_attention(
        q, k, v, window=window), (q, k, v), [do])
    assert flash_attn.flash_attention_fwd.launches == n0 + 1
    want_o, want = _grads(lambda q, k, v: flash_attn.flash_attention_plain(
        q, k, v, window=window), (q, k, v), [do])
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD[dtype],
                                   rtol=GRAD[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_function_vs_plain(dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    B, S, H, P, N = 2, 200, 8, 64, 64
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x, b, c = r(B, S, H, P).to(dtype), r(B, S, N).to(dtype), r(B, S, N).to(dtype)
    dt = torch.nn.functional.softplus(r(B, S, H) - 1.0)
    a_log = r(H) * 0.5
    cots = [r(B, S, H, P).to(dtype), r(B, H, P, N)]
    n0 = mamba_scan.mamba_chunk_scan.launches
    (y, h), got = _grads(lambda *a: ops.mamba_scan(*a, chunk=128),
                         (x, dt, a_log, b, c), cots)
    assert mamba_scan.mamba_chunk_scan.launches == n0 + 1
    (py, ph), want = _grads(lambda *a: mamba_scan.mamba_chunk_scan_plain(
        *a, chunk=128), (x, dt, a_log, b, c), cots)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, ph, atol=5e-4, rtol=5e-4)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_function_vs_plain(dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    B, S, H, P = 2, 130, 4, 64
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    q, k, v = (r(B, S, H, P).to(dtype) for _ in range(3))
    i_pre, f_pre = r(B, S, H), r(B, S, H) + 2.0
    cots = [r(B, S, H, P).to(dtype), r(B, H, P, P), r(B, H, P), r(B, H)]
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    flat = lambda out: (out[0],) + tuple(out[1])
    (h, *_), got = _grads(lambda *a: flat(ops.mlstm_scan(*a, chunk=256)),
                          (q, k, v, i_pre, f_pre), cots)
    assert mlstm_scan.mlstm_chunk_scan.launches == n0 + 1
    (ph, *_), want = _grads(lambda *a: flat(mlstm_scan.mlstm_chunk_scan_plain(
        *a, chunk=256)), (q, k, v, i_pre, f_pre), cots)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(h.float(), ph.float(), atol=tol, rtol=tol)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, w)


@pytest.mark.requires_cuda
def test_decode_attention_refuses_a_gradient():
    dev = require_cuda()
    q = torch.randn(2, 4, 1, 32, device=dev, requires_grad=True)
    k = torch.randn(2, 2, 16, 32, device=dev)
    lengths = torch.tensor([16, 3], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, k, k, lengths)
    with torch.no_grad():
        assert ops.decode_attention(q, k, k, lengths).shape == (2, 4, 1, 32)
    n0 = decode_attn.decode_attention.launches
    ops.decode_attention(q.detach(), k, k, lengths)
    assert decode_attn.decode_attention.launches == n0 + 1


PROJECTIONS = ("wq", "wk", "wv", "wo", "wi", "w_in", "w_bc", "w_dt", "w_out",
               "w_qkv", "w_if", "w_x", "w_h", "router")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_1_2b", "xlstm_1_3b",
                                  "mixtral_8x7b", "phi35_moe"])
def test_smoke_train_step_on_the_card_equals_the_cpu(arch, remat):
    """One loss and gradient of a smoke config on the card against the
    CPU, under full and selective (dots) remat: every kernel of the
    architecture is launched twice a layer (the forward and the
    recompute), B3 never, and the projections (the MoE router and
    experts included) get nonzero gradients. The MoE configs run both
    dispatch layouts."""
    dev = require_cuda()
    cfg = configs.get_smoke(arch)
    for dispatch in (("global", "batch_local") if cfg.n_experts
                     else ("global",)):
        _smoke_step_on_the_card(cfg, remat, dispatch, dev)


def _smoke_step_on_the_card(cfg, remat, dispatch, dev):
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tcfg = TrainConfig(act_dtype=torch.float32, remat=remat,
                       moe_dispatch=dispatch)
    on_card = map_tree(lambda t: t.to(dev), params)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    kernels = (flash_attn.flash_attention_fwd, decode_attn.decode_attention,
               mamba_scan.mamba_chunk_scan, mlstm_scan.mlstm_chunk_scan)
    n0 = [k.launches for k in kernels]
    with torch.no_grad():
        lm.loss(cfg, on_card, card_batch["tokens"], card_batch["labels"],
                ctx=Ctx(cfg=cfg, act_dtype=torch.float32,
                        moe_dispatch=dispatch), remat="none")
    n1 = [k.launches for k in kernels]
    lc, _, gc = loss_and_grads(cfg, tcfg, on_card, card_batch)
    once = [b - a for a, b in zip(n0, n1)]
    assert once[1] == 0 and sum(once) > 0
    assert [k.launches - b for k, b in zip(kernels, n1)] == [2 * n for n in once]
    lp, _, gp = loss_and_grads(cfg, tcfg, params, batch)
    torch.testing.assert_close(lc.cpu(), lp, atol=1e-5, rtol=1e-5)
    cuda, cpu = (dict(tree_flatten_with_names(t)) for t in (gc, gp))
    checked = 0
    for name, g in cuda.items():
        if name.rsplit(".", 1)[-1] in PROJECTIONS:
            assert bool((g != 0).any()), f"{name}: no gradient on the card"
            checked += 1
        torch.testing.assert_close(g.cpu(), cpu[name], atol=5e-4, rtol=5e-4)
    assert checked >= 4
