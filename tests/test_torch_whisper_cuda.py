"""Whisper's kernels and model on a card: B2 non-causal at the encoder's
1,500 frames (Sq = Skv) and at cross-attention's Sq != Skv = 1,500, with
its lse and its autograd Function, and B3 over a fixed 1,500-row memory
at full length (group 1), each against its plain version; the smoke
config's prefill, decode steps and loss on the card against the CPU,
with exact launch counts; ``launch.train --arch whisper_small`` on the
card. Imports neither JAX nor the JAX package: ``PYTHONPATH=src python
-m pytest -q -m requires_cuda tests/test_torch_whisper_cuda.py``. Every
test skips without a card."""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import decode_attn, flash_attn, ops
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import map_tree
from repro_torch.train.step import TrainConfig, loss_and_grads
from repro_torch.utils.treeutil import tree_flatten_with_names

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
FRAMES = 1500                       # whisper-small's encoder length


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided inside
    the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq", [(1, FRAMES), (8, 64), (2, 1)])
def test_flash_non_causal_vs_plain(B, Sq, dtype):
    """12 MHA heads of 64 against 1,500 keys: the encoder (Sq = 1,500,
    ragged last q and KV tiles), the decoder's prompt, one query row;
    output and lse, then the Function's gradients."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(Sq)
    H, D = 12, 64
    q, k, v, do = [torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((B, H, Sq, D), (B, H, FRAMES, D),
                             (B, H, FRAMES, D), (B, H, Sq, D))]
    n0 = flash_attn.flash_attention_fwd.launches
    o = flash_attn.flash_attention_fwd(q, k, v, causal=False)
    o2, lse = flash_attn.flash_attention_fwd(q, k, v, causal=False, lse=True)
    assert flash_attn.flash_attention_fwd.launches == n0 + 2
    po, plse = flash_attn.flash_attention_lse_plain(q, k, v, causal=False)
    for got in (o, o2):
        torch.testing.assert_close(got.float(), po.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=TOL[dtype], rtol=TOL[dtype])
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ts, causal=False), ts, do)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attn.flash_attention_plain(
        *ts, causal=False), ts, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD[dtype],
                                   rtol=GRAD[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_over_the_full_memory_vs_plain(dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, D = 8, 12, 64
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, 1, D), (B, H, FRAMES, D), (B, H, FRAMES, D))]
    lengths = torch.full((B,), FRAMES, dtype=torch.int32, device=dev)
    got = decode_attn.decode_attention(q, k, v, lengths)
    assert torch.equal(got, decode_attn.decode_attention(q, k, v, lengths))
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _smoke_model():
    cfg = configs.get_smoke("whisper_small")
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g,
                           dtype=torch.int32)
    frames = torch.randn((2, cfg.frontend_len, cfg.d_model), generator=g) * .1
    return cfg, params, tokens, frames


@pytest.mark.requires_cuda
def test_smoke_prefill_and_decode_on_the_card_vs_cpu():
    """f32 prefill logits and caches, then 4 decode steps, on the card
    against the CPU; 3 B2 a layer a prefill (encoder, self, cross), 2 B3
    a layer a decode step (self, cross); the cross cache unchanged."""
    dev = require_cuda()
    cfg, params, tokens, frames = _smoke_model()
    card = map_tree(lambda t: t.to(dev), params)
    ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
    dctx = dataclasses.replace(ctx, mode="decode")
    n_b2 = flash_attn.flash_attention_fwd.launches
    n_b3 = decode_attn.decode_attention.launches
    with torch.no_grad():
        lc, _, cc = lm.forward(cfg, card, tokens.to(dev), ctx=ctx,
                               enc_frames=frames.to(dev))
        lp, _, cp = lm.forward(cfg, params, tokens, ctx=ctx,
                               enc_frames=frames)
        assert flash_attn.flash_attention_fwd.launches - n_b2 == \
            3 * cfg.n_layers
        torch.testing.assert_close(lc.cpu(), lp, atol=1e-4, rtol=1e-4)
        cache_c = lm.cache_from_prefill(cfg, cc, 20, torch.float32)
        cache_p = lm.cache_from_prefill(cfg, cp, 20, torch.float32)
        cross0 = map_tree(torch.clone, cache_c["0:attn"]["cross"])
        tok = tokens[:, -1:]
        for t in range(12, 16):
            pos = torch.full((2,), t, dtype=torch.int32)
            dc, _ = lm.decode_step(cfg, card, cache_c, tok.to(dev),
                                   pos.to(dev), ctx=dctx)
            dp, _ = lm.decode_step(cfg, params, cache_p, tok, pos, ctx=dctx)
            torch.testing.assert_close(dc.cpu(), dp, atol=1e-4, rtol=1e-4)
            tok = dp[:, :, :].argmax(-1).to(torch.int32)
    assert decode_attn.decode_attention.launches - n_b3 == 4 * 2 * cfg.n_layers
    for kk in ("k", "v"):
        assert torch.equal(cache_c["0:attn"]["cross"][kk], cross0[kk])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_smoke_loss_and_grads_on_the_card_vs_cpu(remat):
    """One f32 loss and gradient on the card against the CPU; every
    projection weight (encoder, self, cross, MLP) gets a gradient."""
    dev = require_cuda()
    cfg, params, tokens, frames = _smoke_model()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "enc_frames": frames}
    tcfg = TrainConfig(act_dtype=torch.float32, remat=remat)
    lp, _, gp = loss_and_grads(cfg, tcfg, params, batch)
    lc, _, gc = loss_and_grads(cfg, tcfg, map_tree(lambda t: t.to(dev),
                                                   params),
                               {k: v.to(dev) for k, v in batch.items()})
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    cpu = dict(tree_flatten_with_names(gp))
    for name, g in tree_flatten_with_names(gc):
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo", "wi"):
            assert bool((g != 0).any()), name
        torch.testing.assert_close(g.cpu(), cpu[name], atol=5e-4, rtol=5e-4)


@pytest.mark.requires_cuda
def test_launch_train_whisper_on_the_card(capsys):
    require_cuda()
    from repro_torch.launch import train as launch_train
    losses = launch_train.main(["--arch", "whisper_small", "--smoke",
                                "--steps", "4", "--batch", "2", "--seq",
                                "32", "--log-every", "2"])
    assert len(losses) == 4 and all(torch.isfinite(torch.tensor(losses)))
    assert "final loss" in capsys.readouterr().out
