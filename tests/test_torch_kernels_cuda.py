"""The hand-written CUDA kernels against their plain PyTorch versions on
a card. Imports neither JAX nor the JAX package, so it runs on the GPU
machine: ``PYTHONPATH=src python -m pytest -q -m requires_cuda
tests/test_torch_kernels_cuda.py``. Every test skips without a card."""
import pytest
import torch

from repro_torch.kernels import (decode_attn, flash_attn, mamba_scan,
                                 mlstm_scan, ops, split_quant)


def require_cuda():
    """Skip the calling test unless a CUDA card is present. Called inside
    the test, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


DECODE_CASES = [
    (3, 8, 2, 130, 32, [130, 64, 1]),
    (2, 2, 1, 64, 128, [64, 17]),
    (4, 15, 5, 96, 64, [1, 96, 33, 50]),
    (8, 15, 5, 2048, 64, [1, 2048, 100, 513, 1024, 37, 2000, 777]),
    (8, 32, 32, 2048, 64, [1, 2048, 100, 513, 1024, 37, 2000, 777]),  # Zamba2
    (3, 4, 4, 130, 16, [130, 64, 1]),             # smoke configs' heads, D=16
    (2, 4, 2, 64, 16, [64, 17]),
    # head dim 128 in the 8-head bucket: groups 6 (InternLM2-20B) and 7
    # (Qwen2-VL-7B), at the serving cache and ragged
    (8, 48, 8, 2048, 128, [1, 2048, 100, 513, 1024, 37, 2000, 777]),
    (8, 28, 4, 2048, 128, [1, 2048, 100, 513, 1024, 37, 2000, 777]),
    (3, 12, 2, 300, 128, [300, 1, 129]),
    (2, 14, 2, 130, 128, [130, 64]),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,D,causal,window", [
    (1, 15, 5, 77, 77, 64, True, None),
    (2, 4, 2, 200, 200, 32, True, None),
    (1, 8, 2, 150, 150, 32, True, 70),
    (2, 3, 1, 65, 130, 32, False, None),
    (1, 32, 32, 300, 300, 64, True, None),        # Zamba2's MHA, group 1
    (2, 4, 4, 150, 150, 16, True, None),          # smoke configs' heads, D=16
    (1, 4, 2, 100, 100, 16, True, 30),
    # the serving paths' prefill shapes: SmolLM at the longest served
    # prompt (498) and at 512, Zamba2's MHA at 498
    (1, 15, 5, 498, 498, 64, True, None),
    (1, 15, 5, 512, 512, 64, True, None),
    (1, 32, 32, 498, 498, 64, True, None),
    # Sq not a multiple of the 64-row q tile, Sq != Skv both ways
    # (top-left-aligned causal band), a window crossing tile edges
    (2, 4, 2, 100, 164, 64, True, None),
    (1, 4, 2, 150, 70, 32, True, None),
    (1, 6, 3, 201, 201, 64, True, 90),
    # head dim 128: groups 4 (Llama-3-8B, Mixtral, Phi-3.5-MoE), 6
    # (InternLM2-20B) and 7 (Qwen2-VL-7B), a window (Mixtral's, scaled
    # down), ragged Skv both ways, non-causal
    (1, 32, 8, 512, 512, 128, True, None),
    (1, 48, 8, 300, 300, 128, True, None),
    (1, 28, 4, 257, 257, 128, True, None),
    (1, 8, 2, 700, 700, 128, True, 256),
    (2, 4, 2, 100, 164, 128, True, None),
    (1, 4, 2, 150, 70, 128, True, None),
    (2, 3, 1, 65, 130, 128, False, None),
])
def test_flash_kernel_vs_plain(B, H, KV, Sq, Skv, D, causal, window, dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D))]
    got = flash_attn.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,S,window", [(32, 8, 512, None),
                                           (48, 8, 300, None),
                                           (28, 4, 257, 100),
                                           (8, 2, 700, 256)])
def test_flash_kernel_lse_at_head_dim_128(H, KV, S, window, dtype):
    """B2 at head dim 128 with its lse output (the training path's launch)
    against the plain version, and the same launch without lse giving
    the same output bit for bit."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((1, H, S, 128), (1, KV, S, 128), (1, KV, S, 128))]
    n0 = flash_attn.flash_attention_fwd.launches
    o, lse = flash_attn.flash_attention_fwd(q, k, v, window=window, lse=True)
    bare = flash_attn.flash_attention_fwd(q, k, v, window=window)
    po, plse = flash_attn.flash_attention_lse_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attn.flash_attention_fwd.launches == n0 + 2
    assert torch.equal(o, bare)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=tol, rtol=tol)


@pytest.mark.requires_cuda
def test_flash_kernel_refuses_other_head_dims():
    dev = require_cuda()
    for D in (8, 48, 96, 256):
        q = torch.randn(1, 2, 8, D, device=dev)
        with pytest.raises(ValueError, match="unsupported shapes"):
            flash_attn.flash_attention_fwd(q, q, q)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,lens", DECODE_CASES)
def test_decode_kernel_vs_plain(B, H, KV, S, D, lens, dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = decode_attn.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(15, 5, 64), (32, 32, 64), (4, 4, 16),
                                    (8, 2, 128), (6, 2, 32), (48, 8, 128),
                                    (28, 4, 128)])
def test_decode_kernel_lengths_straddling_split_edges(H, KV, D, dtype):
    """Lengths inside the first split, on its edge, one past it, across
    several splits, and the whole cache, with empty splits after them."""
    dev = require_cuda()
    r = decode_attn.split_rows(D, dtype)
    S = 4 * r + 3
    lens = [r // 2 + 1, r, r + 1, 3 * r, 3 * r - 7, 1, S]
    B = len(lens)
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = decode_attn.decode_attention.launches
    got = decode_attn.decode_attention(q, k, v, lengths)
    want = decode_attn.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == n0 + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic(dtype):
    """The split records merge in a fixed order: two runs, same bits."""
    dev = require_cuda()
    B, H, KV, S, D, lens = DECODE_CASES[3]
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = [torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = decode_attn.decode_attention(q, k, v, lengths)
    second = decode_attn.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _quant_input(rows, d, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=dev) * 7.3
    x[::7] = 0.0                                   # all-zero rows
    if d >= 8:                                     # exact .5 ties
        x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5,
                                 -3.5], device=dev)
    return x.to(dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(6272, 128), (392, 3), (1000, 130),
                                    (37, 64), (9, 8), (1, 1)])
def test_quant_kernel_bit_exact_vs_plain(rows, d, dtype):
    dev = require_cuda()
    x = _quant_input(rows, d, dtype, dev)
    q, s = split_quant.quantize_rows(x)
    qp, sp = split_quant.quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.requires_cuda
def test_quant_kernel_unaligned_view_takes_the_scalar_path():
    dev = require_cuda()
    base = _quant_input(65, 128, torch.float32, dev).reshape(-1)
    x = base[1:1 + 64 * 128].view(64, 128)         # 4-byte, not 16, aligned
    q, s = split_quant.quantize_rows(x)
    qp, sp = split_quant.quantize_rows_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.requires_cuda
def test_ste_quantize_on_the_card_counts_launches():
    dev = require_cuda()
    x = _quant_input(8 * 28 * 28, 128, torch.float32, dev).reshape(
        8, 28, 28, 128).requires_grad_()
    n0 = split_quant.quantize_dequantize.launches
    r0, c0 = split_quant.quantize_rows.launches, split_quant.copies
    y = ops.ste_quantize(x)
    (y * 3.0).sum().backward()
    assert split_quant.quantize_dequantize.launches == n0 + 1
    assert split_quant.quantize_rows.launches == r0
    assert split_quant.copies == c0
    q, s = split_quant.quantize_rows_plain(x.detach().reshape(-1, 128))
    assert torch.equal(y.detach().reshape(-1, 128), q.float() * s)
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


def _as_layout(x, layout):
    """x (N, H, W, C) with the same values, NHWC-contiguous ("rows") or as
    the NHWC view of NCHW memory that a conv stage hands over
    ("channels")."""
    if layout == "rows":
        return x.contiguous()
    return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


# (N, H, W, C): ResNet-18's l2 boundary at batch 8 (6,272 rows of 128),
# the autoencoder latent (392 rows of 3), C = 130 (no 16-byte vectors),
# a ragged last tile of pixels (N H W = 45) and the widest channel-major
# rows the kernel reads in place (C = 256, ResNet-18's l3 width)
QUANT_BOUNDARIES = [(8, 28, 28, 128), (8, 7, 7, 3), (2, 5, 5, 130),
                    (1, 5, 9, 16), (1, 4, 8, 256)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["rows", "channels"])
@pytest.mark.parametrize("shape", QUANT_BOUNDARIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_entries_bit_exact_on_both_layouts(shape, layout, dtype):
    dev = require_cuda()
    N, H, W, C = shape
    x = _as_layout(_quant_input(N * H * W, C, dtype, dev).reshape(shape),
                   layout)
    c0 = split_quant.copies
    y = split_quant.quantize_dequantize(x)
    q, s = split_quant.quantize_rows(x)
    yp = split_quant.quantize_dequantize_plain(x)
    qp, sp = split_quant.quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert split_quant.copies == c0
    assert y.dtype == dtype and y.shape == x.shape
    assert y.stride() == x.stride() and yp.stride() == x.stride()
    assert torch.equal(y, yp)
    assert q.shape == (N * H * W, C) and s.shape == (N * H * W, 1)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["rows", "channels"])
def test_ste_quantize_one_launch_no_copy(layout):
    dev = require_cuda()
    x = _as_layout(_quant_input(8 * 28 * 28, 128, torch.float32, dev)
                   .reshape(8, 28, 28, 128), layout).requires_grad_()
    n0, c0 = split_quant.quantize_dequantize.launches, split_quant.copies
    y = ops.ste_quantize(x)
    assert split_quant.quantize_dequantize.launches == n0 + 1
    assert split_quant.copies == c0
    assert y.stride() == x.stride()
    assert torch.equal(y.detach(), split_quant.quantize_dequantize_plain(
        x.detach()))
    g = torch.randn_like(x)
    y.backward(g)
    assert torch.equal(x.grad, g)


@pytest.mark.requires_cuda
def test_quant_layout_off_both_paths_is_copied_and_counted():
    dev = require_cuda()
    base = _quant_input(2 * 6 * 6, 16, torch.float32, dev).reshape(
        2, 6, 6, 16)
    x = base.permute(0, 3, 1, 2).contiguous().permute(0, 3, 2, 1)  # H, W swapped
    assert split_quant.layout(x) is None
    c0 = split_quant.copies
    y = split_quant.quantize_dequantize(x)
    assert split_quant.copies == c0 + 1
    assert torch.equal(y, split_quant.quantize_dequantize_plain(x))


# (B, S, H, P, N, chunk): the reference's MAMBA_SWEEP, S = 1, and
# Zamba2-1.2B's full-width heads (H=64, P=N=64) with ragged last chunks.
MAMBA_CASES = [
    (1, 64, 2, 8, 4, 32), (2, 100, 3, 16, 8, 32), (1, 257, 4, 32, 16, 64),
    (1, 1, 64, 64, 64, 128), (1, 100, 64, 64, 64, 128),
    (2, 257, 64, 64, 64, 128), (1, 512, 64, 64, 64, 128),
    (1, 130, 2, 64, 16, 128),
]


def _mamba_inputs(B, S, H, P, N, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    x = rnd(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    a_log = rnd(H) * 0.5
    return x, dt, a_log, rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", MAMBA_CASES)
def test_mamba_kernel_vs_plain(B, S, H, P, N, chunk, dtype):
    dev = require_cuda()
    args = _mamba_inputs(B, S, H, P, N, dtype, dev)
    n0 = mamba_scan.mamba_chunk_scan.launches
    y, h = mamba_scan.mamba_chunk_scan(*args, chunk=chunk)
    yp, hp = mamba_scan.mamba_chunk_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mamba_scan.mamba_chunk_scan.launches == n0 + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    # f32: the reference's scan tolerance; bf16: y rounds to bf16 after
    # f32 sums taken in another order (1 ulp = 2**-8 relative)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hp, atol=tol, rtol=tol)


@pytest.mark.requires_cuda
def test_mamba_kernel_rejects_what_it_does_not_take():
    dev = require_cuda()
    x, dt, a_log, b, c = _mamba_inputs(1, 300, 2, 64, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="chunk"):
        mamba_scan.mamba_chunk_scan(x, dt, a_log, b, c, chunk=256)
    with pytest.raises(ValueError, match="dtypes"):
        mamba_scan.mamba_chunk_scan(x, dt.bfloat16(), a_log, b, c)
    b, c = torch.zeros(1, 300, 128, device=dev), torch.zeros(1, 300, 128,
                                                             device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        mamba_scan.mamba_chunk_scan(x, dt, a_log, b, c)   # N=128: no room


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_kernel_counts_one_launch_per_call(dtype):
    """The bf16 path's three stages (and f32's one kernel) count once, and
    two runs give the same bits."""
    dev = require_cuda()
    args = _mamba_inputs(1, 300, 64, 64, 64, dtype, dev)
    n0 = mamba_scan.mamba_chunk_scan.launches
    outs = [mamba_scan.mamba_chunk_scan(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert mamba_scan.mamba_chunk_scan.launches == n0 + 3
    assert torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(outs[0][1], outs[2][1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 300, 2, 64, 128, 128),
                                             (2, 77, 3, 72, 24, 16),
                                             (1, 50, 2, 70, 5, 32),
                                             (1, 45, 2, 9, 7, 32)])
def test_mamba_bf16_takes_wide_states_and_odd_tiles(B, S, H, P, N, chunk):
    """The tensor-core path at N = 128 (the f32 kernel's shared memory
    does not hold it at chunk 128), P past one 64-row tile, N off the
    16-column tile, and P and N that are not multiples of 8 (element
    loads instead of 16-byte copies; odd P: element stores)."""
    dev = require_cuda()
    args = _mamba_inputs(B, S, H, P, N, torch.bfloat16, dev)
    y, h = mamba_scan.mamba_chunk_scan(*args, chunk=chunk)
    yp, hp = mamba_scan.mamba_chunk_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), yp.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h, hp, atol=2e-2, rtol=2e-2)


@pytest.mark.requires_cuda
def test_mamba_bf16_rejects_states_past_its_tiles():
    dev = require_cuda()
    args = _mamba_inputs(1, 40, 2, 64, 136, torch.bfloat16, dev)
    n0 = mamba_scan.mamba_chunk_scan.launches
    with pytest.raises(ValueError, match="state width"):
        mamba_scan.mamba_chunk_scan(*args)
    assert mamba_scan.mamba_chunk_scan.launches == n0


def _smoke_on_card_vs_cpu(arch, n_layers=None):
    """The smoke LM of ``arch`` in f32 on the card (through its kernels)
    and on the CPU (their plain versions), from the same weights: the
    prefill logits and one decode step's logits of each."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.param import map_tree

    dev = require_cuda()
    cfg = configs.get_smoke(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", dev):
        p = map_tree(lambda t: t.to(d), params)
        ctx = Ctx(cfg=cfg, mode="prefill", act_dtype=torch.float32)
        logits, _, caches = lm.forward(cfg, p, tokens.to(d), ctx=ctx)
        cache = lm.cache_from_prefill(cfg, caches, 160, torch.float32)
        step, _ = lm.decode_step(
            cfg, p, cache, tokens[:, -1:].to(d),
            torch.tensor([150, 150], device=d),
            ctx=Ctx(cfg=cfg, mode="decode", act_dtype=torch.float32))
        out[str(d)] = (logits.cpu(), step.cpu())
    return out[str(dev)], out["cpu"]


@pytest.mark.requires_cuda
def test_zamba2_smoke_prefill_and_decode_on_the_card():
    """The Zamba2 smoke LM, unmodified (head dim 16), in f32 through the
    three kernels against the same model's plain path on the CPU."""
    n0 = flash_attn.flash_attention_fwd.launches
    got, want = _smoke_on_card_vs_cpu("zamba2_1_2b")
    assert flash_attn.flash_attention_fwd.launches > n0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.requires_cuda
def test_xlstm_smoke_prefill_and_decode_on_the_card():
    """The two-unit xLSTM smoke LM in f32 through the mLSTM kernel (one
    launch per mLSTM block) against its plain path on the CPU."""
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    got, want = _smoke_on_card_vs_cpu("xlstm_1_3b", n_layers=8)
    assert mlstm_scan.mlstm_chunk_scan.launches == n0 + 6
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("argv", [
    ["--arch", "zamba2_1_2b", "--cut", "1"],
    ["--arch", "xlstm_1_3b"],
])
def test_serve_cli_on_the_card(argv):
    """The serving CLI on its default device, the card, with the smoke
    configs as they are (Zamba2's head dim 16 through B2 and B3)."""
    from repro_torch.launch import serve

    require_cuda()
    out = serve.main(argv + ["--requests", "3", "--new-tokens", "4"])
    assert sorted(out) == [0, 1, 2] and all(len(t) == 4 for t in out.values())


# (B, S, H, P, chunk): the reference's MLSTM_SWEEP, a P that is not a
# multiple of the kernel's 32-column value tile, the xLSTM smoke width
# P=64, and xLSTM-1.3B's full-width heads (H=4, P=1024) at S = 1, ragged
# tails, two batch rows and the model's chunk 256 (the kernel takes 64).
MLSTM_CASES = [
    (1, 64, 2, 8, 16), (2, 100, 2, 16, 32), (1, 130, 1, 32, 64),
    (1, 130, 1, 40, 64), (1, 300, 2, 64, 256),
    (1, 1, 4, 1024, 256), (1, 100, 4, 1024, 256), (2, 257, 4, 1024, 256),
    (1, 512, 4, 1024, 256),
    # one position, a chunk shorter than one 16-row mma tile (S = 15) and
    # one reaching just into a second (S = 17), P = 40 (a tensor-core tile
    # of 48 keys, zero-padded) with two batch rows, and xLSTM's longest
    # served prompt (498, ragged last chunk)
    (1, 1, 2, 64, 256), (1, 15, 4, 1024, 256), (1, 17, 4, 1024, 256),
    (2, 130, 2, 40, 64), (1, 498, 4, 1024, 256),
]


def _mlstm_inputs(B, S, H, P, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    q, k, v = (rnd(B, S, H, P).to(dtype) for _ in range(3))
    return q, k, v, rnd(B, S, H), rnd(B, S, H) + 1.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,chunk", MLSTM_CASES)
def test_mlstm_kernel_vs_plain(B, S, H, P, chunk, dtype):
    dev = require_cuda()
    args = _mlstm_inputs(B, S, H, P, dtype, dev)
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    h, (C, n, m) = mlstm_scan.mlstm_chunk_scan(*args, chunk=chunk)
    hp, (Cp, np_, mp) = mlstm_scan.mlstm_chunk_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mlstm_scan.mlstm_chunk_scan.launches == n0 + 1
    assert h.dtype == dtype and n.shape == (B, H, P, 1)
    # h: f32 at the reference's mLSTM tolerance, bf16 one ulp after f32
    # sums taken in another order; the f32 state at the f32 tolerance
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(h.float(), hp.float(), atol=tol, rtol=tol)
    for got, want in ((C, Cp), (n[..., 0], np_), (m, mp)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.requires_cuda
def test_mlstm_op_on_the_card_squeezes_n_and_counts():
    dev = require_cuda()
    args = _mlstm_inputs(1, 70, 2, 64, torch.bfloat16, dev)
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    h, (C, n, m) = ops.mlstm_scan(*args)
    assert mlstm_scan.mlstm_chunk_scan.launches == n0 + 1
    assert n.shape == (1, 2, 64) and C.shape == (1, 2, 64, 64)


@pytest.mark.requires_cuda
def test_mlstm_kernel_rejects_what_it_does_not_take():
    dev = require_cuda()
    q, k, v, i_pre, f_pre = _mlstm_inputs(1, 40, 2, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="dtypes"):
        mlstm_scan.mlstm_chunk_scan(q, k, v, i_pre.bfloat16(), f_pre)
    with pytest.raises(ValueError, match="shapes"):
        mlstm_scan.mlstm_chunk_scan(q, k[:, :39], v, i_pre, f_pre)
    big = torch.zeros(1, 4, 1, 2048, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):   # C too wide
        mlstm_scan.mlstm_chunk_scan(big, big, big, i_pre[:, :4, :1],
                                    f_pre[:, :4, :1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_counts_one_launch_per_call(dtype):
    """The bf16 path's three stages (and f32's one kernel) count once."""
    dev = require_cuda()
    args = _mlstm_inputs(1, 130, 4, 1024, dtype, dev)
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    for _ in range(3):
        mlstm_scan.mlstm_chunk_scan(*args)
    torch.cuda.synchronize()
    assert mlstm_scan.mlstm_chunk_scan.launches == n0 + 3


@pytest.mark.requires_cuda
def test_mlstm_bf16_rejects_widths_off_the_tensor_core_tiles():
    dev = require_cuda()
    for P in (12, 1032):
        args = _mlstm_inputs(1, 20, 1, P, torch.bfloat16, dev)
        n0 = mlstm_scan.mlstm_chunk_scan.launches
        with pytest.raises(ValueError, match="head width"):
            mlstm_scan.mlstm_chunk_scan(*args)
        assert mlstm_scan.mlstm_chunk_scan.launches == n0
