"""The hand-written CUDA kernels against their plain PyTorch versions on
a card. Imports neither JAX nor the JAX package, so it runs on the GPU
machine: ``PYTHONPATH=src python -m pytest -q -m requires_cuda
tests/test_torch_kernels_cuda.py``. Every test skips without a card."""
import pytest
import torch

from repro_torch.kernels import decode_attn, flash_attn


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
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,D,causal,window", [
    (1, 15, 5, 77, 77, 64, True, None),
    (2, 4, 2, 200, 200, 32, True, None),
    (1, 8, 2, 150, 150, 32, True, 70),
    (2, 3, 1, 65, 130, 32, False, None),
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
