"""The port's attention ops on the CPU (the kernels' plain versions)
against the JAX reference: ``repro.kernels.ref.attention``, the Pallas
kernels in interpret mode and the jnp decode path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attention as pallas_decode
from repro.kernels.flash_attn import flash_attention_fwd as pallas_flash
from repro_torch.kernels import decode_attn, flash_attn, ops, ref

TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}

ATTN_CASES = [
    # (B, H, KV, Sq, Skv, D, causal, window): a subset of test_kernels'
    # ATTN_SWEEP plus SmolLM-360M's head geometry at short S
    (1, 2, 2, 64, 64, 16, True, None),
    (2, 4, 2, 200, 200, 32, True, None),       # GQA + ragged tail
    (1, 8, 2, 96, 96, 32, True, 48),           # sliding window
    (2, 3, 1, 65, 130, 16, False, None),       # cross-attn Sq != Skv
    (1, 15, 5, 40, 40, 64, True, None),        # smollm-360m heads
]

DECODE_CASES = [
    # (B, H, KV, S, D, lengths): test_kernels' DECODE_SWEEP subset plus
    # SmolLM-360M heads with lengths 1 and S
    (3, 8, 2, 130, 32, [130, 64, 1]),
    (2, 2, 1, 64, 128, [64, 17]),
    (4, 15, 5, 96, 64, [1, 96, 33, 50]),
]


def _attn_inputs(B, H, KV, Sq, Skv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(s), dtype)
            for s in ((B, H, Sq, D), (B, KV, Skv, D), (B, KV, Skv, D))]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,D,causal,window", ATTN_CASES)
def test_flash_plain_vs_jax(B, H, KV, Sq, Skv, D, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(B, H, KV, Sq, Skv, D, dtype)
    want_ref = jref.attention(qj, kj, vj, causal=causal, window=window)
    want_pallas = jops.flash_attention(qj, kj, vj, causal=causal,
                                       window=window, use_pallas=True)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(np32(got), np32(want_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(np32(got), np32(want_pallas), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,H,KV,S,D,lens", DECODE_CASES)
def test_decode_plain_vs_jax(B, H, KV, S, D, lens):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.standard_normal(s))
        for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lj, lt = jnp.asarray(lens, jnp.int32), torch.tensor(lens, dtype=torch.int32)
    got = ops.decode_attention(qt, kt, vt, lt)
    for want in (jref.attention(qj, kj, vj, causal=False, kv_len=lj),
                 pallas_decode(qj, kj, vj, lj, block_k=64),
                 jops.decode_attention(qj, kj, vj, lj, use_pallas=True),
                 jops.decode_attention(qj, kj, vj, lj, use_pallas=False)):
        np.testing.assert_allclose(np32(got), np32(want), atol=2e-5,
                                   rtol=2e-5)
    # the port's own oracle agrees with its plain decode path
    np.testing.assert_allclose(np32(ref.decode_attention(qt, kt, vt, lt)),
                               np32(got), atol=2e-5, rtol=2e-5)


def test_decode_plain_bf16_vs_jax():
    B, H, KV, S, D = 2, 15, 5, 80, 64
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.standard_normal(s), jnp.bfloat16)
        for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lens = [80, 3]
    got = ops.decode_attention(qt, kt, vt, torch.tensor(lens))
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens, jnp.int32), block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-2, rtol=2e-2)


def test_pallas_flash_direct_matches_port_window_edge():
    """Window larger than a block and Sq not a multiple of it: the band's
    first tile holds rows with no valid key yet (the kernel must not let
    them leak into the row sum)."""
    (qj, qt), (kj, kt), (vj, vt) = _attn_inputs(1, 2, 1, 150, 150, 32,
                                                jnp.float32, seed=3)
    want = pallas_flash(qj, kj, vj, causal=True, window=70, block_q=64,
                        block_k=64)
    got = flash_attn.flash_attention_plain(qt, kt, vt, causal=True, window=70)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5, rtol=2e-5)


def test_kernel_wrappers_reject_cpu_tensors():
    """The wrappers launch kernels only; the CPU path is the ops' choice."""
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 1, 4, 32)
    before = (flash_attn.flash_attention_fwd.launches,
              decode_attn.decode_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.decode_attention(q[:, :, :1], k, k,
                                     torch.ones(1, dtype=torch.int32))
    assert (flash_attn.flash_attention_fwd.launches,
            decode_attn.decode_attention.launches) == before
