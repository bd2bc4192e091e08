"""Kernel B4's plain version (the Mamba-2 SSD chunked scan) and the
single-token decode step against the JAX package on the CPU: the
sequential oracle ``ref.mamba_ssd``, the Pallas kernel in interpret mode
and the chunked jnp path, on the reference's MAMBA_SWEEP plus S = 1, at
the reference's scan tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_chunk_scan as pallas_scan
from repro_torch.kernels import mamba_scan, ops, ref

TOL = dict(atol=5e-4, rtol=5e-4)          # tests/test_kernels.py, scans
# (B, S, H, P, N, chunk): MAMBA_SWEEP of tests/test_kernels.py, then S = 1
# (chunk = min(chunk, S) = 1) and a ragged chunk at the port's width P=64.
CASES = [(1, 64, 2, 8, 4, 32), (2, 100, 3, 16, 8, 32),
         (1, 257, 4, 32, 16, 64), (1, 1, 2, 8, 4, 32),
         (1, 130, 2, 64, 16, 128)]


def _inputs(B, S, H, P, N, seed=0, dtype=jnp.float32):
    """(jax arrays, torch tensors) of x, dt, a_log, b, c from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))      # softplus
    a_log = rng.standard_normal(H) * 0.5
    b, c = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    pairs = [both(x, dtype), both(dt), both(a_log), both(b, dtype),
             both(c, dtype)]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_plain_scan_vs_jax(B, S, H, P, N, chunk):
    jargs, targs = _inputs(B, S, H, P, N)
    y, h = mamba_scan.mamba_chunk_scan_plain(*targs, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    assert h.dtype == torch.float32
    yr, hr = jref.mamba_ssd(*jargs)
    yp, hp = pallas_scan(*jargs, chunk=chunk)           # interpret mode
    yj, hj = jops.mamba_scan(*jargs, chunk=chunk, use_pallas=False)
    for want_y, want_h in ((yr, hr), (yp, hp), (yj, hj)):
        np.testing.assert_allclose(np32(y), np32(want_y), **TOL)
        np.testing.assert_allclose(np32(h), np32(want_h), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES[:3])
def test_sequential_oracle_vs_jax(B, S, H, P, N, chunk):
    jargs, targs = _inputs(B, S, H, P, N, seed=1)
    rng = np.random.default_rng(2)
    jh0, th0 = both(rng.standard_normal((B, H, P, N)))
    y, h = ref.mamba_ssd(*targs, h0=th0)
    yr, hr = jref.mamba_ssd(*jargs, h0=jh0)
    np.testing.assert_allclose(np32(y), np32(yr), **TOL)
    np.testing.assert_allclose(np32(h), np32(hr), **TOL)


def test_plain_scan_bf16_vs_jax():
    """bf16 x, b, c (the serving dtype): y rounds to bf16 in both; the
    f32 sums before the rounding differ in order, so 1 bf16 ulp."""
    jargs, targs = _inputs(1, 257, 4, 32, 16, seed=3, dtype=jnp.bfloat16)
    y, h = mamba_scan.mamba_chunk_scan_plain(*targs, chunk=64)
    yj, hj = jops.mamba_scan(*jargs, chunk=64, use_pallas=False)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(y), np32(yj), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(np32(h), np32(hj), **TOL)


@pytest.mark.parametrize("S", [1, 9, 70])
def test_decode_step_after_scan_vs_sequential_oracle(S):
    """A prefill of S tokens by the plain scan, then one decode step,
    equals the sequential oracle over S + 1 tokens (reference's own)."""
    B, H, P, N = 2, 3, 16, 8
    jargs, targs = _inputs(B, S + 1, H, P, N, seed=S)
    x, dt, a_log, b, c = targs
    _, h = mamba_scan.mamba_chunk_scan_plain(
        x[:, :S], dt[:, :S], a_log, b[:, :S], c[:, :S], chunk=32)
    y_t, h_new = ops.mamba_decode_step(h, x[:, S], dt[:, S], a_log, b[:, S],
                                       c[:, S])
    yr, hr = jref.mamba_ssd(*jargs)
    np.testing.assert_allclose(np32(y_t), np32(yr[:, S]), **TOL)
    np.testing.assert_allclose(np32(h_new), np32(hr), **TOL)
    jy, jh = jops.mamba_decode_step(jnp.asarray(np32(h)), *(
        a[:, S] if a.ndim > 1 else a for a in jargs))
    np.testing.assert_allclose(np32(y_t), np32(jy), **TOL)
    np.testing.assert_allclose(np32(h_new), np32(jh), **TOL)


def test_cpu_takes_the_plain_version_and_the_kernel_refuses_it():
    _, targs = _inputs(1, 40, 2, 8, 4)
    n0 = mamba_scan.mamba_chunk_scan.launches
    y, h = ops.mamba_scan(*targs, chunk=16)
    yp, hp = mamba_scan.mamba_chunk_scan_plain(*targs, chunk=16)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert mamba_scan.mamba_chunk_scan.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan.mamba_chunk_scan(*targs, chunk=16)
