"""Kernel B5's plain version (the xLSTM mLSTM chunkwise scan), the
single-token mLSTM decode step and the sLSTM recurrence against the JAX
package on the CPU: the sequential oracle ``ref.mlstm``, the Pallas
kernel in interpret mode and the chunked jnp path, on the reference's
MLSTM_SWEEP plus S = 1, ragged tails, the model's chunk 256 and
xLSTM-1.3B's head width P = 1024, at the reference's mLSTM tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mlstm_scan import mlstm_chunk_scan as pallas_scan
from repro_torch.kernels import mlstm_scan, ops, ref

TOL = dict(atol=1e-4, rtol=1e-4)          # tests/test_kernels.py, mLSTM
# (B, S, H, P, chunk): MLSTM_SWEEP of tests/test_kernels.py, then S = 1,
# a ragged last chunk, the model's chunk 256 over a ragged tail, and
# xLSTM-1.3B's full head width P = 1024 at short S (ragged at chunk 4).
CASES = [(1, 64, 2, 8, 16), (2, 100, 2, 16, 32), (1, 130, 1, 32, 64),
         (1, 1, 2, 8, 16), (2, 37, 2, 16, 16), (1, 300, 2, 16, 256),
         (1, 8, 1, 1024, 256), (1, 7, 2, 1024, 4)]


def _inputs(B, S, H, P, seed=0, dtype=jnp.float32):
    """(jax arrays, torch tensors) of q, k, v, i_pre, f_pre from numpy,
    with the forget gate biased open as in the reference's test."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, S, H, P)) for _ in range(3)]
    arrays += [rng.standard_normal((B, S, H)),
               rng.standard_normal((B, S, H)) + 1.0]
    pairs = [both(a, dtype) for a in arrays[:3]] + [both(a) for a in arrays[3:]]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _assert_state_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **TOL)


@pytest.mark.parametrize("B,S,H,P,chunk", CASES)
def test_plain_scan_vs_jax(B, S, H, P, chunk):
    jargs, targs = _inputs(B, S, H, P)
    h, (C, n, m) = mlstm_scan.mlstm_chunk_scan_plain(*targs, chunk=chunk)
    assert h.shape == (B, S, H, P) and C.shape == (B, H, P, P)
    assert n.shape == (B, H, P) and m.shape == (B, H)
    assert all(t.dtype == torch.float32 for t in (C, n, m))
    hr, state_r = jref.mlstm(*jargs)
    hj, state_j = jops.mlstm_scan(*jargs, chunk=chunk, use_pallas=False)
    hp, (Cp, np_, mp) = pallas_scan(*jargs, chunk=chunk)   # interpret mode
    for want_h, want_state in ((hr, state_r), (hj, state_j),
                               (hp, (Cp, np_[..., 0], mp))):
        np.testing.assert_allclose(np32(h), np32(want_h), **TOL)
        _assert_state_close((C, n, m), want_state)


@pytest.mark.parametrize("B,S,H,P,chunk", CASES[:3])
def test_sequential_oracle_vs_jax(B, S, H, P, chunk):
    """The port's own oracle, from a carried state, against the
    reference's."""
    jargs, targs = _inputs(B, S, H, P, seed=1)
    rng = np.random.default_rng(2)
    jC, tC = both(rng.standard_normal((B, H, P, P)) * 0.1)
    jn, tn = both(rng.standard_normal((B, H, P)) * 0.1)
    jm, tm = both(rng.standard_normal((B, H)))
    h, state = ref.mlstm(*targs, state=(tC, tn, tm))
    hr, state_r = jref.mlstm(*jargs, state=(jC, jn, jm))
    np.testing.assert_allclose(np32(h), np32(hr), **TOL)
    _assert_state_close(state, state_r)


def test_plain_scan_bf16_vs_jax():
    """bf16 q, k, v (the serving dtype): h rounds to bf16 in both; the
    f32 sums before the rounding differ in order, so 1 bf16 ulp. The f32
    state is held at the f32 tolerance."""
    jargs, targs = _inputs(1, 130, 2, 32, seed=3, dtype=jnp.bfloat16)
    h, state = mlstm_scan.mlstm_chunk_scan_plain(*targs, chunk=64)
    hj, state_j = jops.mlstm_scan(*jargs, chunk=64, use_pallas=False)
    assert h.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(h), np32(hj), atol=2e-2, rtol=2e-2)
    _assert_state_close(state, state_j)


@pytest.mark.parametrize("S", [1, 9, 70])
def test_decode_step_after_scan_vs_sequential_oracle(S):
    """A prefill of S tokens by the plain scan, then one decode step,
    equals the sequential oracle over S + 1 tokens and the reference's
    own decode step."""
    B, H, P = 2, 2, 16
    jargs, targs = _inputs(B, S + 1, H, P, seed=S)
    _, state = mlstm_scan.mlstm_chunk_scan_plain(
        *(t[:, :S] for t in targs), chunk=32)
    h_t, new = ops.mlstm_decode_step(state, *(t[:, S] for t in targs))
    hr, state_r = jref.mlstm(*jargs)
    np.testing.assert_allclose(np32(h_t), np32(hr[:, S]), **TOL)
    _assert_state_close(new, state_r)
    jh, jnew = jops.mlstm_decode_step(
        tuple(jnp.asarray(np32(t)) for t in state), *(a[:, S] for a in jargs))
    np.testing.assert_allclose(np32(h_t), np32(jh), **TOL)
    _assert_state_close(new, jnew)


@pytest.mark.parametrize("B,S,d", [(1, 1, 8), (2, 13, 16), (1, 40, 64)])
def test_slstm_scan_vs_jax(B, S, d):
    rng = np.random.default_rng(S)
    jx, tx = both(rng.standard_normal((B, S, 4 * d)))
    jwh, twh = both(rng.standard_normal((d, 4 * d)) / np.sqrt(d))
    state = [both(rng.standard_normal((B, d)) * s) for s in (0.5, 0.5, 0.5)]
    state.append(both(rng.standard_normal((B, d))))
    state[1] = both(np.abs(np32(state[1][1])) + 1.0)     # n > 0
    hs, carry = ops.slstm_scan(tx, twh, *(t for _, t in state))
    jhs, jcarry = jops.slstm_scan(jx, jwh, *(j for j, _ in state))
    np.testing.assert_allclose(np32(hs), np32(jhs), **TOL)
    _assert_state_close(carry, jcarry)


def test_cpu_takes_the_plain_version_and_the_kernel_refuses_it():
    _, targs = _inputs(1, 40, 2, 8)
    n0 = mlstm_scan.mlstm_chunk_scan.launches
    h, (C, n, m) = ops.mlstm_scan(*targs, chunk=16)
    hp, (Cp, np_, mp) = mlstm_scan.mlstm_chunk_scan_plain(*targs, chunk=16)
    assert torch.equal(h, hp) and torch.equal(C, Cp)
    assert torch.equal(n, np_) and torch.equal(m, mp)
    assert mlstm_scan.mlstm_chunk_scan.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan.mlstm_chunk_scan(*targs, chunk=16)
