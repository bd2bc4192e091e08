"""The arithmetic of kernel B5's bf16 path (``csrc/mlstm_scan.cu``),
written out here in plain torch and held against the JAX package on the
CPU, so that the precision scheme is shown to hold before the card runs
it:

- a gate prepass per chunk (the cumulative log f, the running max of
  log i - b) and the chunk-to-chunk stabilizer chain
  m_end(c) = max(m_intra_{L-1}(c), b_tot(c) + m_end(c-1)), computed from
  the gates alone, against ``repro.kernels.ref.mlstm``'s m;
- every product with one exact bf16 operand (q, k or v) and the other, f32
  one (C, W or wk v) split into hi = bf16(x) and lo = bf16(x - hi), run as
  two products summed in f32, against ``repro.kernels.ops.mlstm_scan``'s
  jnp path for h, C and n and ``ref.mlstm`` for m, at the reference's
  mLSTM tolerance; and that rounding those operands to bf16 once instead
  would miss it.

Inputs are rounded to bf16 from a numpy seed, one head of xLSTM-1.3B's
width P = 1024, 200 positions in chunks of 64 (the kernel's)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_helpers import np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref

TOL = dict(atol=1e-4, rtol=1e-4)          # tests/test_kernels.py, mLSTM
NEG_INF = -1e30


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _inputs(S, P, seed=0):
    """q, k, v (S, P) holding bf16 values, i_pre and f_pre (S,) f32, as
    torch tensors and as (1, S, 1, P) / (1, S, 1) jax arrays."""
    rng = np.random.default_rng(seed)
    qkv = [_bf16(torch.from_numpy(rng.standard_normal((S, P), np.float32)))
           for _ in range(3)]
    i_pre = torch.from_numpy(rng.standard_normal(S, np.float32))
    f_pre = torch.from_numpy(rng.standard_normal(S, np.float32) + 1.0)
    jargs = [jnp.asarray(t.numpy()[None, :, None, :]) for t in qkv]
    jargs += [jnp.asarray(t.numpy()[None, :, None]) for t in (i_pre, f_pre)]
    return (*qkv, i_pre, f_pre), jargs


def gate_prepass(i_pre, f_pre, L):
    """Per chunk of L (padded with f = 1, i = -1e30): b (nc, L), log i
    (nc, L) and pm_t = max_{s<=t} (log i_s - b_s), so that the chunk's own
    row stabilizer is max_{s<=t} D_ts = b_t + pm_t."""
    S = i_pre.shape[0]
    nc = -(-S // L)
    pad = nc * L - S
    lf = F.pad(-F.softplus(-f_pre), (0, pad)).reshape(nc, L)
    li = F.pad(i_pre, (0, pad), value=NEG_INF).reshape(nc, L)
    b = torch.cumsum(lf, dim=1)
    pm = torch.cummax(li - b, dim=1).values
    return b, li, pm


def m_chain(b, pm):
    """m_prev of every chunk and the final m, from the gates alone."""
    m, prevs = torch.tensor(NEG_INF), []
    for c in range(b.shape[0]):
        prevs.append(m)
        m = torch.maximum(b[c, -1] + pm[c, -1], b[c, -1] + m)
    return prevs, m


def scheme(q, k, v, i_pre, f_pre, L, split=True):
    """The kernel's bf16 path for one head: (h (S, P) f32, C (P, P), n (P,),
    m). With ``split=False`` the f32 operands are rounded to bf16 once."""
    S, P = q.shape
    scale = 1.0 / math.sqrt(P)
    b, li, pm = gate_prepass(i_pre, f_pre, L)
    m_prevs, m_final = m_chain(b, pm)
    nc = b.shape[0]
    pad = nc * L - S
    q, k, v = (F.pad(t, (0, 0, 0, pad)).reshape(nc, L, P) for t in (q, k, v))
    parts = _split if split else (lambda x: (_bf16(x), torch.zeros_like(x)))
    dot = lambda exact, other: sum(exact @ o for o in parts(other))
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    C, n, hs = torch.zeros(P, P), torch.zeros(P), []
    for c in range(nc):
        qc, kc, vc, bc, lic, m_prev = q[c], k[c], v[c], b[c], li[c], m_prevs[c]
        m_t = torch.maximum(bc + pm[c], bc + m_prev)
        d = bc[:, None] - bc[None, :] + lic[None, :]
        # stage 1: q.k^T once (exact products, f32 sums), W below the diagonal
        w = torch.where(tri, (qc @ kc.T) * scale
                        * torch.exp(torch.where(tri, d - m_t[:, None], 0.0)),
                        0.0)
        iq = torch.exp(bc + m_prev - m_t) * scale
        # stage 2: q.n_prev in f32; stage 3: q C_prev and W v, split
        den = torch.maximum((w.sum(1) + iq * (qc @ n)).abs(), torch.exp(-m_t))
        num = dot(vc.T, w.T).T + iq[:, None] * dot(qc, C)
        hs.append(num / den[:, None])
        m_new = m_t[-1]
        wk = torch.exp(bc[-1] - bc + lic - m_new)
        decay = torch.exp(bc[-1] + m_prev - m_new)
        C = decay * C + dot(kc.T, vc * wk[:, None])
        n = decay * n + kc.T @ wk
    return torch.cat(hs)[:S], C, n, m_final


@pytest.mark.parametrize("S,L", [(200, 64), (1, 1), (130, 16), (257, 64),
                                 (64, 64)])
def test_gate_prepass_and_m_chain_vs_reference(S, L):
    """The chain's m at every chunk's end against the sequential
    reference's m after the same prefix (m depends on the gates alone, so
    a narrow head serves)."""
    (q, k, v, i_pre, f_pre), _ = _inputs(S, 8, seed=S)
    b, li, pm = gate_prepass(i_pre, f_pre, L)
    prevs, m_final = m_chain(b, pm)
    ends = [min((c + 1) * L, S) for c in range(b.shape[0])]
    got = prevs[1:] + [m_final]
    for end, m in zip(ends, got):
        sl = lambda t: jnp.asarray(t[:end].numpy())
        _, (_, _, m_ref) = jref.mlstm(
            *(sl(t)[None, :, None, :] for t in (q, k, v)),
            *(sl(t)[None, :, None] for t in (i_pre, f_pre)))
        np.testing.assert_allclose(m.numpy(), np32(m_ref)[0, 0], **TOL)


def test_tensor_core_scheme_vs_reference():
    """h, C and n against the reference's chunked jnp path, m against its
    sequential oracle: H = 1, P = 1024, S = 200, chunks of 64."""
    S, P, L = 200, 1024, 64
    args, jargs = _inputs(S, P)
    h, C, n, m = scheme(*args, L)
    hj, (Cj, nj, _) = jops.mlstm_scan(*jargs, chunk=L, use_pallas=False)
    _, (_, _, mr) = jref.mlstm(*jargs)
    np.testing.assert_allclose(h.numpy(), np32(hj)[0, :, 0], **TOL)
    np.testing.assert_allclose(C.numpy(), np32(Cj)[0, 0], **TOL)
    np.testing.assert_allclose(n.numpy(), np32(nj)[0, 0], **TOL)
    np.testing.assert_allclose(m.numpy(), np32(mr)[0, 0], **TOL)


def test_one_bf16_rounding_misses_the_state_tolerance():
    """Rounding C, W and wk v to bf16 once (2^-9) instead of splitting
    them moves the state past the reference's 1e-4."""
    S, P, L = 200, 1024, 64
    args, jargs = _inputs(S, P)
    _, C, _, _ = scheme(*args, L, split=False)
    _, (Cj, _, _) = jops.mlstm_scan(*jargs, chunk=L, use_pallas=False)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(C.numpy(), np32(Cj)[0, 0], **TOL)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4])
def test_hi_lo_split_keeps_16_bits(scale):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096, np.float32)) * scale
    hi, lo = _split(x)
    assert torch.equal(hi, _bf16(hi)) and torch.equal(lo, _bf16(lo))
    assert bool(((x - hi - lo).abs() <= 2.0 ** -16 * x.abs()).all())
