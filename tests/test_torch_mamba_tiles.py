"""The arithmetic of kernel B4's bf16 path (``csrc/mamba_scan.cu``),
written out here in plain torch and held against the JAX package on the
CPU, so that the SSD state-passing form and its precision scheme are
shown to hold before the card runs them:

- G = c.b^T once per (batch, chunk), shared by every head (exact bf16
  operands, f32 sums);
- each chunk's contribution to the state, U = x^T (b w) with
  w_s = dt_s exp(cum_L - cum_s), in parallel over chunks;
- the state pass h = exp(cum_L) h + U over the chunks, keeping the state
  entering each chunk;
- the chunk output y = exp(cum_t) c h_in^T + M x with
  M_ts = exp(cum_t - cum_s) G_ts dt_s below the diagonal;

with every product having one exact bf16 operand (x, b or c) and the
other, f32 one (b w, h_in, M) split into hi = bf16(v) and lo = bf16(v -
hi), run as two products summed in f32. y and h_final are held against
``repro.kernels.ref.mamba_ssd`` and the jnp path of
``repro.kernels.ops.mamba_scan`` at the reference's scan tolerance, and
rounding those operands to bf16 once instead is shown to miss it.

Inputs are rounded to bf16 from a numpy seed: Zamba2-1.2B's head width
(P = N = 64, chunk 128) with three heads, and a narrow head with a chunk
shorter than one 16-row tile (the kernel pads tiles with zeros)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_helpers import np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref

TOL = dict(atol=5e-4, rtol=5e-4)          # tests/test_kernels.py, scans


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _inputs(B, S, H, P, N, seed=0):
    """x (B, S, H, P), b, c (B, S, N) holding bf16 values, dt (B, S, H)
    and a_log (H,) f32, as torch tensors and as jax arrays."""
    rng = np.random.default_rng(seed)
    x = _bf16(torch.from_numpy(rng.standard_normal((B, S, H, P), np.float32)))
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((B, S, H)))).astype(np.float32))
    a_log = torch.from_numpy(rng.standard_normal(H).astype(np.float32) * 0.5)
    b, c = (_bf16(torch.from_numpy(rng.standard_normal((B, S, N), np.float32)))
            for _ in range(2))
    args = (x, dt, a_log, b, c)
    return args, [jnp.asarray(t.numpy()) for t in args]


def scheme(x, dt, a_log, b, c, L, split=True):
    """The kernel's bf16 path: (y (B, S, H, P) f32, h_final (B, H, P, N)).
    With ``split=False`` the f32 operands are rounded to bf16 once."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    xs = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, nc, L, H, P)
    dts = F.pad(dt, (0, 0, 0, pad)).reshape(B, nc, L, H)
    bs = F.pad(b, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cs = F.pad(c, (0, 0, 0, pad)).reshape(B, nc, L, N)
    parts = _split if split else (lambda v: (_bf16(v), torch.zeros_like(v)))
    a = -torch.exp(a_log)

    # stage 1: G once per (batch, chunk); per head the log-decays, the
    # weights w and the chunk's contribution U = x^T (b w), its decay
    G = cs @ bs.transpose(-1, -2)                                 # (B,nc,L,L)
    cum = torch.cumsum(a * dts, dim=2)                            # (B,nc,L,H)
    cl = cum[:, :, -1:, :]
    w = dts * torch.exp(cl - cum)
    bw = bs[:, :, None] * w.permute(0, 1, 3, 2)[..., None]        # (B,nc,H,L,N)
    xt = xs.permute(0, 1, 3, 4, 2)                                # (B,nc,H,P,L)
    U = sum(xt @ o for o in parts(bw))                            # (B,nc,H,P,N)
    decay = torch.exp(cl[:, :, 0, :])                             # (B,nc,H)

    # stage 2: the state pass over the chunks
    h = torch.zeros(B, H, P, N)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = decay[:, ci, :, None, None] * h + U[:, ci]
    h_in = torch.stack(h_in, dim=1)                               # (B,nc,H,P,N)

    # stage 3: y = exp(cum_t) c h_in^T + M x
    tri = torch.ones(L, L, dtype=torch.bool).tril()[..., None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,t,s,H)
    m = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0))
                    * G[..., None] * dts[:, :, None], 0.0)
    m = m.permute(0, 1, 4, 2, 3)                                  # (B,nc,H,t,s)
    ch = sum(cs[:, :, None] @ o.transpose(-1, -2) for o in parts(h_in))
    y = (torch.exp(cum).permute(0, 1, 3, 2)[..., None] * ch
         + sum(o @ xs.permute(0, 1, 3, 2, 4) for o in parts(m)))  # (B,nc,H,L,P)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * L, H, P)[:, :S]
    return y, h


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 300, 3, 64, 64, 128),     # Zamba2's heads, ragged last chunk
    (1, 1, 3, 64, 64, 128),       # one position
    (2, 256, 2, 64, 64, 128),     # two batch rows, whole chunks
    (1, 37, 2, 8, 4, 10),         # chunk of 10 < one 16-row tile, N = 4
])
def test_tensor_core_scheme_vs_reference(B, S, H, P, N, chunk):
    args, jargs = _inputs(B, S, H, P, N, seed=S)
    L = min(chunk, S)
    y, h = scheme(*args, L)
    yr, hr = jref.mamba_ssd(*jargs)
    yj, hj = jops.mamba_scan(*jargs, chunk=chunk, use_pallas=False)
    for want_y, want_h in ((yr, hr), (yj, hj)):
        np.testing.assert_allclose(y.numpy(), np32(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np32(want_h), **TOL)


def test_one_bf16_rounding_misses_the_scan_tolerance():
    """Rounding b w, h_in and M to bf16 once (2^-9) instead of splitting
    them moves y past the reference's 5e-4."""
    args, jargs = _inputs(1, 300, 3, 64, 64)
    y, _ = scheme(*args, 128, split=False)
    yr, _ = jref.mamba_ssd(*jargs)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(y.numpy(), np32(yr), **TOL)

