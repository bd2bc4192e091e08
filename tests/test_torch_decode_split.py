"""The arithmetic of kernel B3 (``csrc/decode_attn.cu``), split-KV
flash-decoding, written out here in plain torch and held against the
JAX package's ``decode_attention`` on the CPU (the Pallas kernel in
interpret mode, as ``tests/test_torch_attention.py`` runs it) at the
f32 attention tolerance: each block's partial softmax record (m, l,
acc) over its split of the cache rows, for every query head of its KV
head, and their merge in split order, skipping the splits past
``lengths[b]``. The split length is the wrapper's own
(``decode_attn.split_rows``) for each dtype, and the lengths end inside
the first split, on a split edge, one past it, and span several splits
with empty splits after them."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, np32
from repro.kernels import ops as jops
from repro.kernels.decode_attn import decode_attention as pallas_decode
from repro_torch.kernels import decode_attn

TOL = dict(atol=2e-5, rtol=2e-5)          # tests/test_kernels.py, f32


def split_records(q, k, v, lengths, split):
    """Stage 1: per batch row, the (m, l, acc) record of each split that
    holds rows, each (KV, group[, D]), in split order."""
    B, H, _, D = q.shape
    KV = k.shape[1]
    qr = q.reshape(B, KV, H // KV, D).float()
    recs = []
    for b in range(B):
        n, rows = int(lengths[b]), []
        for r0 in range(0, n, split):
            r1 = min(n, r0 + split)
            s = torch.einsum("kgd,ksd->kgs", qr[b],
                             k[b, :, r0:r1].float()) / math.sqrt(D)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            rows.append((m, p.sum(dim=-1),
                         torch.einsum("kgs,ksd->kgd", p, v[b, :, r0:r1].float())))
        recs.append(rows)
    return recs


def merge(recs, shape):
    """Stage 2: the records of each batch row merged in split order; a row
    with no record gives 0."""
    B, H, _, D = shape
    out = torch.zeros(B, H, 1, D)
    for b, rows in enumerate(recs):
        if not rows:
            continue
        mx = torch.stack([m for m, _, _ in rows]).amax(dim=0)
        l = sum(li * torch.exp(m - mx) for m, li, _ in rows)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in rows)
        out[b] = (acc / l.clamp_min(1e-30)[..., None]).reshape(H, 1, D)
    return out


def _lengths(r, S):
    """Inside the first split, on its edge, one past it, across several
    splits (on an edge and inside one), one row, and the whole cache."""
    return [r // 2 + 1, r, r + 1, 3 * r, 3 * r - 7, 1, S]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,KV,D", [(15, 5, 64),     # SmolLM: group 3
                                    (4, 4, 64),      # MHA (Zamba2): group 1
                                    (4, 4, 16),      # the smoke heads
                                    (4, 2, 128)])
def test_split_and_merge_vs_jax(H, KV, D, dtype):
    r = decode_attn.split_rows(D, dtype)
    S = 4 * r + 3                     # a ragged last split
    lens = _lengths(r, S)
    B = len(lens)
    rng = np.random.default_rng(D + H)
    (qj, qt), (kj, kt), (vj, vt) = [
        both(rng.standard_normal(s))
        for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D))]
    lj = jnp.asarray(lens, jnp.int32)
    recs = split_records(qt, kt, vt, lens, r)
    assert [len(x) for x in recs] == [-(-n // r) for n in lens]
    assert decode_attn.n_splits(S, D, dtype) == 5   # the last ones empty
    got = merge(recs, qt.shape)
    for want in (pallas_decode(qj, kj, vj, lj),   # interpret mode
                 jops.decode_attention(qj, kj, vj, lj, use_pallas=False)):
        np.testing.assert_allclose(got.numpy(), np32(want), **TOL)


def test_split_rows_fill_the_card_at_smollm_shape():
    """SmolLM-360M's decode shape in phase 3 of chip_smoke (B=8, KV=5,
    6,500 valid rows in bf16) gives more blocks with rows than the H100's
    132 SMs; a split is 256 rows, 32 KB of K there."""
    lens = [1, 2048, 100, 513, 1024, 37, 2000, 777]
    r = decode_attn.split_rows(64, torch.bfloat16)
    assert r == 256 and r * 64 * 2 == decode_attn.SPLIT_BYTES
    busy = 5 * sum(-(-n // r) for n in lens)
    assert busy == 150 > 132
    assert decode_attn.n_splits(2048, 64, torch.bfloat16) == 8
