"""The port's compression schemes (``repro_torch.train.compression``) on the
CPU, against the reference's ``repro.train.compression`` on the same NumPy
inputs: kept values, reconstructions and residuals exact (data drawn
without ties), the int8 codes exact, the payload bits exact, the norms
within rtol 1e-6. The int8 scheme's CPU path is kernel B1's plain
version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.train import compression as jc
from repro_torch.core.train_state import _leaves
from repro_torch.kernels import split_quant
from repro_torch.train import compression as tc
from repro_torch.train.compression import tree_map

# an HWIO conv (rows along its 8 output channels), a bias (one row), a
# dense layer, a scalar and a 1-element tensor, in a dict and a tuple
SHAPES = {"conv": (3, 3, 4, 8), "bias": (8,), "dense": (16, 5),
          "pair": ((), (1,))}


def _tree(seed, scale=1.0):
    """A NumPy tree of SHAPES from continuous draws: no two magnitudes
    tie, so top-k keeps the same entries in both packages."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        return np.asarray(scale * rng.standard_normal(shape), np.float32)
    return {"conv": leaf(SHAPES["conv"]), "bias": leaf(SHAPES["bias"]),
            "dense": leaf(SHAPES["dense"]),
            "pair": tuple(leaf(s) for s in SHAPES["pair"])}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _same(got, want):
    """Leaf by leaf, bit for bit (atol = rtol = 0)."""
    g, w = _leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scheme,ratio", [
    ("none", 0.01), ("int8", 0.01), ("topk", 0.01), ("topk", 0.1),
    ("topk", 0.5), ("topk", 1.0)])
def test_compress_matches_reference(scheme, ratio):
    """Two error-feedback rounds: the compressed values, the carried
    residual and the metrics of each equal the reference's."""
    grads = [_tree(1), _tree(2, scale=0.5)]
    jef, tef = jc.ef_init(_jax(grads[0])), tc.ef_init(_torch(grads[0]))
    for g in grads:
        jk, jef, jm = jc.compress(_jax(g), jef, scheme=scheme,
                                  topk_ratio=ratio)
        tk, tef, tm = tc.compress(_torch(g), tef, scheme=scheme,
                                  topk_ratio=ratio)
        _same(tk, jk)
        _same(tef.residual, jef.residual)
        assert set(tm) == set(jm)
        for key, v in jm.items():
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=0)
        if scheme != "none":
            assert float(tm["compress_payload_bits"]) == float(
                jm["compress_payload_bits"]) == jc.payload_bits(
                    g, scheme, topk_ratio=ratio)
    if scheme == "topk":
        # exactly k survivors in each tensor
        for leaf, full in zip(_leaves(tk), _leaves(_torch(grads[-1]))):
            k = max(1, int(full.numel() * ratio))
            assert int((leaf != 0).sum()) == k


@pytest.mark.parametrize("shape", [(3, 3, 4, 8), (8,), (16, 5), (), (1,),
                                   (2, 3, 5, 7)])
def test_int8_rows_and_codes_match_reference(shape):
    """The int8 scheme's rows: ``reshape(-1, shape[-1])`` for rank >= 2,
    one row otherwise; codes and scales of those rows, and the leaf's
    reconstruction, equal the reference's."""
    x = np.asarray(np.random.default_rng(7).standard_normal(shape),
                   np.float32)
    rows = x.reshape(1, -1) if x.ndim < 2 else x.reshape(-1, x.shape[-1])
    jq, js = jops.quantize_boundary(jnp.asarray(rows), use_pallas=False)
    tq, ts = split_quant.quantize_rows_plain(torch.from_numpy(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc._int8_one(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc._int8_one(jnp.asarray(x))))
    assert tc.int8_payload_bits([torch.from_numpy(x)]) == \
        jc.int8_payload_bits([jnp.asarray(x)])


@pytest.mark.parametrize("ratio", [0.001, 0.01, 0.37, 1.0])
def test_payload_bits_match_reference_and_hand_count(ratio):
    tree = _tree(0)
    meta = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                    _torch(tree))
    for scheme in tc.SCHEMES:
        want = jc.payload_bits(_jax(tree), scheme, topk_ratio=ratio)
        assert tc.payload_bits(_torch(tree), scheme,
                               topk_ratio=ratio) == want
        assert tc.payload_bits(meta, scheme, topk_ratio=ratio) == want
    # by hand: a (16, 5) dense leaf alone
    d = [torch.zeros(16, 5)]
    k = max(1, int(80 * ratio))
    assert tc.payload_bits(d, "topk", topk_ratio=ratio) == k * (32 + 7)
    assert tc.payload_bits(d, "int8") == 80 * 8 + 16 * 32
    assert tc.payload_bits(d, "none") == 80 * 32
    for n in (1, 2, 3, 1024, 1025):
        assert tc.index_bits(n) == jc.index_bits(n)
    with pytest.raises(ValueError):
        tc.payload_bits(d, "fft")
    with pytest.raises(ValueError):
        tc.compress(d, tc.ef_init(d), scheme="fft")
