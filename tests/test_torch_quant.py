"""The port's SL boundary quantizer on the CPU (the kernel's plain
version) against the JAX reference: ``repro.kernels.ref.quantize_rows``
and the Pallas ``quantize_rows`` in interpret mode, bit for bit on the
int8 codes (``array_equal``) and to rtol 1e-6 on the scales, the
reference's own test (``tests/test_kernels.py::test_split_quant``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import both, np32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.split_quant import quantize_rows as pallas_quant
from repro_torch.kernels import ops, ref, split_quant

# test_kernels.py's shapes (with its block sizes for the Pallas grid),
# the autoencoder latent's d = 3 and a d that is not a multiple of 4
QUANT_CASES = [(16, 32, 8), (37, 64, 16), (5, 128, 256), (49, 3, 16),
               (40, 130, 16)]


def _inputs(rows, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return both(rng.standard_normal((rows, d)) * 7.3, dtype)


def _assert_same(got, want):
    (q, s), (qw, sw) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == qw.shape and tuple(s.shape) == sw.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(qw))
    np.testing.assert_allclose(s.numpy(), np.asarray(sw), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("rows,d,block", QUANT_CASES)
def test_plain_quantizer_vs_ref_and_pallas(rows, d, block, dtype):
    xj, xt = _inputs(rows, d, dtype)
    got = split_quant.quantize_rows_plain(xt)
    _assert_same(got, jref.quantize_rows(xj))
    _assert_same(got, pallas_quant(xj, block_rows=block))
    # dequantization error bounded by half a step per element
    deq = ref.dequantize_rows(*got)
    assert float((deq - xt.float()).abs().max()) <= float(got[1].max()) * 0.51


def test_zero_rows_and_exact_ties():
    # row 0 all zero (scale clamps to 1e-30 / 127, codes 0); row 1 has
    # absmax 127 so scale is exactly 1 and x / scale hits .5 ties, which
    # round half to even; row 2 mixes ties with a non-unit scale
    x = np.zeros((3, 8), np.float32)
    x[1] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    x[2] = [254.0, 1.0, 3.0, 5.0, -1.0, -5.0, 253.0, 0.0]
    xj, xt = both(x)
    got = split_quant.quantize_rows_plain(xt)
    _assert_same(got, jref.quantize_rows(xj))
    _assert_same(got, pallas_quant(xj, block_rows=8))
    np.testing.assert_array_equal(got[0][0].numpy(), 0)
    np.testing.assert_array_equal(got[0][1].numpy(),
                                  [127, 0, 2, 2, 0, -2, 126, -4])


def test_boundary_op_layout_matches_reference():
    # an NHWC boundary: one row per pixel, absmax over channels
    xj, xt = _inputs(2 * 5 * 5, 16, jnp.float32, seed=1)
    xj, xt = xj.reshape(2, 5, 5, 16), xt.reshape(2, 5, 5, 16)
    q, s = ops.quantize_boundary(xt)
    qj, sj = jops.quantize_boundary(xj, use_pallas=False)
    assert tuple(q.shape) == (2, 5, 5, 16) and tuple(s.shape) == (2, 5, 5, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(
        ops.dequantize_boundary(q, s).numpy(),
        np.asarray(jops.dequantize_boundary(qj, sj)))


def test_ste_value_and_gradient_match_reference():
    xj, xt = _inputs(8, 16, jnp.float32, seed=2)
    xt.requires_grad_()
    y = ops.ste_quantize(xt)
    (y * 3.0).sum().backward()
    yj, gj = jax.value_and_grad(
        lambda t: (jops.ste_quantize(t) * 3.0).sum())(xj)
    np.testing.assert_array_equal(np32(y), np32(jops.ste_quantize(xj)))
    np.testing.assert_allclose(float((y.detach() * 3.0).sum()), float(yj),
                               rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        split_quant.quantize_rows(torch.zeros(4, 8))
