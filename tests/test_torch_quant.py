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


# The STE forward (quantize, then dequantize to x's dtype) of the port's
# plain version against the reference's, bit for bit, on the layouts a
# boundary arrives in: NHWC-contiguous, an NHWC view of NCHW memory (what
# a conv stage hands over on the card) and a view sliced out of a larger
# tensor. The output keeps the input's strides.
STE_DS = [3, 16, 128, 130]
STE_LAYOUTS = ["nhwc", "nchw_view", "sliced"]


def _boundary(d, dtype, how, seed=3):
    """A (2, 5, 5, d) boundary with all-zero rows and .5 ties: (jax array,
    torch tensor laid out as ``how`` says, same values)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((50, d)).astype(np.float32) * 7.3
    x[::7] = 0.0                                   # all-zero rows
    ties = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5][:d]
    x[1, :len(ties)] = ties                        # scale 1: .5 ties
    xj, xt = both(x.reshape(2, 5, 5, d), dtype)
    if how == "nchw_view":
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif how == "sliced":
        wide = torch.zeros((2, 6, 5, d + 2), dtype=xt.dtype)
        wide[:, 1:, :, :d] = xt
        xt = wide[:, 1:, :, :d]
    return xj, xt


@pytest.mark.parametrize("how", STE_LAYOUTS)
@pytest.mark.parametrize("d", STE_DS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_quantize_dequantize_vs_reference(dtype, d, how):
    xj, xt = _boundary(d, dtype, how)
    want = jops.ste_quantize(xj)
    qj, sj = jops.quantize_boundary(xj, use_pallas=False)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jops.dequantize_boundary(qj, sj, dtype)))
    got = split_quant.quantize_dequantize_plain(xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert got.stride() == xt.stride()
    np.testing.assert_array_equal(np32(got), np32(want))
    # the op on a CPU tensor, and the codes and scales of the boundary op
    np.testing.assert_array_equal(np32(ops.ste_quantize(xt)), np32(want))
    q, s = ops.quantize_boundary(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("how", STE_LAYOUTS)
def test_ste_gradient_passes_straight_through(how):
    _, xt = _boundary(16, jnp.float32, how, seed=4)
    xt.requires_grad_()
    y = ops.ste_quantize(xt)
    assert y.stride() == xt.stride()
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(xt.shape)).astype(np.float32))
    (y * g).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), g.numpy())


def test_kernel_layout_reads_each_boundary_as_it_lies():
    """The (N, P, C) view with strides (ns, ps, cs) that the kernel is
    handed addresses exactly x's rows; layouts it cannot read are None
    (the wrapper copies those, and counts the copy)."""
    base = torch.arange(2 * 7 * 5 * 16, dtype=torch.float32)
    nchw = base.reshape(2, 16, 7, 5)
    cases = {
        "nhwc": (base.reshape(2, 7, 5, 16), "rows"),
        "nchw_view": (nchw.permute(0, 2, 3, 1), "channels"),
        "sliced_rows": (base.reshape(2, 7, 5, 16)[:, 1:, :, :12], "rows"),
        "sliced_pixels": (nchw[:, :, 2:].permute(0, 2, 3, 1), "channels"),
        "rows_2d": (base.reshape(-1, 16), "rows"),
        "transposed_2d": (base.reshape(16, -1).t(), "channels"),
    }
    for name, (x, kind) in cases.items():
        lay = split_quant.layout(x)
        assert lay is not None, name
        assert (lay.cs == 1) == (kind == "rows"), name
        assert kind == "rows" or lay.ps == 1, name
        view = torch.as_strided(x, (lay.N, lay.P, lay.C),
                                (lay.ns, lay.ps, lay.cs))
        assert torch.equal(view.reshape(-1, lay.C),
                           x.reshape(-1, x.shape[-1])), name
    # pixels that do not flatten (H and W swapped), overlapping rows, and
    # channel-major rows wider than the kernel's 256 channels
    assert split_quant.layout(nchw.permute(0, 3, 2, 1)) is None
    assert split_quant.layout(torch.zeros(4, 1).expand(4, 8).t()) is None
    assert split_quant.layout(torch.zeros(2, 300, 4).transpose(1, 2)) is None


def test_fused_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        split_quant.quantize_dequantize(torch.zeros(4, 8))
