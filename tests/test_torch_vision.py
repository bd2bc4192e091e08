"""The port's vision models against the JAX reference, stage by stage,
on the reference's weights (``from_jax_params``) at f32: every
autoencoder and ResNet-18 stage within rtol 1e-4, atol 1e-5. This
covers XLA's uneven "SAME" padding (the 7x7 stem, stride-2 3x3 convs,
the -inf-padded max pool, odd sizes), ``conv_transpose`` and GroupNorm
with fewer than 8 groups (the 3-channel stages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy
from repro.models import vision as jvision
from repro.models.param import init_params as jinit
from repro_torch.models import vision
from repro_torch.models.param import from_jax_params, map_tree

RTOL, ATOL = 1e-4, 1e-5

MODELS = {
    "autoencoder": (lambda: jvision.ae_abstract_params(), 10,
                    jvision.ae_apply_range, vision.ae_apply_range),
    "resnet18": (lambda: jvision.resnet18_abstract_params(10), 10,
                 jvision.resnet18_apply_range, vision.resnet18_apply_range),
}


@pytest.mark.parametrize("img", [32, 36])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_stage_matches_reference(model, img):
    spec, n_stages, japply, apply = MODELS[model]
    jp = jinit(spec(), jax.random.key(img))
    params = from_jax_params(jax_tree_to_numpy(jp))
    x = np.random.default_rng(img).standard_normal(
        (2, img, img, 3)).astype(np.float32)
    for i in range(n_stages):
        want = np.array(japply(jp, jnp.asarray(x), i, i + 1))
        got = apply(params, torch.from_numpy(x), i, i + 1).numpy()
        assert got.shape == want.shape, (model, i)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{model} stage {i}")
        x = want                       # each stage from the same input


@pytest.mark.parametrize("model", sorted(MODELS))
def test_split_segments_compose_to_the_whole_model(model):
    spec, n_stages, japply, apply = MODELS[model]
    jp = jinit(spec(), jax.random.key(5))
    params = from_jax_params(jax_tree_to_numpy(jp))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    cut = 5
    whole = apply(params, x, 0, n_stages)
    z = apply(params, x, 0, cut)
    assert z.is_contiguous()           # NHWC rows, no copy on the CPU
    torch.testing.assert_close(apply(params, z, cut, n_stages), whole)
    want = np.asarray(japply(jp, jnp.asarray(x.numpy()), 0, n_stages))
    np.testing.assert_allclose(whole.numpy(), want, rtol=RTOL, atol=ATOL)


def test_full_width_resnet18_shapes_on_meta():
    # the paper's main path: 224 px, batch 8, cut l2 -> z (8, 28, 28, 128)
    params = map_tree(lambda s: torch.empty(s.shape, device="meta"),
                      vision.resnet18_abstract_params(10))
    x = torch.empty((8, 224, 224, 3), device="meta")
    z = vision.resnet18_apply_range(params, x, 0, 5)
    assert tuple(z.shape) == (8, 28, 28, 128)
    assert tuple(vision.resnet18_apply_range(params, z, 5, 10).shape) == (8, 10)
