"""Parameter trees: the converter between the two packages is bitwise,
the port's tree has the reference's shapes at full SmolLM-360M,
Zamba2-1.2B and xLSTM-1.3B width (shapes only, nothing full-width is allocated), and
the seeded init follows the reference's rules."""
import jax
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, to_jax_params


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _assert_round_trip_bitwise(arch):
    jcfg = jconfigs.get_smoke(arch)
    ref = jax_tree_to_numpy(jlm.init(jcfg, jax.random.key(3)))
    port = from_jax_params(ref)
    back = to_jax_params(port)
    want, got = _paths(ref), _paths(back)
    assert want.keys() == got.keys()
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)
        assert isinstance(_paths(port)[path], torch.Tensor)
    assert _paths(lm.abstract_params(configs.get_smoke(arch))).keys() \
        == want.keys()


def test_converter_round_trip_is_bitwise():
    _assert_round_trip_bitwise("smollm_360m")


def test_converter_round_trip_is_bitwise_zamba2():
    """The hybrid tree: stacked mamba2 units plus the top-level shared
    attention block."""
    _assert_round_trip_bitwise("zamba2_1_2b")


def test_converter_round_trip_is_bitwise_xlstm():
    """The xLSTM tree: stacked mlstm and slstm blocks, all dict leaves."""
    _assert_round_trip_bitwise("xlstm_1_3b")


# Parameters at full width, from the reference's own tree (SmolLM-360M
# with its tied head; Zamba2-1.2B with its one shared attention block;
# xLSTM-1.3B with its untied head).
FULL_WIDTH_PARAMS = {"smollm_360m": 361_821_120, "zamba2_1_2b": 977_313_408,
                     "xlstm_1_3b": 1_817_495_888}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_full_width_shapes_match_reference(name):
    jshapes = _paths(jax.eval_shape(
        lambda: jlm.init(jconfigs.get(name), jax.random.key(0))))
    specs = _paths(lm.abstract_params(configs.get(name)))
    assert specs.keys() == jshapes.keys()
    for path, s in jshapes.items():
        assert specs[path].shape == s.shape, path
        assert specs[path].dtype == torch.float32 and s.dtype == np.float32
    n = sum(int(np.prod(s.shape)) for s in jshapes.values())
    assert n == FULL_WIDTH_PARAMS[name]


def test_seeded_init_rules():
    cfg = configs.get_smoke("smollm_360m")
    make = lambda seed: lm.init(cfg, torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    ps = _paths(a)
    for path, x in _paths(b).items():
        assert torch.equal(ps[path], x), path    # same seed, same weights
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(ps["/final_norm/scale"], torch.ones(cfg.d_model))
    assert abs(ps["/embed"].std().item() - 0.02) < 0.002
    wi = ps["/units/0:attn/mlp/wi"]                 # (U, d_model, 2 d_ff)
    assert abs(wi.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert all(t.dtype == torch.float32 for t in ps.values())
