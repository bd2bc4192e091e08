"""The port's sharding rules against the reference's own functions:
``partition_specs``, ``zero_partition_specs`` and ``adamw_state_specs``
of every ASSIGNED config at published widths (abstract params only) on
fake meshes from one rank to the 2 x 16 x 16 pods; then what the port
holds beyond the reference's specs: whole heads, SwiGLU's gate and up
cut alike, the KV heads a rank's q heads read, and the refusals."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import param as jparam
from repro.train import optimizer as joptimizer
from repro_torch import configs
from repro_torch.models import lm, parallel
from repro_torch.models.layers import Ctx
from repro_torch.models.param import (ParamSpec, ShardingRules, local_shard,
                                      partition_specs)
from repro_torch.train import optimizer
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.utils.treeutil import tree_flatten_with_names

MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class _FakeMesh:
    """The reference's tests' stand-in for a JAX mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = names


class _FakeDeviceMesh:
    """Axis names, sizes and this rank's index on each: what the port's
    layers read of a ``DeviceMesh``."""

    def __init__(self, sizes, ranks):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._ranks = ranks

    def get_local_rank(self, name):
        return self._ranks[name]


def _ref_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(str(k.key) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_specs(spec_tree, abstract):
    """{name: spec} of a port spec tree, walked along its ParamSpec tree
    (its leaves are tuples)."""
    def walk(specs, node, prefix):
        if isinstance(node, ParamSpec):
            return [(prefix, specs)]
        return [item for k in sorted(node)
                for item in walk(specs[k], node[k],
                                 f"{prefix}.{k}" if prefix else k)]
    return dict(walk(spec_tree, abstract, ""))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_specs_equal_the_reference(arch, mesh):
    shape, names = mesh
    jabs = jlm.abstract_params(jconfigs.get(arch))
    abstract = lm.abstract_params(configs.get(arch))
    fake, sizes = _FakeMesh(shape, names), dict(zip(names, shape))
    jrules, rules = jparam.ShardingRules(), ShardingRules()
    assert dataclasses.asdict(rules) == dataclasses.asdict(jrules)
    # the axes themselves, leaf for leaf
    jaxes = {".".join(str(k.key) for k in p): s.axes for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jabs, is_leaf=jparam.is_spec)[0]}
    assert {n: s.axes for n, s in tree_flatten_with_names(abstract)} == jaxes
    pairs = [(jparam.partition_specs(jabs, jrules, fake),
              partition_specs(abstract, rules, sizes)),
             (joptimizer.zero_partition_specs(jabs, jrules, fake),
              optimizer.zero_partition_specs(abstract, rules, sizes))]
    jstate = joptimizer.adamw_state_specs(jabs, jrules, fake)
    state = optimizer.adamw_state_specs(abstract, rules, sizes)
    assert tuple(jstate.step) == state.step == ()
    pairs += [(jstate.mu, state.mu), (jstate.nu, state.nu)]
    for want, got in pairs:
        assert _port_specs(got, abstract) == _ref_specs(want)


def test_placement_keeps_whole_heads_and_pairs_gate_with_up():
    """SmolLM-360M's 960 query columns divide by 2, its 15 heads do not:
    the reference cuts a head, the placement replicates the projections;
    SwiGLU's wi gives rank r the r-th half of the gate and of the up."""
    cfg = configs.get("smollm_360m")
    abstract = lm.abstract_params(cfg)["units"]["0:attn"]
    mesh = {"data": 1, "model": 2}
    ref = partition_specs(abstract, ShardingRules(), mesh)
    held = parallel.placement(abstract, ShardingRules(), mesh)
    for w in ("wq", "wk", "wv"):
        assert ref["attn"][w] == (None, None, "model")
        assert held["attn"][w].spec == (None, None, None)
    assert held["attn"]["wo"].spec == (None, None, None)
    assert held["mlp"]["wi"].spec == ref["mlp"]["wi"] == (None, None, "model")
    f = 6
    wi = torch.arange(2 * 2 * f).reshape(2, 2 * f).float()
    view = (None, (2, f, 1))
    for r in range(2):
        got = local_shard(wi, (None, "model"), {"model": (r, 2)}, view)
        gate, up = wi[:, :f], wi[:, f:]
        want = torch.cat([gate[:, r * 3:(r + 1) * 3], up[:, r * 3:(r + 1) * 3]],
                         dim=1)
        assert torch.equal(got, want)
    wq = torch.arange(4 * 12).reshape(4, 12).float()     # 3 heads of 4
    got = local_shard(wq, (None, "model"), {"model": (1, 3)},
                      (None, (1, 3, 4)))
    assert torch.equal(got, wq[:, 4:8])


@pytest.mark.parametrize("H,KV,m,want", [
    (4, 2, 4, [(1, 1, [0]), (1, 1, [0]), (1, 1, [1]), (1, 1, [1])]),
    (4, 2, 2, [(2, 1, None), (2, 1, None)]),
    (15, 5, 2, [None, None]),
    (6, 2, 3, [(2, 2, [0, 0]), (2, 2, [0, 1]), (2, 2, [1, 1])]),
    (8, 2, 4, [(2, 1, [0]), (2, 1, [0]), (2, 1, [1]), (2, 1, [1])]),
])
def test_local_heads_hand_b2_the_kv_heads_its_q_heads_read(H, KV, m, want):
    cfg = dataclasses.replace(configs.get_smoke("llama3_8b"), n_heads=H,
                              n_kv_heads=KV, d_head=16)
    got = [parallel.local_heads(Ctx(cfg=cfg, mesh=_FakeDeviceMesh(
        {"data": 1, "model": m}, {"data": 0, "model": r})), H, KV)
        for r in range(m)]
    assert got == want


@pytest.mark.parametrize("arch,mesh,what", [
    ("zamba2_1_2b", {"data": 1, "model": 2}, "mamba2"),
    ("xlstm_1_3b", {"data": 2, "model": 2}, "mlstm"),
    ("mixtral_8x7b", {"data": 2, "model": 1}, "MoE"),
    ("phi35_moe", {"data": 1, "model": 2}, "MoE"),
    ("whisper_small", {"data": 1, "model": 2}, "encoder"),
    ("qwen2_vl_7b", {"data": 1, "model": 4}, "vision prefix"),
])
def test_refused_on_a_mesh(arch, mesh, what):
    with pytest.raises(NotImplementedError, match=what):
        make_train_step(configs.get_smoke(arch), mesh, ShardingRules(),
                        device="cpu")


def test_compression_refused_on_more_than_one_rank():
    with pytest.raises(NotImplementedError, match="compression"):
        make_train_step(configs.get_smoke("smollm_360m"),
                        {"data": 2, "model": 1}, ShardingRules(),
                        TrainConfig(compression="int8"), device="cpu")


@pytest.mark.parametrize("data,cut", [(1, False), (2, True)])
def test_zero_cuts_the_state_only_over_a_data_axis_of_several(data, cut):
    """The state keeps the reference's ZeRO spec, but a data axis of one
    rank cuts nothing: no dim to slice, reduce-scatter or all-gather."""
    cfg = configs.get_smoke("smollm_360m")
    abstract = lm.abstract_params(cfg)
    mesh = {"data": data, "model": 1}
    place = parallel.placement(abstract, ShardingRules(), mesh)
    held = _port_specs(place, abstract)
    want = _port_specs(optimizer.zero_partition_specs(
        abstract, ShardingRules(), mesh), abstract)
    assert held.keys() == want.keys()
    assert any("data" in z for z in want.values())
    for name, z in want.items():
        assert held[name].zspec == z, name
        assert (held[name].zdim is not None) == (cut and "data" in z), name


@pytest.mark.parametrize("env,device,want", [
    ({}, "cuda", "cuda:0"),
    ({}, "cuda:1", "cuda:1"),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}, "cuda", "cuda:1"),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}, "cuda:0", None),
])
def test_a_rank_takes_the_card_it_is_given(monkeypatch, env, device, want):
    """One process runs on the card its device names; a rank of several
    on cuda:LOCAL_RANK, and a device naming another card is refused."""
    from repro_torch.launch.mesh import rank_card
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is None:
        with pytest.raises(ValueError, match="LOCAL_RANK"):
            rank_card(device)
    else:
        assert rank_card(device) == torch.device(want)
