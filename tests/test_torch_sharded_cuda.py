"""The train step's memory and the (1, 1) mesh on a card: full-width
SmolLM-360M at chip_smoke 12a's shape leaves no device memory behind a
step for the cyclic GC (ROADMAP C14), and a one-rank NCCL mesh equals
the one-process step bit for bit. Imports neither JAX nor the JAX
package: ``PYTHONPATH=src python -m pytest -q -m requires_cuda
tests/test_torch_sharded_cuda.py``. Every test skips without a card."""
import gc

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.synthetic import TokenShards
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models import parallel
from repro_torch.models.param import ShardingRules
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.utils.treeutil import tree_leaves

pytestmark = pytest.mark.requires_cuda


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided inside
    the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_train_step_memory_is_flat_without_the_gc():
    """memory_allocated after two steps with the GC off equals what it is
    after one: nothing of a step waits for the cyclic GC."""
    dev = require_cuda()
    cfg = configs.get("smollm_360m")
    step, _, _, init = make_train_step(cfg, tcfg=TrainConfig(), device=dev)
    state = init(0)
    shards = TokenShards(vocab=cfg.vocab, seq_len=512, batch=8)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                shards.batch_at(0, i).items()} for i in range(3)]
    state, m = step(state, batches[0])        # the first call's allocations
    del m
    gc.collect()
    gc.disable()
    try:
        after = []
        for batch in batches[1:]:
            state, m = step(state, batch)
            del m
            torch.cuda.synchronize()
            after.append(torch.cuda.memory_allocated())
    finally:
        gc.enable()
    assert after[0] == after[1], after


def test_one_rank_nccl_mesh_is_the_one_process_step_bit_for_bit():
    dev = require_cuda()
    cfg = configs.get_smoke("llama3_8b")
    tcfg = TrainConfig()
    rng = np.random.default_rng(0)
    with process_group("cuda") as dev:
        mesh = make_host_mesh(1, dev)
        sharded, _, _, init = make_train_step(cfg, mesh, ShardingRules(),
                                              tcfg, device=dev)
        step, _, _, init1 = make_train_step(cfg, tcfg=tcfg, device=dev)
        a, b = init(0), init1(0)
        for _ in range(2):
            toks = rng.integers(0, cfg.vocab, (4, 65))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            parallel.COLLECTIVES.clear()
            a, ma = sharded(a, batch)
            b, mb = step(b, batch)
            assert sum(parallel.COLLECTIVES.values()) > 0
            assert torch.equal(ma["loss"], mb["loss"])
            assert torch.equal(ma["grad_norm"], mb["grad_norm"])
            for x, y in zip(tree_leaves((a.params, tuple(a.opt))),
                            tree_leaves((b.params, tuple(b.opt)))):
                assert torch.equal(x, y)
