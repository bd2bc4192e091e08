"""One gloo rank of the port's sharded train step, for
``tests/test_torch_sharded_train.py`` (run by it, one process a rank).

  python tests/_torch_mesh_worker.py OUT RANK WORLD INIT JOB...

runs each JOB in turn in one gloo process group:

  steps:M:ARCH,...   two f32 steps of each smoke arch on
                     make_host_mesh(M); rank 0 writes it to
                     record_path(): per step the loss, the grad norm, the
                     collective calls and the whole params gathered from
                     the ranks;
  launch:NAME:ARGS   ``launch.train.main`` on ARGS (split at spaces),
                     in the group this job opens (it takes a group its
                     caller opened as it is); rank 0 writes its losses
                     to OUT/launch_<NAME>.pt.

Each job's group meets at its own file, INIT with the job's index added.

An ARCH of the form ``name/vocab`` replaces the smoke config's vocab.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

STEPS = 2
BATCH, SEQ = 4, 12
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def smoke_config(arch):
    from repro_torch import configs
    name, _, vocab = arch.partition("/")
    cfg = configs.get_smoke(name)
    return dataclasses.replace(cfg, vocab=int(vocab)) if vocab else cfg


def record_path(out, mesh, arch):
    d, m = mesh
    return os.path.join(out, f"steps_{d}x{m}_{arch.replace('/', '_v')}.pt")


def batches(cfg, seed=1):
    """The global batches every rank (and the tests) draw."""
    rng = np.random.default_rng(seed)
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int64)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_config():
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainConfig
    return TrainConfig(adamw=AdamWConfig(**ADAMW), remat="full",
                       act_dtype=torch.float32)


def run_steps(out, model, archs):
    """Two steps of each arch on make_host_mesh(model)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models import parallel as par
    from repro_torch.models.param import ShardingRules
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.treeutil import tree_leaves, tree_unflatten

    mesh = make_host_mesh(model, "cpu")
    rules = ShardingRules()
    for arch in archs:
        cfg = smoke_config(arch)
        step, specs, _, init = make_train_step(cfg, mesh, rules,
                                               train_config(), device="cpu")
        place = par.placement(lm.abstract_params(cfg), rules, mesh)
        state = init(torch.Generator().manual_seed(0))
        record = []
        for batch in batches(cfg):
            par.COLLECTIVES.clear()
            state, m = step(state, batch)
            calls = sum(par.COLLECTIVES.values())
            whole = [par.gather_full(t, leaf, mesh).clone() for t, leaf in
                     zip(tree_leaves(state.params), tree_leaves(place))]
            record.append({"loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]),
                           "collectives": calls,
                           "params": tree_unflatten(state.params, whole)})
        if dist.get_rank() == 0:
            d, m = mesh.shape
            torch.save({"steps": record, "mesh": (d, m)},
                       record_path(out, (d, m), arch))


def main(argv):
    out, rank, world, init = argv[:4]
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    torch.set_num_threads(1)
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import process_group
    for i, job in enumerate(argv[4:]):
        kind, arg, rest = job.split(":", 2)
        meet = f"{init}_{i}"            # a fresh rendezvous file a group
        with process_group("cpu", meet):
            if kind == "steps":
                run_steps(out, int(arg), rest.split(","))
            else:
                losses = launch_train.main(rest.split())
                if rank == "0":
                    torch.save(losses, os.path.join(out, f"launch_{arg}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
