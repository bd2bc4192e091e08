"""The host's mesh and the card's roofline constants (the port of
``repro/launch/mesh.py``).

:func:`make_host_mesh` is the reference's: a ``(n // m, m)`` mesh named
``("data", "model")`` over the ranks that exist, here the ranks of the
default ``torch.distributed`` process group (one per card, or gloo
ranks on the CPU) where the reference takes the host's devices.
:func:`process_group` opens that group for an entry point: the ranks
``torchrun`` (or the caller) describes, or one rank. The reference's
module also holds a v5e chip's peaks; the port holds an H100 SXM's.

Not ported: ``make_production_mesh`` (the reference's 16 x 16 and
2 x 16 x 16 TPU pods), ``make_fleet_mesh`` and ``plane_sharding`` (the
fleets run every plane on one card).
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the 700 W
# power limit; a card set below it runs slower under load.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
HBM_BYTES = 80e9                  # B of HBM3 (the data sheet's 80 GB)
NVLINK_BW = 450e9                 # B/s per direction (900 GB/s both ways)

# a rank that waits longer than this on a collective fails the run
TIMEOUT_S = 60


def make_host_mesh(model: int = 1, device="cpu"):
    """A ``DeviceMesh`` of shape ``(world // m, m)`` named ``("data",
    "model")`` over the default process group's ranks, ``m`` clamped to
    ``[1, world]`` as the reference clamps it to the host's devices; on
    ``cuda`` ranks when ``device`` is a CUDA device, else on the CPU
    (gloo). One rank gives ``(1, 1)``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = max(1, min(int(model), n))
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model}")
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))


def rank_card(device) -> torch.device:
    """This rank's card for a CUDA ``device``: ``cuda:LOCAL_RANK`` when
    the ranks are described (``WORLD_SIZE`` set, as ``torchrun`` sets
    it), where an index in ``device`` that names another card raises;
    else the card ``device`` names (``cuda`` is ``cuda:0``)."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return torch.device("cuda", dev.index or 0)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    if dev.index is not None and dev.index != local:
        raise ValueError(f"device {dev} on the rank of LOCAL_RANK {local}: "
                         f"each rank takes cuda:LOCAL_RANK")
    return torch.device("cuda", local)


@contextlib.contextmanager
def process_group(device="cuda", init_method=None):
    """The default process group for one run, and this rank's device.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the ranks join
    by ``init_method`` (``env://`` by default); otherwise this process is
    one rank of one, joined through an in-memory store. NCCL serves
    ``cuda`` (the card :func:`rank_card` picks), gloo the CPU. A rank
    that waits on a collective longer than :data:`TIMEOUT_S` raises, so
    when one rank dies the others stop. A group opened here is destroyed
    on exit; one the caller opened is used as it is."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("process_group: a cuda run needs a card; pass "
                               "device='cpu' to run on gloo ranks")
        dev = rank_card(device)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        yield dev
        return
    kw = dict(backend="nccl" if cuda else "gloo",
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                                **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
