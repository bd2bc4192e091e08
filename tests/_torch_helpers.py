"""Helpers for the tests that hold ``repro_torch`` against ``repro``:
numpy inputs handed to both packages. Sets no process-wide JAX state."""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def both(a, dtype=jnp.float32):
    """One numpy array as (jax array, torch CPU tensor) of ``dtype``; the
    f32 -> bf16 rounding is round-to-nearest-even on both sides."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def np32(x):
    """A jax array or torch tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_tree_to_numpy(tree):
    return jax.tree.map(np.asarray, tree)



class BatchTable:
    """A traceable ``(sat, idx) -> batch`` provider over a table of
    batches made elsewhere (e.g. by the reference's jax.random provider):
    ``images`` (S, I, B, H, W, C) and ``labels`` (S, I, B) tensors. The
    lookup is an index_select at ``sat * I + idx``, so ``sat`` and
    ``idx`` may be device tensors and nothing is read back."""

    traceable = True

    def __init__(self, images, labels):
        self.images, self.labels = images, labels
        self.device = images.device
        self.n_idx = images.shape[1]

    def _flat(self, sat, idx):
        sat = torch.as_tensor(sat, device=self.device).reshape(1).long()
        return sat * self.n_idx + torch.as_tensor(
            idx, device=self.device).reshape(1).long()

    def __call__(self, sat, idx):
        at = self._flat(sat, idx)
        im = self.images.reshape((-1,) + tuple(self.images.shape[2:]))
        lb = self.labels.reshape((-1,) + tuple(self.labels.shape[2:]))
        return {"images": im.index_select(0, at)[0],
                "labels": lb.index_select(0, at)[0]}

    def meta_batch(self, sat=0, idx=0):
        return {"images": torch.empty(self.images.shape[2:],
                                      dtype=self.images.dtype, device="meta"),
                "labels": torch.empty(self.labels.shape[2:],
                                      dtype=self.labels.dtype, device="meta")}

    batch_at = __call__


def fleet_host_view(fleet):
    """A port fleet's host arrays under the attribute names the
    reference's NumPy oracles (``fleet.scenarios.oracle_actions``,
    ``isl.exchange.oracle_exchange``) read; call it before the fleet
    runs."""
    from repro_torch.sim.energy_state import EnergyState

    return types.SimpleNamespace(
        schedule=fleet.schedule, cfg=fleet.cfg,
        scenario_schedule=fleet.scenario_schedule, plan=fleet._host_plan,
        energy=EnergyState(*[t.cpu().numpy() for t in fleet.energy]),
        _failed=fleet._failed.cpu().numpy(), budget=fleet.budget,
        exchange=fleet.exchange, _ex_on=fleet._ex_on,
        _ex_bits=fleet._ex_bits, _ex_energy_j=fleet._ex_energy_j,
        rev_len=fleet.rev_len, n_planes=fleet.n_planes)


@contextlib.contextmanager
def one_torch_thread():
    """Run the block with one intra-op torch thread, then restore the
    count. The engines' loops are thousands of tiny ops; under a test run
    with several workers on the same cores, idle intra-op threads of every
    worker compete for them and such a loop runs ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
