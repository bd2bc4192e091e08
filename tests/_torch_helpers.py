"""Helpers for the tests that hold ``repro_torch`` against ``repro``:
numpy inputs handed to both packages. Sets no process-wide JAX state."""
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

