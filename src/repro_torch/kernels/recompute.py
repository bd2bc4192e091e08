"""The backward of the scan kernels (B4, B5): the gradient of the plain
scan, re-run on the saved inputs. The reference's scans are jnp, so
their gradient is that of the jnp scan, and the port's is that of the
same scan in plain PyTorch."""
from __future__ import annotations

import torch


def flat(out):
    """The tensors of an op's output (a tensor or nested tuples), in order."""
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in flat(o)]


def recompute_grads(plain, inputs, needs, grads_out, **kw):
    """The gradients of ``plain(*inputs, **kw)``'s outputs (flattened,
    in order) against ``grads_out`` (None: no gradient), for the inputs
    flagged in ``needs`` (None for the others): the plain version re-run
    on detached copies of the inputs under grad mode."""
    leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = plain(*leaves, **kw)
    pairs = [(o, g) for o, g in zip(flat(out), grads_out)
             if o.requires_grad and g is not None]
    want = [t for t, n in zip(leaves, needs) if n]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   want, [g for _, g in pairs],
                                   allow_unused=True)
               if want and pairs else [None] * len(want))
    return tuple(next(got) if n else None for n in needs)
