"""PyTorch/CUDA port of the split-learning LM serving path.

A second package beside ``repro`` (the JAX reference). It imports
``torch`` and never ``jax`` or ``repro``; the tests hold it against the
reference on the CPU, and ``chip_smoke.py`` drives it on an H100.

Entry points take a ``device`` argument that defaults to ``"cuda"``;
nothing silently falls back to the CPU (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a GPU raises:
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
