"""The card's roofline constants (the port of ``repro/launch/mesh.py``).

The reference's module builds TPU meshes (a 16 x 16 v5e pod, two pods,
the host's devices, the fleet's plane axis) and holds a v5e chip's
peaks. The port runs on one H100, so it keeps only the constants, an
H100 SXM's in place of the v5e's. Not ported, by decision (one card, as
for the pjit placement): ``make_production_mesh``, ``make_host_mesh``,
``make_fleet_mesh`` and ``plane_sharding``.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the 700 W
# power limit; a card set below it runs slower under load.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
HBM_BYTES = 80e9                  # B of HBM3 (the data sheet's 80 GB)
NVLINK_BW = 450e9                 # B/s per direction (900 GB/s both ways)
