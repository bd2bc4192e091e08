"""The size-bucketing schedule of the reference (the port's copy of
``repro/utils/bucketing.py``): exact powers of two up to 16, then
1/8-octave granularity. The device engine (:mod:`repro_torch.sim.
device_sim`) sizes its per-pass step count with it, as the reference's
scan does, so both engines execute the same number of (masked) steps.
"""
from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def bucket_size(n: int) -> int:
    """Padded size: powers of two up to 16, then 1/8-octave steps.

    Pure pow2 bucketing wastes up to ~2x compute on padding (n=65 would
    pad to 128).  Above 16 we round up to a multiple of next_pow2(n)/8
    instead: still O(1) distinct compilations per octave, but padding is
    bounded at 25% worst-case (typically <12%).
    """
    if n <= 16:
        return next_pow2(n)
    gran = next_pow2(n) // 8
    return -(-n // gran) * gran
