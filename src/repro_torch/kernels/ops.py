"""Public attention ops, dispatched by the device of their input: a CUDA
tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor takes the kernel's plain PyTorch version. There is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import flash_attn as _flash


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B,H,Sq,D); k,v: (B,KV,Skv,D) -> (B,H,Sq,D)."""
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    return _flash.flash_attention_fwd(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (B,H,1,D); k,v: (B,KV,S,D); lengths: (B,) -> (B,H,1,D)."""
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k, v, lengths)
    return _decode.decode_attention(q, k, v, lengths)
