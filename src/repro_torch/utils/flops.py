"""Analytic FLOPs / bytes accounting of the paper's two vision models
(fvcore-equivalent, pure python): the port's copy of the vision part of
``repro/utils/flops.py``.

Conventions (fvcore's flop_count):
  * one multiply-add = 2 FLOPs,
  * ``fwd`` counts the forward pass per *item* (image),
  * training work = fwd + bwd ≈ 3 × fwd (bwd wrt inputs + wrt weights).
"""
from __future__ import annotations

import dataclasses
from typing import List

TRAIN_MULT = 3.0           # fwd + bwd(inputs) + bwd(weights)


def conv2d_flops(h_out: float, w_out: float, c_in: float, c_out: float,
                 kh: int, kw: int, groups: int = 1) -> float:
    """Per-image conv2d forward FLOPs (2 per MAC)."""
    return 2.0 * h_out * w_out * c_out * (c_in / groups) * kh * kw


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One cuttable layer of a sequential model (splitting.py consumes)."""

    name: str
    fwd_flops: float            # per item, forward only
    param_bytes: float          # segment-handoff payload contribution
    out_bits: float             # boundary activation bits per item if cut AFTER this layer
    # Active params actually touched per item (== param count for the
    # dense vision models).
    active_param_count: float = 0.0
    param_count: float = 0.0


def autoencoder_layer_costs(img: int = 224, base: int = 16,
                            latent_ch: int = 3, act_bits: int = 32) -> List[LayerCost]:
    """Conv autoencoder 224x224x3 -> 7x7xlatent_ch (paper §V-A geometry).

    Encoder: 5 stride-2 conv stages 224->112->56->28->14->7;
    decoder mirrors with transposed convs. The 7x7xlatent latent at 32 bit
    = 4.7 kbit matches the paper's D_tx.
    """
    layers: List[LayerCost] = []
    chans = [3, base, base * 2, base * 4, base * 8, latent_ch]
    res = img
    for i in range(5):
        c_in, c_out = chans[i], chans[i + 1]
        res = res // 2
        f = conv2d_flops(res, res, c_in, c_out, 3, 3)
        p = (c_in * c_out * 9 + c_out) * 4.0
        layers.append(LayerCost(
            name=f"enc{i}", fwd_flops=f, param_bytes=p,
            out_bits=res * res * c_out * act_bits,
            param_count=c_in * c_out * 9 + c_out,
            active_param_count=c_in * c_out * 9 + c_out))
    dchans = [latent_ch, base * 8, base * 4, base * 2, base, 3]
    for i in range(5):
        c_in, c_out = dchans[i], dchans[i + 1]
        res = res * 2
        f = conv2d_flops(res, res, c_in, c_out, 3, 3)
        p = (c_in * c_out * 9 + c_out) * 4.0
        layers.append(LayerCost(
            name=f"dec{i}", fwd_flops=f, param_bytes=p,
            out_bits=res * res * c_out * act_bits,
            param_count=c_in * c_out * 9 + c_out,
            active_param_count=c_in * c_out * 9 + c_out))
    return layers


def resnet18_layer_costs(img: int = 224, n_classes: int = 1000,
                         act_bits: int = 32) -> List[LayerCost]:
    """ResNet-18 stages as cuttable units (stem, 4 stages x 2 blocks, head).

    The paper's Table II cut points l1/l2/l3 correspond to cutting after
    stage1 / stage2 / stage3 (out_bits 6.42 / 3.21 / 1.61 Mbit at 32-bit
    activations: 56*56*64=200704 datum -> x32 = 6.42 Mb, etc.).
    """
    layers: List[LayerCost] = []

    def block(name, res, c_in, c_out, stride, downsample):
        f = conv2d_flops(res, res, c_in, c_out, 3, 3)
        f += conv2d_flops(res, res, c_out, c_out, 3, 3)
        p = (c_in * c_out + c_out * c_out) * 9 * 4.0 + 4 * c_out * 4.0
        if downsample:
            f += conv2d_flops(res, res, c_in, c_out, 1, 1)
            p += c_in * c_out * 4.0
        n_params = p / 4.0
        layers.append(LayerCost(name=name, fwd_flops=f, param_bytes=p,
                                out_bits=res * res * c_out * act_bits,
                                param_count=n_params, active_param_count=n_params))

    r = img // 2                       # stem: 7x7/2 conv + maxpool/2
    f_stem = conv2d_flops(r, r, 3, 64, 7, 7)
    layers.append(LayerCost("stem", f_stem, (3 * 64 * 49 + 2 * 64) * 4.0,
                            (img // 4) ** 2 * 64 * act_bits,
                            param_count=3 * 64 * 49, active_param_count=3 * 64 * 49))
    r = img // 4
    block("s1b1", r, 64, 64, 1, False)
    block("s1b2", r, 64, 64, 1, False)
    r //= 2
    block("s2b1", r, 64, 128, 2, True)
    block("s2b2", r, 128, 128, 1, False)
    r //= 2
    block("s3b1", r, 128, 256, 2, True)
    block("s3b2", r, 256, 256, 1, False)
    r //= 2
    block("s4b1", r, 256, 512, 2, True)
    block("s4b2", r, 512, 512, 1, False)
    layers.append(LayerCost("head", 2.0 * 512 * n_classes, 512 * n_classes * 4.0,
                            n_classes * act_bits,
                            param_count=512 * n_classes,
                            active_param_count=512 * n_classes))
    return layers
