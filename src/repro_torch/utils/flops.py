"""Analytic FLOPs / bytes accounting (fvcore-equivalent, pure python):
the port's copy of ``repro/utils/flops.py``.

Conventions (match fvcore's flop_count and the roofline spec):
  * one multiply-add = 2 FLOPs,
  * ``fwd`` counts the forward pass per *item* (image / sequence),
  * training work = fwd + bwd ≈ 3 × fwd (bwd wrt inputs + wrt weights),
  * MODEL_FLOPS for LM rooflines = 6 · N_params · tokens (dense) or
    6 · N_active · tokens (MoE), per the Kaplan/Chinchilla convention.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

TRAIN_MULT = 3.0           # fwd + bwd(inputs) + bwd(weights)


def matmul_flops(m: float, k: float, n: float) -> float:
    """C[m,n] = A[m,k] @ B[k,n]: 2*m*k*n FLOPs."""
    return 2.0 * m * k * n


def conv2d_flops(h_out: float, w_out: float, c_in: float, c_out: float,
                 kh: int, kw: int, groups: int = 1) -> float:
    """Per-image conv2d forward FLOPs (2 per MAC)."""
    return 2.0 * h_out * w_out * c_out * (c_in / groups) * kh * kw


def attention_flops(seq_q: float, seq_kv: float, n_heads: float,
                    d_head: float, causal: bool = False,
                    window: Optional[int] = None) -> float:
    """QK^T + AV matmul FLOPs for one sequence (logits+probs ignored)."""
    if window is not None and window < seq_kv:
        # sliding window: each query attends to <= window keys
        eff = seq_q * min(window, seq_kv)
    elif causal and seq_q == seq_kv:
        eff = seq_q * seq_kv / 2.0
    else:
        eff = seq_q * seq_kv
    return 2.0 * 2.0 * n_heads * eff * d_head   # 2 matmuls x 2 FLOP/MAC


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One cuttable layer of a sequential model (splitting.py consumes)."""

    name: str
    fwd_flops: float            # per item, forward only
    param_bytes: float          # segment-handoff payload contribution
    out_bits: float             # boundary activation bits per item if cut AFTER this layer
    # Active params actually touched per item (== param count for dense,
    # top_k/E fraction for MoE). Used for MODEL_FLOPS.
    active_param_count: float = 0.0
    param_count: float = 0.0


def total_fwd_flops(layers: Sequence[LayerCost]) -> float:
    return sum(l.fwd_flops for l in layers)


def total_param_bytes(layers: Sequence[LayerCost]) -> float:
    return sum(l.param_bytes for l in layers)


# --------------------------------------------------------------------------
# Paper models: autoencoder (Fig. 3 top) and ResNet-18 (Fig. 3 bottom).
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# LM architectures: per-block analytic FLOPs from an ArchConfig-like object.
# --------------------------------------------------------------------------

def lm_block_fwd_flops(d_model: int, n_heads: int, n_kv_heads: int,
                       d_ff: int, seq: int, block_kind: str = "attn",
                       n_experts: int = 0, top_k: int = 0,
                       d_head: Optional[int] = None,
                       ssm_state: int = 64, causal: bool = True,
                       window: Optional[int] = None,
                       mlp_kind: str = "swiglu") -> float:
    """Forward FLOPs for one block processing a whole sequence of length seq."""
    dh = d_head or (d_model // n_heads)
    f = 0.0
    if block_kind in ("attn", "attn_dense", "shared_attn"):
        # projections: q (H*dh), k,v (KV*dh), o (H*dh)
        f += matmul_flops(seq, d_model, (2 * n_heads + 2 * n_kv_heads) * dh)
        f += attention_flops(seq, seq, n_heads, dh, causal=causal, window=window)
    elif block_kind == "mamba2":
        d_inner = 2 * d_model
        f += matmul_flops(seq, d_model, 2 * d_inner)          # in_proj (x, z)
        f += 2.0 * seq * d_inner * 4                          # conv1d k=4
        f += matmul_flops(seq, d_inner, 2 * ssm_state + 1)    # B, C, dt
        f += 6.0 * seq * d_inner * ssm_state                  # selective scan
        f += matmul_flops(seq, d_inner, d_model)              # out_proj
        return f                                              # no separate FFN
    elif block_kind == "mlstm":
        d_inner = 2 * d_model
        f += matmul_flops(seq, d_model, 3 * d_inner)          # q,k,v proj
        f += 6.0 * seq * d_inner * dh                         # matrix-memory update
        f += matmul_flops(seq, d_inner, d_model)
        return f
    elif block_kind == "slstm":
        f += matmul_flops(seq, d_model, 4 * d_model) * 2      # gates in+rec
        f += 10.0 * seq * d_model
        return f
    # FFN part
    if n_experts and top_k:
        f += matmul_flops(seq, d_model, n_experts)            # router
        f += top_k * 3.0 * matmul_flops(seq, d_model, d_ff)   # gate/up/down per active expert
    elif d_ff:
        n_mm = 3.0 if mlp_kind == "swiglu" else 2.0
        f += n_mm * matmul_flops(seq, d_model, d_ff)          # SwiGLU / GELU MLP
    return f


def lm_embed_head_fwd_flops(d_model: int, vocab: int, seq: int) -> float:
    """Output head matmul (embedding lookup is a gather ~0 FLOPs)."""
    return matmul_flops(seq, d_model, vocab)
