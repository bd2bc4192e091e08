"""Split plans: the orbit-aware cost terms W1(ℓ), W2(ℓ), D_tx(ℓ), D_ISL(ℓ).

A sequential model is a list of :class:`LayerCost` units; cutting after
layer ℓ-1 (``cut_index = ℓ``) puts layers [0, ℓ) on the satellite and
[ℓ, L) on the ground terminal (paper §III-B: "the first split is held at
the satellite").  The four cost terms of a cut:

  W1(ℓ)    = TRAIN_MULT · Σ_{i<ℓ} fwd_flops_i       (fwd+bwd, per item)
  W2(ℓ)    = TRAIN_MULT · Σ_{i≥ℓ} fwd_flops_i
  D_tx(ℓ)  = out_bits of layer ℓ-1                   (boundary payload, one way)
  D_ISL(ℓ) = 8 · Σ_{i<ℓ} param_bytes_i               (segment-A handoff)

The paper treats gradient and activation payloads as equal-sized, which
eq. (11) encodes by charging D_tx twice — see energy.py.

``lm_plan`` builds the LayerCost list of an LM architecture from its
config (analytic FLOPs, utils/flops.py), keeping the embedding with
segment A and the head with segment B (neither is cuttable — the
satellite owns the data/tokenizer side, the ground owns the loss side,
as in Fig. 2). The port's copy of ``repro/core/splitting.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.energy import SplitCosts
from repro_torch.utils.flops import (LayerCost, TRAIN_MULT,
                                     autoencoder_layer_costs,
                                     lm_block_fwd_flops,
                                     lm_embed_head_fwd_flops,
                                     resnet18_layer_costs)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A sequential model as cuttable units + fixed head/tail work."""

    name: str
    layers: Sequence[LayerCost]
    # Work that always stays with a side regardless of ℓ:
    sat_fixed_fwd_flops: float = 0.0      # e.g. embedding lookup / frontend stub
    gs_fixed_fwd_flops: float = 0.0       # e.g. LM head + loss
    sat_fixed_param_bytes: float = 0.0    # embedding table (ships with seg A)
    train_mult: float = TRAIN_MULT
    boundary_bits_scale: float = 1.0      # <1.0 = boundary compression (beyond-paper)

    @property
    def n_cuts(self) -> int:
        return len(self.layers) + 1

    def costs_at(self, cut_index: int) -> SplitCosts:
        """SplitCosts for cutting before layer ``cut_index`` ∈ [0, L]."""
        if not 0 <= cut_index <= len(self.layers):
            raise ValueError(f"cut_index {cut_index} out of [0, {len(self.layers)}]")
        seg_a = self.layers[:cut_index]
        seg_b = self.layers[cut_index:]
        w1 = self.train_mult * (self.sat_fixed_fwd_flops
                                + sum(l.fwd_flops for l in seg_a))
        w2 = self.train_mult * (self.gs_fixed_fwd_flops
                                + sum(l.fwd_flops for l in seg_b))
        if cut_index == 0:
            dtx = self.layers[0].out_bits if self.layers else 0.0
            # cut before everything: boundary is the raw input of layer 0;
            # callers wanting the direct-download baseline should use
            # energy.direct_download_costs instead.
            dtx = 0.0
        else:
            dtx = self.layers[cut_index - 1].out_bits
        d_isl = 8.0 * (self.sat_fixed_param_bytes
                       + sum(l.param_bytes for l in seg_a))
        return SplitCosts(
            w1_flops=w1, w2_flops=w2,
            dtx_bits=dtx * self.boundary_bits_scale,
            d_isl_bits=d_isl,
            name=f"{self.name}@{cut_index}",
        )

    def enumerate_cuts(self, stride: int = 1) -> List[SplitCosts]:
        return [self.costs_at(i) for i in range(1, len(self.layers), stride)]

    def with_boundary_compression(self, bits_scale: float) -> "SplitPlan":
        """Beyond-paper: int8 (0.25) / fp8 boundary quantization."""
        return dataclasses.replace(self, boundary_bits_scale=bits_scale,
                                   name=f"{self.name}+bq{bits_scale:g}")


# --------------------------------------------------------------------------
# Paper models.
# --------------------------------------------------------------------------

def autoencoder_plan(**kw) -> SplitPlan:
    return SplitPlan("autoencoder", autoencoder_layer_costs(**kw))


def resnet18_plan(**kw) -> SplitPlan:
    return SplitPlan("resnet18", resnet18_layer_costs(**kw))


# Cut indices matching the paper's Table II l1/l2/l3 (after stage1/2/3):
RESNET18_PAPER_CUTS = {"l1": 3, "l2": 5, "l3": 7}


# --------------------------------------------------------------------------
# Assigned LM architectures (works off repro_torch.configs ArchConfig objects).
# --------------------------------------------------------------------------

def lm_plan(cfg, seq_len: int, act_bits: int = 32,
            param_bits: int = 32) -> SplitPlan:
    """Build a SplitPlan for an LM ArchConfig at a given sequence length.

    One LayerCost per block; the boundary between any two blocks is the
    residual stream (seq · d_model · act_bits).  The token embedding
    stays on the satellite side (it ships over the ISL with segment A);
    the LM head + loss stay on the ground.
    """
    layers: List[LayerCost] = []
    boundary_bits = float(seq_len) * cfg.d_model * act_bits
    for i, kind in enumerate(cfg.block_kinds()):
        f = lm_block_fwd_flops(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, seq=seq_len,
            block_kind=kind, n_experts=cfg.n_experts, top_k=cfg.top_k,
            d_head=cfg.d_head, ssm_state=cfg.ssm_state,
            causal=cfg.causal, window=cfg.window, mlp_kind=cfg.mlp_kind)
        pcount = cfg.block_param_count(kind)
        active = cfg.block_active_param_count(kind)
        layers.append(LayerCost(
            name=f"{kind}{i}", fwd_flops=f,
            param_bytes=pcount * param_bits / 8.0,
            out_bits=boundary_bits,
            param_count=pcount, active_param_count=active))
    embed_params = cfg.vocab * cfg.d_model
    head_flops = lm_embed_head_fwd_flops(cfg.d_model, cfg.vocab, seq_len)
    return SplitPlan(
        name=cfg.name, layers=layers,
        sat_fixed_fwd_flops=0.0,
        gs_fixed_fwd_flops=head_flops,
        sat_fixed_param_bytes=embed_params * param_bits / 8.0,
    )
