"""Architecture configs (the port's own copy of ``repro.configs``).

Each ``<id>.py`` exposes ``CONFIG: ArchConfig`` with the published
hyper-parameters, plus ``smoke_config()`` returning a reduced same-family
config for CPU tests. ``get(name)`` / ``get_smoke(name)`` resolve either.
The dataclass keeps every field of the reference, so the other configs
copy over unchanged, and its helpers, the parameter counts
(``block_param_count``, ``param_count`` and their active variants,
which ``core.splitting.lm_plan`` reads) with the same float arithmetic.

Block kinds the port serves: ``attn`` (GQA attention + MLP), ``moe``
(GQA attention + top-k MoE MLP), ``mamba2`` (Mamba-2 SSD block, no
separate MLP), ``shared_attn`` (Zamba2's one attention + MLP block whose
weights every occurrence shares), and xLSTM's ``mlstm`` (matrix memory)
and ``slstm`` (scalar recurrence). Whisper's encoder-decoder
(``enc_dec``: an encoder stack over ``frontend_len`` stub frames and
cross-attention in every decoder block) runs through ``lm.forward``,
``lm.loss`` and ``lm.decode_step``; as in the reference, the serving
engines and the split decode refuse it.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_experts: int = 0
    top_k: int = 0
    d_head: Optional[int] = None
    ssm_state: int = 0
    causal: bool = True
    window: Optional[int] = None            # sliding-window attention
    # Repeating block pattern, stacked as units of len(pattern) blocks.
    # None => all-"attn" (or all-"moe" if n_experts>0).
    pattern: Optional[Tuple[str, ...]] = None
    rope_theta: float = 500_000.0
    mrope: bool = False
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None
    frontend_len: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    sub_quadratic: bool = False
    capacity_factor: float = 1.25
    moe_every: int = 1
    mlp_kind: str = "swiglu"                # swiglu (3 matmuls) | gelu (2)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """Inner width of mamba2/mlstm blocks (2x expansion)."""
        return 2 * self.d_model

    def block_kinds(self) -> List[str]:
        if self.pattern is None:
            kind = "moe" if self.n_experts else "attn"
            return [kind] * self.n_layers
        reps = math.ceil(self.n_layers / len(self.pattern))
        return (list(self.pattern) * reps)[: self.n_layers]

    def pattern_unit(self) -> Tuple[str, ...]:
        """The repeating unit stacked along the model's unit axis."""
        if self.pattern is None:
            return ("moe",) if self.n_experts else ("attn",)
        return self.pattern

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern_unit())

    # ------------------------------------------------------- param accounting
    def block_param_count(self, kind: str) -> float:
        d, dh = self.d_model, self.head_dim
        if kind in ("attn", "shared_attn"):
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
            n_mm = 3 if self.mlp_kind == "swiglu" else 2
            ffn = n_mm * d * self.d_ff if self.d_ff else 0
            return attn + ffn + 2 * d
        if kind == "moe":
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            return attn + ffn + 2 * d
        if kind == "mamba2":
            di, n = self.d_inner, self.ssm_state or 64
            return (d * 2 * di + di * 4            # in_proj + conv1d(k=4)
                    + di * (2 * n)                 # B, C proj
                    + di                           # dt proj (per-channel)
                    + di * d + 2 * d)              # out_proj + norms
        if kind == "mlstm":
            di = self.d_inner
            return d * 3 * di + 3 * di + di * d + 2 * d
        if kind == "slstm":
            return 2 * d * 4 * d + 4 * d + 2 * d
        raise ValueError(kind)

    def block_active_param_count(self, kind: str) -> float:
        if kind == "moe":
            d = self.d_model
            dh = self.head_dim
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
            ffn = self.top_k * 3 * d * self.d_ff + d * self.n_experts
            return attn + ffn + 2 * d
        return self.block_param_count(kind)

    def param_count(self) -> float:
        kinds = self.block_kinds()
        shared_done = False
        total = 0.0
        for k in kinds:
            if k == "shared_attn":
                if shared_done:
                    continue
                shared_done = True
            total += self.block_param_count(k)
        total += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.enc_dec:
            enc = self.n_enc_layers * self.block_param_count("attn")
            cross = self.n_layers * (2 * self.d_model * self.n_heads * self.head_dim
                                     + 2 * self.d_model)
            total += enc + cross
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> float:
        kinds = self.block_kinds()
        shared_done = False
        total = 0.0
        for k in kinds:
            if k == "shared_attn":
                if shared_done:
                    continue
                shared_done = True
            total += self.block_active_param_count(k)
        total += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.enc_dec:
            total += self.n_enc_layers * self.block_param_count("attn")
            total += self.n_layers * (2 * self.d_model * self.n_heads * self.head_dim
                                      + 2 * self.d_model)
        total += self.d_model
        return total


ASSIGNED = [
    "xlstm_1_3b", "granite_3_2b", "llama3_8b", "smollm_360m", "internlm2_20b",
    "phi35_moe", "mixtral_8x7b", "qwen2_vl_7b", "zamba2_1_2b", "whisper_small",
]

PAPER_MODELS = ["resnet18", "autoencoder"]


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def get_smoke(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.smoke_config()


def all_assigned() -> Dict[str, ArchConfig]:
    return {n: get(n) for n in ASSIGNED}
