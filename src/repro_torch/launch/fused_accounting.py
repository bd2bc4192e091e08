"""Kernel-fused memory accounting of six dry-run cells (the port of
``scripts/fused_accounting.py``: the same ``CELLS`` and record fields).

The reference micro-compiles the jnp attention of a cell and replaces
its bytes by an analytic model of the Pallas kernel's: Q, K, V in and O
out, times 4 in training (forward, remat and a backward of about 3x the
forward). The port needs no model: the census counts both programs of
each cell, the plain one (every kernel's plain version op by op, as the
reference's jnp path) and the fused one (each kernel launch at its
``work()``), and keeps each kernel's share. The records are read from
the dry run's JSON (``python -m repro_torch.launch.dryrun --all --out
...``), or counted on the spot for a cell it lacks.

Training in the port runs B2's forward and its remat recompute as the
kernel (two launches a block, each writing lse) and the backward as
plain PyTorch (``flash_attention_bwd_plain``, counted op by op in the
cell's bytes), so its fused attention bytes per block are two forward
launches' work, not the reference's 4x.

Usage: PYTHONPATH=src python -m repro_torch.launch.fused_accounting \
    [--dryrun results/dryrun_h100.json] [--out results/fused_accounting_h100.json]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW

CELLS = [
    ("smollm_360m", "train_4k"),
    ("llama3_8b", "train_4k"),
    ("xlstm_1_3b", "train_4k"),
    ("phi35_moe", "train_4k"),
    ("internlm2_20b", "train_4k"),
    ("granite_3_2b", "prefill_32k"),
]


def attn_blocks(cfg) -> int:
    """Attention blocks a forward runs (the reference's count: attention,
    shared-attention and MoE blocks, and an encoder-decoder's encoder
    and cross-attention)."""
    n = sum(1 for k in cfg.block_kinds() if k in ("attn", "shared_attn",
                                                  "moe"))
    if cfg.enc_dec:
        n += cfg.n_enc_layers + cfg.n_layers
    return n


def record(arch: str, shape_name: str, row: Dict) -> Dict:
    """The reference's record from a dry-run row with both counts."""
    n_attn = attn_blocks(configs.get(arch))
    cost = row["cost"]
    per_block = lambda k: (k.get("flash_attn_fwd", {}).get("bytes", 0.0)
                           / n_attn if n_attn else 0.0)
    plain_b, fused_b = cost["plain"]["bytes"], cost["fused"]["bytes"]
    return {
        "arch": arch, "shape": shape_name,
        "attn_blocks": n_attn,
        "attn_bytes_measured_per_block": per_block(cost["plain_kernels"]),
        "attn_bytes_fused_per_block": per_block(cost["kernels"]),
        "cell_bytes_baseline": plain_b,
        "cell_bytes_kernel_fused": fused_b,
        "memory_s_baseline": plain_b / HBM_BW,
        "memory_s_kernel_fused": fused_b / HBM_BW,
    }


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_h100.json")
    ap.add_argument("--out", default="results/fused_accounting_h100.json")
    args = ap.parse_args(argv)
    rows = {}
    if os.path.exists(args.dryrun):
        with open(args.dryrun) as f:
            rows = {(r["arch"], r["shape"], r["preset"]): r
                    for r in json.load(f) if r["mesh"] == dryrun.MESH}
    out = []
    for arch, shape_name in CELLS:
        row = rows.get((arch, shape_name, "baseline"))
        if row is None or row.get("status") != "ok" or not (
                row["cost"]["plain"] and row["cost"]["fused"]):
            row = dryrun.lower_cell(arch, shape_name, verbose=False)
        rec = record(arch, shape_name, row)
        out.append(rec)
        print(f"{arch} x {shape_name}: attn {rec['attn_blocks']} blocks | "
              f"plain {rec['attn_bytes_measured_per_block']:.3e} B/blk vs "
              f"fused {rec['attn_bytes_fused_per_block']:.3e} | memory term "
              f"{rec['memory_s_baseline']:.2f}s -> "
              f"{rec['memory_s_kernel_fused']:.2f}s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
