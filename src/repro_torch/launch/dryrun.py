"""Dry run of every (arch x shape) cell on one H100, on the meta device
(the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for a TPU pod and reads
XLA's ``memory_analysis()`` and ``cost_analysis()``. The port runs the
cell's step on meta tensors (no storage, nothing computed) under a
:class:`repro_torch.utils.census.Census` and reads the same terms from
it: the census's peak live bytes for memory, its FLOPs and bytes for
the roofline, and each kernel's launches and work. The count is of the
program the card runs (``fused``: each kernel launch counts its work,
the rest op by op) and, with the cost pass, also of the plain program
(every kernel's plain version op by op, as the reference counts its
jnp paths). The roofline's terms use the H100 constants of
:mod:`repro_torch.launch.mesh`: they are computed, not measured.

Per cell:
  * train: ``make_train_step``'s step (``loss_and_grads`` under the
    preset's remat, then AdamW) on the cell's batch;
  * prefill: ``make_prefill_step``'s step on the cell's prompts;
  * decode: ``make_decode_step(device="meta")``'s step, one token
    against a cache of ``s_max = seq_len`` (the census takes it full).

Presets whose knobs change the port's program are ported; those that
only shard, tile or set ``attn_compute_dtype`` (which ``Ctx`` accepts
and ignores) report ``status: "skipped"`` naming the ignored knob. One
card: ``--multi-pod`` and ``--both-meshes`` are refused, the mesh is
``h100x1`` and the collective term is zero.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_h100.json
  python -m repro_torch.launch.roofline results/dryrun_h100.json --md
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        input_specs, skip_reason)
from repro_torch.core.splitting import lm_plan
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)
from repro_torch.models import lm
from repro_torch.models.param import map_tree
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import (TrainConfig, TrainState,
                                    make_decode_step, make_prefill_step,
                                    make_train_step)
from repro_torch.utils.census import Census

MESH = "h100x1"

# The reference's presets whose knobs change the port's program.
PRESETS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "noremat": {"tcfg": {"remat": "none"}},
    "dots": {"tcfg": {"remat": "dots"}},
    "fp32act": {"tcfg": {"act_dtype": torch.float32}},
    # pad attention heads to a multiple of 16 (the reference's model axis)
    "padheads": {"cfg": {"pad_heads": True}},
    "chunk128": {"tcfg": {"mlstm_chunk": 128}},
    "chunk64": {"tcfg": {"mlstm_chunk": 64}},
    "opt_xlstm": {"tcfg": {"mlstm_chunk": 64, "remat": "dots"}},
    "moelocal": {"tcfg": {"moe_dispatch": "batch_local"}},
    "opt_moe2": {"tcfg": {"moe_dispatch": "batch_local",
                          "attn_compute_dtype": torch.bfloat16},
                 "ignored": "attn_compute_dtype (Ctx accepts and ignores "
                            "it)"},
}
_RULES = "rules (sharding over a TPU mesh; the port runs on one card)"
_ATTN_DT = "attn_compute_dtype (Ctx accepts and ignores it)"
# The reference's presets that only shard, tile or set the ignored knob.
SKIPPED_PRESETS: Dict[str, str] = {
    "seqshard": _RULES,
    "ep": _RULES,
    "puredp": _RULES,
    "opt": f"{_RULES}; {_ATTN_DT}",
    "opt_moe": f"{_RULES}; {_ATTN_DT}",
    "bigblocks": "block_q, block_k (TPU tiles; Ctx ignores them, each "
                 "kernel sets its own)",
    "bf16attn": _ATTN_DT,
}


def build_tcfg(overrides: Dict[str, Any]) -> TrainConfig:
    return dataclasses.replace(TrainConfig(), **overrides)


def meta_params(cfg) -> Dict:
    """The model's parameters as meta tensors (``lm.abstract_params``)."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    lm.abstract_params(cfg))


def make_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, *, params=None,
              batch=None, device="meta"):
    """(run, args): ``run(*args)`` is one step of ``shape``'s kind and
    ``args`` hold every tensor it reads (parameters, optimizer state,
    batch, cache). ``params`` and ``batch`` default to meta stand-ins
    (``meta_params``, ``input_specs``); on the card pass real ones (a
    decode batch holds ``tokens`` and ``positions``). A train step
    updates the parameters in place, as the train step does."""
    params = meta_params(cfg) if params is None else params
    batch = (input_specs(cfg, shape, act_dtype=tcfg.act_dtype)
             if batch is None else batch)
    if shape.kind == "train":
        step = make_train_step(cfg, tcfg=tcfg, device=device)[0]
        return step, (TrainState(params, adamw_init(params), None), batch)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, act_dtype=tcfg.act_dtype)[0]
        return step, (params, batch)
    step, _, _, cache = make_decode_step(
        cfg, batch=shape.global_batch, s_max=shape.seq_len,
        act_dtype=tcfg.act_dtype, device=device)
    return (lambda p, c, b: step(p, c, b["tokens"], b["positions"]),
            (params, cache, batch))


def count_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, *,
               fused: bool = True, **kw) -> Census:
    """One step of ``make_step(cfg, shape, tcfg, **kw)`` under a
    :class:`Census`, returned after it exits."""
    run, args = make_step(cfg, shape, tcfg, **kw)
    census = Census(fused=fused, device=kw.get("device", "meta"))
    census.track(args)
    with census:
        run(*args)
    return census


def model_flops(cfg, shape: ShapeSpec) -> Dict[str, float]:
    """6·N·D (train) / 2·N·D (inference) with N = active non-embedding
    params + head; plus the analytic full-graph estimate (incl.
    attention). The reference's ``_model_flops``."""
    n_active = cfg.active_param_count() - cfg.vocab * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch * 1
        mult = 2.0
    plan = lm_plan(cfg, shape.seq_len if shape.kind != "decode" else 1)
    analytic = (sum(l.fwd_flops * (l.active_param_count
                                   / max(l.param_count, 1))
                    for l in plan.layers)
                + plan.gs_fixed_fwd_flops)
    analytic *= shape.global_batch * (3.0 if shape.kind == "train" else 1.0)
    return {"model_flops_6nd": mult * n_active * tokens,
            "analytic_flops": analytic}


def roofline(flops: float, nbytes: float, model_flops_6nd: float,
             act_dtype) -> Dict[str, Any]:
    """The roofline terms on one H100: compute at the bf16 or f32 peak
    (by ``act_dtype``), memory at HBM_BW, no collective."""
    peak = PEAK_FLOPS_BF16 if act_dtype == torch.bfloat16 else PEAK_FLOPS_F32
    terms = {"compute_s": flops / peak, "memory_s": nbytes / HBM_BW,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    useful_s = model_flops_6nd / peak
    bound_s = max(terms.values())
    return {**terms, "dominant": dominant, "useful_s": useful_s,
            "bound_s": bound_s,
            "roofline_fraction": useful_s / bound_s if bound_s > 0 else 0.0,
            "flops_ratio_useful": model_flops_6nd / flops if flops else 0.0}


def _pad_heads(cfg):
    """The reference's padheads: heads padded to a multiple of 16 where
    the padded count still divides by the KV heads."""
    pad = (-cfg.n_heads) % 16
    if pad and (cfg.n_heads + pad) % cfg.n_kv_heads == 0:
        return dataclasses.replace(cfg, n_heads=cfg.n_heads + pad)
    return cfg


def lower_cell(arch: str, shape_name: str, preset: str = "baseline",
               fused: bool = True, *, verbose: bool = True,
               cost_pass: bool = True) -> Dict[str, Any]:
    """One dry-run cell: the step counted as ``fused`` says (the roofline
    reads it) and, with ``cost_pass``, counted the other way too."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "preset": preset, "mesh": MESH}
    if preset in SKIPPED_PRESETS:
        result.update(status="skipped", reason=f"preset {preset} sets only "
                      f"knobs the port ignores: {SKIPPED_PRESETS[preset]}")
        return result
    over = PRESETS[preset]
    if over.get("cfg", {}).get("pad_heads"):
        cfg = _pad_heads(cfg)
    if "ignored" in over:
        result["ignored"] = over["ignored"]
    if not applicable(cfg, shape):
        result.update(status="skipped", reason=skip_reason(cfg, shape))
        return result
    tcfg = build_tcfg(over.get("tcfg", {}))

    t0 = time.time()
    main = count_step(cfg, shape, tcfg, fused=fused).result()
    other = (count_step(cfg, shape, tcfg, fused=not fused).result()
             if cost_pass else None)
    census_s = time.time() - t0
    fused_r, plain_r = (main, other) if fused else (other, main)
    mf = model_flops(cfg, shape)
    rf = roofline(main["flops"], main["bytes"], mf["model_flops_6nd"],
                  tcfg.act_dtype)
    pick = lambda r: None if r is None else {"flops": r["flops"],
                                             "bytes": r["bytes"],
                                             "n_ops": r["n_ops"]}
    peak = main["peak_bytes"]
    result.update({
        "status": "ok",
        "n_chips": 1,
        "n_units": cfg.n_units,
        "fused": fused,
        "census_s": round(census_s, 2),
        "memory": {"argument_size_in_bytes": float(main["base_bytes"]),
                   "temp_size_in_bytes": float(peak - main["base_bytes"]),
                   "total_per_device_bytes": float(peak),
                   "hbm_bytes": HBM_BYTES, "fits": peak <= HBM_BYTES},
        "cost": {"flops": main["flops"], "bytes_accessed": main["bytes"],
                 "fused": pick(fused_r), "plain": pick(plain_r),
                 "kernels": None if fused_r is None else fused_r["kernels"],
                 "plain_kernels": (None if plain_r is None
                                   else plain_r["plain_kernels"]),
                 "ops": main["ops"]},
        "collectives": main["collectives"],
        "collective_bytes_per_device": 0.0,
        **mf,
        "roofline": rf,
    })
    if verbose:
        print(f"[{MESH}:{preset}] {arch} x {shape_name}: census "
              f"{census_s:.1f}s | flops {main['flops']:.3e} bytes "
              f"{main['bytes']:.3e} | T(comp/mem/coll) "
              f"{rf['compute_s']:.4f}/{rf['memory_s']:.4f}/0s -> "
              f"{rf['dominant']} | roofline {rf['roofline_fraction']:.3f} "
              f"| peak {peak:.3e} B (fits {peak <= HBM_BYTES})")
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the port runs on one card")
    ap.add_argument("--both-meshes", action="store_true",
                    help="refused: the port runs on one card")
    ap.add_argument("--preset", default="baseline",
                    choices=sorted(PRESETS) + sorted(SKIPPED_PRESETS))
    ap.add_argument("--no-cost-pass", action="store_true",
                    help="count the fused program only (no plain count)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        ap.error("--multi-pod / --both-meshes: the port runs on one card "
                 f"(mesh {MESH})")

    if args.all:
        cells = [(a, s) for a in configs.ASSIGNED for s in SHAPES]
    elif args.arch and not args.shape:
        cells = [(args.arch, s) for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch [--shape] or --all")

    results = []
    failures = 0
    for a, s in cells:
        try:
            results.append(lower_cell(a, s, preset=args.preset,
                                      cost_pass=not args.no_cost_pass))
        except Exception:                 # a cell that fails is recorded
            failures += 1
            traceback.print_exc()
            results.append({"arch": a, "shape": s, "mesh": MESH,
                            "preset": args.preset, "status": "error",
                            "error": traceback.format_exc()[-2000:]})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        key = lambda r: (r["arch"], r["shape"], r["mesh"], r["preset"])
        merged = {key(r): r for r in existing}
        for r in results:
            merged[key(r)] = r
        with open(args.out, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"wrote {len(results)} cells -> {args.out}")
    ok = sum(r.get("status") == "ok" for r in results)
    sk = sum(r.get("status") == "skipped" for r in results)
    print(f"dry-run: {ok} ok, {sk} skipped, {failures} failed, "
          f"{len(results)} total")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
