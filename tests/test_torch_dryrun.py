"""The port's analysis tools against the reference's on the CPU: the
shape cells (``configs.shapes``), the model FLOPs and the fused
attention bytes (in one subprocess: the reference's ``launch/dryrun.py``
and ``scripts/fused_accounting.py`` set a 512-device ``XLA_FLAGS`` when
imported), the roofline report's table and picks on the same rows; then
the dry run itself (one cell at SmolLM-360M's width on meta, the rest on
smoke configs), its presets and CLI, fused_accounting's records, and the
H100 constants. Tolerances: every comparison is exact (the arithmetic is
the same)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import roofline as jroofline
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core.compute_model import H100_SPEC, PAPER_DEVICE
from repro_torch.launch import dryrun, fused_accounting, mesh, roofline

ROOT = Path(__file__).resolve().parents[1]
DTYPE = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
         jnp.float32: torch.float32}


# ----------------------------------------------------------- the shapes

def test_shapes_equal_the_reference():
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, s in shapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert shapes.cell_list(configs.ASSIGNED) == \
        jshapes.cell_list(jconfigs.ASSIGNED)


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_applicability_and_input_specs_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name, s in shapes.SHAPES.items():
        j = jshapes.SHAPES[name]
        assert shapes.applicable(cfg, s) == jshapes.applicable(jcfg, j)
        assert shapes.skip_reason(cfg, s) == jshapes.skip_reason(jcfg, j)
        for act, jact in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
            got = shapes.input_specs(cfg, s, act_dtype=act)
            want = jshapes.input_specs(jcfg, j, act_dtype=jact)
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.is_meta
                assert tuple(t.shape) == tuple(want[k].shape), (name, k)
                assert t.dtype == DTYPE[want[k].dtype.type], (name, k)


# ------------------------------------- model FLOPs and fused bytes

_PARITY = r"""
import importlib.util, json, sys
from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import dryrun as jdry
spec = importlib.util.spec_from_file_location("fa", "scripts/fused_accounting.py")
fa = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fa)
import torch
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import flash_attn
from repro_torch.launch import dryrun
bad, n = [], 0
for arch in configs.ASSIGNED:
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name, s in SHAPES.items():
        got = dryrun.model_flops(cfg, s)
        want = jdry._model_flops(jcfg, JSHAPES[name])
        n += 1
        if got != want:
            bad.append([arch, name, got, want])
        if s.kind == "decode":
            continue
        meta = lambda h: torch.empty((s.global_batch, h, s.seq_len,
                                      cfg.head_dim), dtype=torch.bfloat16,
                                     device="meta")
        got = flash_attn.work(meta(cfg.n_heads), meta(cfg.n_kv_heads),
                              causal=cfg.causal, window=cfg.window)[0]
        want = (fa.fused_attention_bytes(jcfg, JSHAPES[name], 1)
                / (4 if s.kind == "train" else 1))
        n += 1
        if got != want:
            bad.append([arch, name, "fused bytes", got, want])
print(json.dumps({"bad": bad, "n": n}))
"""


def test_model_flops_and_fused_bytes_equal_the_reference():
    """Every ASSIGNED x shape cell's 6ND and analytic FLOPs against the
    reference's ``_model_flops``, and B2's work() bytes of one forward
    call against ``fused_attention_bytes`` (its 4x training multiplier
    divided out), exactly, in a subprocess of its own."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _PARITY], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] == 10 * 4 + 10 * 2 and out["bad"] == []


# ------------------------------------------------------- the roofline

def _rows():
    rf = lambda c, m, u, frac, ratio: {
        "compute_s": c, "memory_s": m, "collective_s": 0.0,
        "dominant": "compute_s" if c >= m else "memory_s", "useful_s": u,
        "bound_s": max(c, m), "roofline_fraction": frac,
        "flops_ratio_useful": ratio}
    return [
        {"arch": "smollm_360m", "shape": "train_4k", "preset": "baseline",
         "status": "ok", "roofline": rf(4.0858, 41.2598, 2.0, 0.0485, 0.49)},
        {"arch": "llama3_8b", "shape": "prefill_32k", "preset": "baseline",
         "status": "ok", "roofline": rf(25.02, 12.24, 15.9, 0.636, 0.64)},
        {"arch": "xlstm_1_3b", "shape": "long_500k", "preset": "dots",
         "status": "ok", "roofline": rf(0.0, 0.00676, 3.467e-06, 5.1e-4,
                                         0.0012)},
        {"arch": "granite_3_2b", "shape": "long_500k", "preset": "baseline",
         "status": "skipped"},
        {"arch": "phi35_moe", "shape": "decode_32k", "preset": "baseline",
         "status": "error"},
        {"arch": "zamba2_1_2b", "shape": "decode_32k", "preset": "baseline",
         "status": "ok", "roofline": rf(5e-4, 0.2009, 2.34e-4, 1.2e-3,
                                         1.16e4)},
    ]


@pytest.mark.parametrize("md", [False, True])
def test_roofline_table_and_picks_equal_the_reference(md):
    rows = _rows()
    assert roofline.table(rows, md=md) == jroofline.table(rows, md=md)
    got, want = (f(rows) for f in (roofline.interesting_cells,
                                   jroofline.interesting_cells))
    assert {k: (r["arch"], r["shape"]) for k, r in got.items()} == \
        {k: (r["arch"], r["shape"]) for k, r in want.items()}
    assert roofline.advice(rows).count("\n") == 3


# --------------------------------------------------------- the dry run

def test_lower_cell_at_smollm_width_on_meta():
    """One cell at SmolLM-360M's published width, on meta: the
    reference's result keys, one card, the census's peak as memory, the
    fused and plain counts, B3's launches and a memory-bound roofline."""
    r = dryrun.lower_cell("smollm_360m", "decode_32k", verbose=False)
    assert r["status"] == "ok" and (r["mesh"], r["n_chips"]) == ("h100x1", 1)
    cfg = configs.get("smollm_360m")
    assert r["n_units"] == cfg.n_units == 32
    assert r["model_flops_6nd"] == dryrun.model_flops(
        cfg, shapes.SHAPES["decode_32k"])["model_flops_6nd"]
    cache = 2 * 32 * 128 * 5 * 32768 * 64 * 2            # K and V, bf16
    params = 4 * cfg.param_count()
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] >= cache + params
    assert mem["total_per_device_bytes"] > mem["argument_size_in_bytes"]
    assert mem["fits"] is False and mem["hbm_bytes"] == mesh.HBM_BYTES
    cost = r["cost"]
    assert cost["kernels"]["decode_attn"]["launches"] == 32
    assert cost["plain_kernels"]["decode_attn"]["calls"] == 32
    assert cost["flops"] == cost["fused"]["flops"]
    assert cost["bytes_accessed"] >= cache           # every cache row read
    rf = r["roofline"]
    assert rf["dominant"] == "memory_s" and rf["collective_s"] == 0.0
    assert rf["memory_s"] == cost["bytes_accessed"] / mesh.HBM_BW
    assert rf["compute_s"] == cost["flops"] / mesh.PEAK_FLOPS_BF16
    assert all(v["count"] == 0 for v in r["collectives"].values())


@pytest.fixture
def smoke_configs(monkeypatch):
    """lower_cell on the smoke configs (the shapes stay the cells')."""
    monkeypatch.setattr(dryrun.configs, "get", configs.get_smoke)


def test_presets(smoke_configs):
    r = dryrun.lower_cell("smollm_360m", "train_4k", preset="bigblocks")
    assert r["status"] == "skipped" and "block_q" in r["reason"]
    r = dryrun.lower_cell("smollm_360m", "long_500k")
    assert r["status"] == "skipped"
    assert r["reason"] == shapes.skip_reason(configs.get_smoke(
        "smollm_360m"), shapes.SHAPES["long_500k"])
    r = dryrun.lower_cell("mixtral_8x7b", "decode_32k", preset="opt_moe2",
                          cost_pass=False)
    assert r["status"] == "ok" and "attn_compute_dtype" in r["ignored"]
    assert r["cost"]["plain"] is None
    f32 = dryrun.lower_cell("smollm_360m", "decode_32k", preset="fp32act",
                            cost_pass=False)
    assert f32["roofline"]["compute_s"] == \
        f32["cost"]["flops"] / mesh.PEAK_FLOPS_F32
    assert set(dryrun.PRESETS) | set(dryrun.SKIPPED_PRESETS) == {
        "baseline", "seqshard", "noremat", "dots", "ep", "bigblocks",
        "fp32act", "bf16attn", "padheads", "chunk128", "chunk64",
        "opt_xlstm", "puredp", "opt", "opt_moe", "moelocal", "opt_moe2"}


def test_cli_sweep_roofline_and_fused_accounting(smoke_configs, tmp_path,
                                                 capsys):
    """``--arch xlstm_1_3b`` (its four cells, long_500k included, the
    sLSTM through the top-up) to JSON, the roofline report of it, the
    CLI's refusals, and fused_accounting's record of a cell."""
    out = str(tmp_path / "dry.json")
    assert dryrun.main(["--arch", "xlstm_1_3b", "--out", out]) == 0
    rows = roofline.load(out)
    assert [r["status"] for r in rows] == ["ok"] * 4
    roofline.main([out, "--md", "--advice"])
    text = capsys.readouterr().out
    assert "| xlstm_1_3b | long_500k | baseline |" in text
    assert "hillclimb picks:" in text
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "xlstm_1_3b", flag])
    assert "one card" in capsys.readouterr().err
    train = next(r for r in rows if r["shape"] == "train_4k")
    rec = fused_accounting.record("xlstm_1_3b", "train_4k", train)
    assert rec["attn_blocks"] == 0
    assert rec["attn_bytes_measured_per_block"] == 0.0
    assert rec["cell_bytes_baseline"] == train["cost"]["plain"]["bytes"]
    assert rec["memory_s_kernel_fused"] == \
        train["cost"]["fused"]["bytes"] / mesh.HBM_BW
    assert train["cost"]["kernels"]["mlstm_scan"]["launches"] == \
        2 * 3 * 1                 # 3 mLSTM blocks, forward and remat


def test_fused_accounting_cells_and_attention_record(smoke_configs):
    assert fused_accounting.CELLS[0] == ("smollm_360m", "train_4k")
    assert len(fused_accounting.CELLS) == 6
    row = dryrun.lower_cell("granite_3_2b", "prefill_32k", verbose=False)
    rec = fused_accounting.record("granite_3_2b", "prefill_32k", row)
    cfg = configs.get_smoke("granite_3_2b")
    assert rec["attn_blocks"] == cfg.n_layers
    assert rec["attn_bytes_fused_per_block"] == \
        row["cost"]["kernels"]["flash_attn_fwd"]["bytes"] / cfg.n_layers
    assert rec["attn_bytes_measured_per_block"] > \
        rec["attn_bytes_fused_per_block"]


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.HBM_BYTES) == (989e12, 67e12, 3.35e12, 80e9)
    assert H100_SPEC.power_max_w == 700 and H100_SPEC.n_cores == 1
    assert H100_SPEC.f_max_hz == 1.98e9
    assert H100_SPEC.peak_flops == pytest.approx(989e12, rel=1e-12)
    assert PAPER_DEVICE.name == "paper-device"
