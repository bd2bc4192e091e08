"""The port stands alone: every ``repro_torch`` module and the imports of
``chip_smoke.py`` load with JAX, the JAX package and msgpack blocked (the
machine with the card has neither), no source imports them, and no entry
point runs on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_helpers import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_modules_and_chip_smoke_import_without_jax():
    mods = _modules()
    assert {"repro_torch.kernels.flash_attn", "repro_torch.kernels.split_quant",
            "repro_torch.kernels.mamba_scan", "repro_torch.configs.zamba2_1_2b",
            "repro_torch.kernels.mlstm_scan", "repro_torch.configs.xlstm_1_3b",
            "repro_torch.core.constellation", "repro_torch.ckpt.checkpoint",
            "repro_torch.launch.constellation", "repro_torch.sim",
            "repro_torch.sim.device_sim", "repro_torch.sim.data",
            "repro_torch.sim.energy_state", "repro_torch.obs",
            "repro_torch.obs.ring", "repro_torch.obs.metrics",
            "repro_torch.core.resource_opt_torch",
            "repro_torch.serve_fleet.engine", "repro_torch.utils.bucketing",
            "repro_torch.launch.device_sim", "repro_torch.fleet",
            "repro_torch.fleet.engine", "repro_torch.fleet.events",
            "repro_torch.fleet.scenarios",
            "repro_torch.fleet.__main__", "repro_torch.isl",
            "repro_torch.isl.link", "repro_torch.isl.codec",
            "repro_torch.isl.exchange", "repro_torch.isl.__main__",
            "repro_torch.obs.timeline",
            "repro_torch.train.compression",
            "repro_torch.serve_fleet", "repro_torch.serve_fleet.router",
            "repro_torch.serve_fleet.traffic",
            "repro_torch.serve_fleet.__main__", "repro_torch.obs.__main__",
            "repro_torch.launch.paper_tables",
            "repro_torch.configs.granite_3_2b",
            "repro_torch.configs.llama3_8b",
            "repro_torch.configs.internlm2_20b",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.phi35_moe",
            "repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.whisper_small",
            "repro_torch.train.step", "repro_torch.launch.train",
            "repro_torch.launch.lm_split_train",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.fused_accounting",
            "repro_torch.launch.mesh", "repro_torch.configs.shapes",
            "repro_torch.utils.census"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['msgpack'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "assert not any(k in ('jax', 'msgpack')\n"
            "               or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_repro(path):
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|msgpack\b|repro(?!_torch)\b)",
                     re.M)
    assert not bad.search((ROOT / path).read_text()), path


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    # the entry points below are loops of tiny ops: with one intra-op
    # thread they do not contend with the other test workers' threads
    with one_torch_thread():
        _entry_points_refuse_cpu_unless_asked(monkeypatch)


def _entry_points_refuse_cpu_unless_asked(monkeypatch):
    from repro_torch import configs
    from repro_torch.fleet import __main__ as fleet_main
    from repro_torch.isl import __main__ as isl_main
    from repro_torch.launch import (constellation, device_sim,
                                    lm_split_train, paper_tables, serve,
                                    train)
    from repro_torch.obs import __main__ as obs_main
    from repro_torch.serve_fleet import __main__ as serve_fleet_main
    from repro_torch.sim import device_sim as sim_device_sim
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine
    from repro_torch.serve_fleet.engine import SplitDecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("smollm_360m")
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        SplitDecodeEngine(cfg, params, cut_units=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "1", "--new-tokens", "1"])
    out = serve.main(["--requests", "1", "--new-tokens", "2", "--cut", "1",
                      "--device", "cpu"])
    assert list(out) == [0] and len(out[0]) == 2
    with pytest.raises(RuntimeError, match="cuda"):
        constellation.main(["--img", "32", "--passes", "1"])
    summary = constellation.main(["--img", "32", "--passes", "2",
                                  "--device", "cpu"])
    assert summary["passes"] == 2 and summary["trained"] >= 1
    with pytest.raises(RuntimeError, match="cuda"):
        constellation.main(["--img", "32", "--engine", "device"])
    summary = constellation.main(["--img", "32", "--passes", "25",
                                  "--engine", "device", "--device", "cpu"])
    assert summary["passes"] == 25 and summary["trained"] == 25
    with pytest.raises(RuntimeError, match="cuda"):
        device_sim.main(["--small"])
    # the ISL smoke, the degraded-ops smoke and the device-sim smoke (each
    # run with --device cpu in tests/test_torch_isl.py)
    with pytest.raises(RuntimeError, match="cuda"):
        isl_main.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        fleet_main.main(["--scenario", "degraded"])
    with pytest.raises(RuntimeError, match="cuda"):
        sim_device_sim._smoke(["--smoke"])
    # the serving-fleet smoke, the recorder smoke and its render, and the
    # paper's tables (each run with --device cpu in its own test file)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_fleet_main.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        obs_main.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        obs_main.main(["render", "--out", "unused.json"])
    with pytest.raises(RuntimeError, match="cuda"):
        paper_tables.main([])
    # LM training: the train CLI and the split-training example (each
    # run with --device cpu in tests/test_torch_train_step.py and below)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        lm_split_train.main(["--steps", "1"])
    losses = lm_split_train.main(["--steps", "3", "--device", "cpu"])
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_chip_smoke_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
