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
            "repro_torch.launch.device_sim"} <= set(mods)
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
    from repro_torch import configs
    from repro_torch.launch import constellation, device_sim, serve
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


def test_chip_smoke_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
