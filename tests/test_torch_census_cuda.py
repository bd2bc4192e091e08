"""Phase 15's check at smoke size on a card: one step of a smoke config
counted under the census on CUDA tensors equals the dry run on meta
(FLOPs, bytes, op counts, each kernel's launches), the kernels really
launched (their wrappers' counters moved by as much), and the census's
peak is within 10% of the step's ``max_memory_allocated`` rise. Imports
neither JAX nor the JAX package: ``PYTHONPATH=src python -m pytest -q -m
requires_cuda tests/test_torch_census_cuda.py``. Every test skips
without a card."""
import gc

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import (decode_attn, flash_attn, mamba_scan,
                                 mlstm_scan, split_quant)
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.train.step import TrainConfig
from repro_torch.utils.census import Census

B, S = 2, 64
WRAPPERS = {"flash_attn_fwd": flash_attn.flash_attention_fwd,
            "decode_attn": decode_attn.decode_attention,
            "mamba_scan": mamba_scan.mamba_chunk_scan,
            "mlstm_scan": mlstm_scan.mlstm_chunk_scan,
            "split_quant": split_quant.quantize_dequantize}


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided inside
    the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(cfg, kind, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    tok = lambda s: torch.randint(0, cfg.vocab, s, generator=g, device=dev,
                                  dtype=torch.int32)
    if kind == "decode":
        return {"tokens": tok((B, 1)),
                "positions": torch.full((B,), S - 1, dtype=torch.int32,
                                        device=dev)}
    batch = {"tokens": tok((B, S))}
    if kind == "train":
        batch["labels"] = tok((B, S))
    return batch


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_1_2b",
                                  "xlstm_1_3b"])
def test_census_on_the_card_equals_the_dry_run(arch, kind):
    dev = require_cuda()
    cfg = configs.get_smoke(arch)
    shape = ShapeSpec(kind, S, B, kind)
    tcfg = TrainConfig()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    run, args = dryrun.make_step(cfg, shape, tcfg, params=params,
                                 batch=_batch(cfg, kind, dev), device=dev)
    run(*args)                                   # builds the kernels
    for fn in WRAPPERS.values():
        fn.launches = 0
    card = Census(device="cuda")
    card.track(args)
    gc.collect()             # garbage of earlier steps would be freed inside
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with card:
        run(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    card = card.result()
    meta = dryrun.count_step(cfg, shape, tcfg).result()
    assert card["ops"] == meta["ops"]
    assert (card["flops"], card["bytes"]) == (meta["flops"], meta["bytes"])
    launches = {n: k["launches"] for n, k in card["kernels"].items()}
    assert launches == {n: k["launches"] for n, k in meta["kernels"].items()}
    assert launches == {n: fn.launches for n, fn in WRAPPERS.items()}
    assert sum(launches.values()) > 0 or (arch, kind) == ("xlstm_1_3b",
                                                          "decode")
    new = card["peak_bytes"] - card["base_bytes"]
    assert abs(new - rise) <= 0.10 * rise, (new, rise)
