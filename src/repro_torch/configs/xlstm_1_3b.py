"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

48 blocks at d_model=2048, 4 heads. The 1.3B xLSTM[7:1] recipe interleaves
one sLSTM block per seven mLSTM blocks; d_ff=0 (the projected mLSTM block
carries its own 2x up/down projection instead of a separate FFN).
Linear recurrence => sub-quadratic, eligible for long_500k.
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_state=0,
    pattern=("mlstm",) * 7 + ("slstm",),
    sub_quadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", n_layers=4, d_model=64, n_heads=2,
        n_kv_heads=2, vocab=128, pattern=("mlstm", "mlstm", "mlstm", "slstm"))
