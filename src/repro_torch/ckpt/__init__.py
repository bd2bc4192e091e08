"""Checkpointing: atomic tree save/restore with integrity hashes."""
from repro_torch.ckpt.checkpoint import (latest_step, restore, save,
                                         save_handoff, restore_handoff)
