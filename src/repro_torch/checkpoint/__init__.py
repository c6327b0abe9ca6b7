"""Checkpointing: async, atomic by rename, exact dtypes (port of
`repro/checkpoint`, on one device)."""
from repro_torch.checkpoint.store import (
    AsyncCheckpointer, latest_step, load_manifest, restore_checkpoint,
    save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_manifest", "AsyncCheckpointer"]
