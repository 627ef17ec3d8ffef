"""repro_torch.checkpoint — atomic, resumable, optionally entropy-coded
(the port of ``repro.checkpoint``; the reference's layout)."""

from .manager import (
    CheckpointConfig,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointConfig",
    "CheckpointManager",
    "latest_step",
    "load_checkpoint",
    "save_checkpoint",
]
