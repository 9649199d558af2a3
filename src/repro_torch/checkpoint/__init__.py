"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    AsyncCheckpointManager, available_steps, prune, restore_checkpoint,
    save_checkpoint)
