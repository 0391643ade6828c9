"""Atomic, verified checkpoints: the counterpart of ``repro.checkpoint``."""
from repro_torch.checkpoint.manager import (CheckpointError,  # noqa: F401
                                            CheckpointManager)
