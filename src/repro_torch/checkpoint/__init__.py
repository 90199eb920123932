"""repro_torch.checkpoint: atomic checkpoints in the reference's format."""
from .manager import (CheckpointManager, flatten,  # noqa: F401
                      restore_resharded)

__all__ = ["CheckpointManager", "flatten", "restore_resharded"]
