"""repro_torch.optim: AdamW, the LR schedule and gradient compression
(PyTorch port of ``repro.optim``)."""
from .adamw import (AdamWConfig, AdamWState, adamw_init,  # noqa: F401
                    adamw_update)
from .compression import compress_grads, decompress_grads  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "compress_grads", "decompress_grads", "cosine_schedule"]
