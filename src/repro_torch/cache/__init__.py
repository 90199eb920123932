"""repro_torch.cache: the device-resident plane cache (PyTorch port)."""
from .ops import (NEG_INF, approx_oracle, evict_stale, init,  # noqa: F401
                  insert, mark_active, sizes)
from .state import CacheLayout, PlaneCache  # noqa: F401

__all__ = ["PlaneCache", "CacheLayout", "NEG_INF", "init", "insert",
           "mark_active", "evict_stale", "sizes", "approx_oracle"]
