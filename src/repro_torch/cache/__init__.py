"""repro_torch.cache: the device-resident plane cache (PyTorch port)."""
from .ops import (NEG_INF, approx_oracle, approx_oracle_all,  # noqa: F401
                  evict_stale, flat_view, gather, init,
                  insert, mark_active, mark_active_where, row_dots,
                  score_all, sizes)
from .state import CacheLayout, PlaneCache  # noqa: F401

__all__ = ["PlaneCache", "CacheLayout", "NEG_INF", "init", "insert",
           "mark_active", "mark_active_where", "row_dots", "evict_stale",
           "sizes", "approx_oracle", "approx_oracle_all", "gather",
           "flat_view", "score_all"]
