"""repro_torch.cache: the device-resident plane cache (PyTorch port)."""
from .layout import block_slice, partition_specs  # noqa: F401
from .ops import (GAP_UNSEEN, NEG_INF, approx_oracle,  # noqa: F401
                  approx_oracle_all, evict_gap_stale, evict_stale,
                  flat_view, gather, init, insert, mark_active,
                  mark_active_where, row_dots, score_all, sizes, update_gap)
from .state import CacheLayout, PlaneCache  # noqa: F401

__all__ = ["PlaneCache", "CacheLayout", "NEG_INF", "GAP_UNSEEN", "init",
           "insert", "mark_active", "mark_active_where", "row_dots",
           "evict_stale", "evict_gap_stale", "update_gap",
           "sizes", "approx_oracle", "approx_oracle_all", "gather",
           "flat_view", "score_all", "partition_specs", "block_slice"]
