"""Eviction policies: which cached planes survive an iteration start
(PyTorch port of ``repro/policy/eviction.py``).

:class:`TTLEviction` is the paper's TTL rule (Sec. 3.4, parameter N/T),
exactly the pre-policy behaviour.  :class:`GapTTL` shortens the TTL for
blocks whose gap estimate has collapsed: a converged block's planes
cannot move the iterate, so holding them for the full TTL only wastes
capacity and per-pass scoring work.  Both are elementwise over the block
axis and update the cache's validity in place.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import cache as plane_cache
from .base import register_policy


@dataclass(frozen=True)
class TTLEviction:
    """Drop planes not active during the last ``ttl`` outer iterations
    (paper Sec. 3.4); LRU overwrite on insertion handles the cap."""

    ttl: int
    name: str = "ttl-lru"
    needs_gap: bool = False

    def evict(self, cache, it: int):
        return plane_cache.evict_stale(cache, it, self.ttl)


@dataclass(frozen=True)
class GapTTL:
    """TTL eviction with a shorter ``ttl_cold`` for blocks whose gap
    estimate is at or below ``gap_cold`` (converged blocks)."""

    ttl: int
    ttl_cold: int
    gap_cold: float = 0.0
    name: str = "gap-ttl"
    needs_gap: bool = True

    def evict(self, cache, it: int):
        return plane_cache.evict_gap_stale(cache, it, self.ttl,
                                           self.ttl_cold, self.gap_cold)


def _require_ttl(cfg) -> int:
    ttl = int(cfg.ttl)
    if ttl < 1:
        from ..api.errors import UnsupportedConfigError
        raise UnsupportedConfigError(
            f"ttl={cfg.ttl!r} out of range: eviction policies need "
            "ttl >= 1 (planes must survive at least the iteration that "
            "inserted them)")
    return ttl


def _ttl_factory(cfg, n: int) -> TTLEviction:
    del n
    return TTLEviction(ttl=_require_ttl(cfg))


def _gap_ttl_factory(cfg, n: int) -> GapTTL:
    del n
    ttl = _require_ttl(cfg)
    return GapTTL(ttl=ttl, ttl_cold=max(1, ttl // 2))


register_policy("ttl-lru", "eviction", _ttl_factory)
register_policy("gap-ttl", "eviction", _gap_ttl_factory)
