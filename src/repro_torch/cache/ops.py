"""The plane-cache operations (PyTorch port of ``repro/cache/ops.py``).

Every mutation updates the cache tensors in place; the functions return
the cache so call sites read like the reference.  Slots chosen on the
device (the LRU victim, the approximate oracle's argmax) stay 1-element
index tensors: indexing with a 0-d CUDA tensor would call ``.item()`` and
block the host inside a pass.  Block indices come from the host
permutation and are Python ints.

Scoring goes through :func:`repro_torch.kernels.ops.plane_scores`.
Invalid slots score :data:`NEG_INF` so they never win an argmax.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ..kernels import ops as kops
from .state import CacheLayout, PlaneCache

NEG_INF = kops.INVALID_SCORE

# The int32 key of an empty slot in the LRU choice: below every activity
# stamp, so empty slots are taken first.
_EMPTY_KEY = -2 ** 31 + 1


def init(layout: Union[CacheLayout, int], n: int, d: int,
         device) -> PlaneCache:
    """Empty cache for ``n`` blocks of ``(d+1)``-planes on ``device``."""
    if not isinstance(layout, CacheLayout):
        layout = CacheLayout(cap=int(layout))
    if layout.gram:
        raise NotImplementedError(
            "CacheLayout(gram=True): the Sec-3.5 Gram scheme is not ported "
            "yet (ROADMAP A5)")
    if layout.track_gap:
        raise NotImplementedError(
            "CacheLayout(track_gap=True): per-block gap tracking is not "
            "ported yet (ROADMAP A6)")
    if layout.dtype != torch.float32:
        raise NotImplementedError("the port's plane cache is float32 only")
    cap = layout.cap
    return PlaneCache(
        planes=torch.zeros((n, cap, d + 1), dtype=torch.float32,
                           device=device),
        valid=torch.zeros((n, cap), dtype=torch.bool, device=device),
        last_active=torch.full((n, cap), -1, dtype=torch.int32,
                               device=device))


def _lru_slot(cache: PlaneCache, i: int) -> torch.Tensor:
    """First empty slot if any, else the valid slot inactive the longest
    (paper Alg. 3 step 3); ties break to the lowest slot.  (1,) int64."""
    key = torch.where(cache.valid[i], cache.last_active[i],
                      torch.full_like(cache.last_active[i], _EMPTY_KEY))
    return key.argmin().reshape(1)


def insert(cache: PlaneCache, i: int, plane: torch.Tensor,
           it: int) -> PlaneCache:
    """Insert ``plane`` into block ``i``, evicting LRU if full; the slot is
    marked active at outer iteration ``it``."""
    slot = _lru_slot(cache, i)
    cache.planes[i].index_copy_(0, slot, plane.reshape(1, -1))
    cache.valid[i].index_fill_(0, slot, True)
    cache.last_active[i].index_fill_(0, slot, it)
    return cache


def mark_active(cache: PlaneCache, i: int, slot: torch.Tensor,
                it: int) -> PlaneCache:
    """Record that block ``i``'s ``slot`` ((1,) index) was returned by an
    oracle call at outer iteration ``it``."""
    cache.last_active[i].index_fill_(0, slot.reshape(1), it)
    return cache


def evict_stale(cache: PlaneCache, it: int, ttl: int) -> PlaneCache:
    """Drop planes not active during the last ``ttl`` outer iterations."""
    cache.valid.logical_and_(it - cache.last_active <= ttl)
    return cache


def sizes(cache: PlaneCache) -> torch.Tensor:
    """Per-block working-set sizes (paper Fig. 5 telemetry)."""
    return cache.valid.sum(dim=1)


def approx_oracle(cache: PlaneCache, i: int, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """argmax over block ``i``'s cached planes of ``<phi, [w 1]>``.

    Returns ``(plane (d+1,), slot (1,), score ())``; callers mark ``slot``
    active.  An empty set returns the zero plane with score 0 (the
    ground-truth plane).

    Every shape goes through the ``plane_scores`` kernel (the reference
    keeps blocks below one (8, 128) TPU tile in XLA): one scoring function
    that rounds equal rows equally, so duplicate planes tie and the first
    one wins, as in the reference.
    """
    planes_i = cache.planes[i]                   # (cap, d+1)
    scores = kops.plane_scores(planes_i[:, :-1], w, planes_i[:, -1])
    scores = torch.where(cache.valid[i], scores,
                         torch.full_like(scores, NEG_INF))
    slot = scores.argmax().reshape(1)
    best = scores.index_select(0, slot)[0]
    any_valid = cache.valid[i].any()
    plane = torch.where(any_valid, planes_i.index_select(0, slot)[0],
                        torch.zeros_like(planes_i[0]))
    return plane, slot, torch.where(any_valid, best, torch.zeros_like(best))
