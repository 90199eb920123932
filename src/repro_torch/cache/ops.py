"""The plane-cache operations (PyTorch port of ``repro/cache/ops.py``).

Every mutation updates the cache tensors in place; the functions return
the cache so call sites read like the reference.  Slots chosen on the
device (the LRU victim, the approximate oracle's argmax) stay 1-element
index tensors: indexing with a 0-d CUDA tensor would call ``.item()`` and
block the host inside a pass.  Block indices are Python ints from a host
permutation, or (1,) index tensors on the device in the captured block
steps of :mod:`repro_torch.core.graphs`.

Scoring goes through :func:`repro_torch.kernels.ops.plane_scores` (one
block) and :func:`repro_torch.kernels.ops.plane_select` (many blocks at
one ``w``).  Invalid slots score :data:`NEG_INF` so they never win an
argmax.  The Gram rows of a ``CacheLayout(gram=True)`` cache are inner
products of one block's rows with one vector, :func:`row_dots`: the same
per-row reduction as the scores, so equal rows get bit-equal entries.
The gap vector of a ``CacheLayout(track_gap=True)`` cache starts at
:data:`GAP_UNSEEN`; :func:`update_gap` folds in a block's estimate and
:func:`evict_gap_stale` is the gap-aware TTL rule.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.types import index_tensor, row_of, set_row
from ..kernels import ops as kops
from .state import CacheLayout, PlaneCache

NEG_INF = kops.INVALID_SCORE

# Gap of a block no oracle call has visited: above every real gap (so a
# gap-proportional sampler schedules unseen blocks first) and finite in
# float32; the score sentinel's magnitude, not a second constant.
GAP_UNSEEN = -kops.INVALID_SCORE

# The int32 key of an empty slot in the LRU choice: below every activity
# stamp, so empty slots are taken first.
_EMPTY_KEY = -2 ** 31 + 1


def init(layout: Union[CacheLayout, int], n: int, d: int,
         device) -> PlaneCache:
    """Empty cache for ``n`` blocks of ``(d+1)``-planes on ``device``."""
    if not isinstance(layout, CacheLayout):
        layout = CacheLayout(cap=int(layout))
    if layout.dtype != torch.float32:
        raise NotImplementedError("the port's plane cache is float32 only")
    cap = layout.cap
    return PlaneCache(
        planes=torch.zeros((n, cap, d + 1), dtype=torch.float32,
                           device=device),
        valid=torch.zeros((n, cap), dtype=torch.bool, device=device),
        last_active=torch.full((n, cap), -1, dtype=torch.int32,
                               device=device),
        gram=(torch.zeros((n, cap, cap), dtype=torch.float32, device=device)
              if layout.gram else None),
        gap=(torch.full((n,), GAP_UNSEEN, dtype=torch.float32, device=device)
             if layout.track_gap else None))


def row_dots(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``<rows[r], v>`` for ``(k, d)`` rows (any row stride) and a ``(d,)``
    unit-stride ``v``: one ``plane_scores`` launch with zero offsets, each
    row reduced alike (a ``@`` matvec can round equal rows apart)."""
    zero = torch.zeros((1,), dtype=rows.dtype, device=rows.device)
    return kops.plane_scores(rows, v, zero.expand(rows.shape[0]))


def _lru_slot(cache: PlaneCache, i) -> torch.Tensor:
    """First empty slot if any, else the valid slot inactive the longest
    (paper Alg. 3 step 3); ties break to the lowest slot.  (1,) int64."""
    last = row_of(cache.last_active, i)
    key = torch.where(row_of(cache.valid, i), last,
                      torch.full_like(last, _EMPTY_KEY))
    return key.argmin().reshape(1)


def _stamp(cache: PlaneCache, flat: torch.Tensor, it) -> None:
    """Activity stamp ``it`` (a host int, or a (1,) int32 device tensor)
    on the slots at ``flat`` ((k,) indices into the flattened cache)."""
    last = cache.last_active.view(-1)
    if isinstance(it, torch.Tensor):
        last.index_copy_(0, flat, it.reshape(1).expand(flat.shape[0]))
    else:
        last.index_fill_(0, flat, it)


def insert(cache: PlaneCache, i, plane: torch.Tensor, it) -> PlaneCache:
    """Insert ``plane`` into block ``i``, evicting LRU if full; the slot is
    marked active at outer iteration ``it``.

    ``i`` is a host int or a (1,) int64 tensor on the cache's device, ``it``
    a host int or a (1,) int32 tensor there: a captured block step reads
    both on the device.  With Gram blocks, the slot's row and column are
    refreshed with the inner products of the new plane and all ``cap``
    slots of the block, stale ones included (``repro/cache/ops.py::insert``).
    """
    n, cap, d1 = cache.planes.shape
    slot = _lru_slot(cache, i)
    flat = slot + i * cap                                  # (1,) int64
    cache.planes.view(n * cap, d1).index_copy_(0, flat, plane.reshape(1, -1))
    cache.valid.view(-1).index_fill_(0, flat, True)
    _stamp(cache, flat, it)
    if cache.gram is not None:
        row = row_dots(row_of(cache.planes, i)[:, :-1],
                       plane[:-1].contiguous())
        cache.gram.view(n * cap, cap).index_copy_(0, flat, row[None, :])
        col = flat * cap - slot * (cap - 1) + torch.arange(
            0, cap * cap, cap, device=slot.device)
        cache.gram.view(-1).index_copy_(0, col, row)
    return cache


def mark_active(cache: PlaneCache, i, slot: torch.Tensor, it) -> PlaneCache:
    """Record that block ``i``'s ``slot`` ((1,) int64 or int32 index) was
    returned by an oracle call at outer iteration ``it`` (``i`` and ``it``
    as in :func:`insert`)."""
    _stamp(cache, slot.reshape(1).long() + i * cache.valid.shape[1], it)
    return cache


def mark_active_where(cache: PlaneCache, i: int, won: torch.Tensor,
                      it: int) -> PlaneCache:
    """Stamp ``it`` on every slot of block ``i`` where the ``(cap,)`` bool
    ``won`` holds (the multi-step pass's per-slot win flags)."""
    cache.last_active[i].masked_fill_(won, it)
    return cache


def evict_stale(cache: PlaneCache, it: int, ttl: int) -> PlaneCache:
    """Drop planes not active during the last ``ttl`` outer iterations."""
    cache.valid.logical_and_(it - cache.last_active <= ttl)
    return cache


def update_gap(cache: PlaneCache, i, gap: torch.Tensor) -> PlaneCache:
    """Fold a fresh gap estimate (a () or (1,) float32 tensor) for block
    ``i`` (a host int or a (1,) int64 device index) into the gap vector,
    clamped at 0: an approximate oracle scoring below the iterate, or
    float noise at an exact optimum, gives a negative estimate.  A no-op
    when the layout does not track gaps."""
    if cache.gap is not None:
        set_row(cache.gap, i, torch.clamp_min(gap.reshape(()), 0.0))
    return cache


def evict_gap_stale(cache: PlaneCache, it: int, ttl: int, ttl_cold: int,
                    gap_cold: float) -> PlaneCache:
    """Gap-aware TTL: a block whose gap estimate is at most ``gap_cold``
    keeps its planes ``ttl_cold`` outer iterations, the others ``ttl``
    (unseen blocks hold :data:`GAP_UNSEEN`, so they get ``ttl``).
    Elementwise over the blocks."""
    ttl_eff = torch.where(cache.gap > gap_cold, ttl, ttl_cold)
    cache.valid.logical_and_(it - cache.last_active <= ttl_eff[:, None])
    return cache


def gather(cache: PlaneCache, ids) -> PlaneCache:
    """Sub-cache of the rows in ``ids``: a copy of shape ``(len(ids), cap,
    ...)``, so later updates of either cache do not reach the other.  The
    batched fallback does not call this: :func:`approx_oracle_all` takes
    ``rows`` and reads the selected rows in place."""
    idx = index_tensor(ids, cache.planes.device)
    return PlaneCache(planes=cache.planes[idx], valid=cache.valid[idx],
                      last_active=cache.last_active[idx],
                      gram=None if cache.gram is None else cache.gram[idx],
                      gap=None if cache.gap is None else cache.gap[idx])


def flat_view(cache: PlaneCache
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(P (n*cap, d), b (n*cap,), valid (n*cap,))``: views of the whole
    cache in the ``plane_scores`` kernel's operand layout."""
    n, cap, d1 = cache.planes.shape
    flat = cache.planes.reshape(n * cap, d1)
    return flat[:, :-1], flat[:, -1], cache.valid.reshape(n * cap)


def sizes(cache: PlaneCache) -> torch.Tensor:
    """Per-block working-set sizes (paper Fig. 5 telemetry)."""
    return cache.valid.sum(dim=1)


def score_all(cache: PlaneCache, w: torch.Tensor) -> torch.Tensor:
    """Masked scores of every cached plane at one ``w``: ``(n, cap)``,
    invalid slots :data:`NEG_INF`.  One ``plane_scores`` launch over
    :func:`flat_view`; for telemetry, the hot path selects through
    :func:`approx_oracle_all`."""
    p, b, valid = flat_view(cache)
    scores = kops.plane_scores(p, w, b)
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF)
                       ).reshape(cache.valid.shape)


def approx_oracle_all(cache: PlaneCache, w: torch.Tensor,
                      rows: Optional[torch.Tensor] = None):
    """Batched approximate oracle: the best cached plane of each block in
    ``rows`` (int64 tensor, default every block) at one shared ``w``.

    One ``plane_select`` launch, which reads the selected rows in place.
    Returns ``(planes (k, d+1), slots (k,) int32, scores (k,))``; a block
    with an empty set gets the zero plane, slot 0 and score 0 (the
    ground-truth plane).
    """
    best, slots = kops.plane_select(cache.planes[:, :, :-1], w,
                                    cache.planes[:, :, -1], cache.valid,
                                    rows=rows)
    if rows is None:
        rows = torch.arange(cache.valid.shape[0], device=cache.valid.device)
    empty = ~cache.valid[rows].any(dim=1)
    planes = cache.planes[rows, slots.long()]
    planes.masked_fill_(empty[:, None], 0.0)
    return planes, slots, best.masked_fill_(empty, 0.0)


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
