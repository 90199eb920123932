"""Placement of a :class:`~repro_torch.cache.state.PlaneCache` over the
ranks of a data mesh (PyTorch port of ``repro/cache/layout.py``).

Every cache leaf (planes, validity, activity, the Gram blocks and the gap
vector when the layout keeps them) is partitioned over the layout's mesh
axis along the block dimension; there is no replicated cache state.  A
spec is a tuple of axis names, one per dimension (None: not partitioned),
in the place of the reference's ``PartitionSpec``; each rank holds the
contiguous block range ``[rank * n_local, (rank + 1) * n_local)``.
"""
from __future__ import annotations

from .state import CacheLayout, PlaneCache


def partition_specs(layout: CacheLayout) -> PlaneCache:
    """The spec tree of a cache under ``layout``: a :class:`PlaneCache`
    whose leaves are tuples of axis names, None where the layout has no
    such leaf, so it zips with a cache :func:`repro_torch.cache.init`
    builds from the same layout.  Requires ``layout.axis``."""
    if layout.axis is None:
        raise ValueError(
            "CacheLayout.axis is None: partition_specs needs the mesh "
            "axis the block dimension shards over (e.g. axis='data')")
    a = layout.axis
    return PlaneCache(
        planes=(a, None, None), valid=(a, None), last_active=(a, None),
        gram=(a, None, None) if layout.gram else None,
        gap=(a,) if layout.track_gap else None)


def block_slice(cache: PlaneCache, lo: int, hi: int,
                device=None) -> PlaneCache:
    """The cache of blocks ``[lo, hi)`` on ``device`` (default: the
    cache's): every leaf's rows, copied once to new contiguous tensors (a
    rank's part of a global cache)."""
    return PlaneCache(*(None if t is None else
                        t[lo:hi].to(device or t.device, copy=True)
                        for t in cache))
