"""Value types of the device-resident plane cache (PyTorch port).

:class:`PlaneCache` owns the paper's cached working sets (Sec. 3.3-3.5):
the dense ``(n, cap, d+1)`` plane ring, the ``valid`` occupancy mask, the
``last_active`` activity clock behind LRU eviction and the TTL rule, and,
when the Sec-3.5 scheme is on, the per-block Gram matrices, refreshed on
insertion.  When the layout tracks per-block duality gaps
(``track_gap=True``) the cache also carries the ``(n,)`` gap vector that
the gap policies read (:mod:`repro_torch.policy`).  :class:`CacheLayout`
is its configuration.  The operations in :mod:`repro_torch.cache.ops`
update the tensors in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch


class PlaneCache(NamedTuple):
    """Per-block working sets of cached oracle planes.

    Attributes:
      planes:      (n, cap, d+1) float32 stored planes (linear part + offset).
      valid:       (n, cap) bool slot occupancy.
      last_active: (n, cap) int32 outer iteration at which the slot's plane
                   was last returned by an oracle call (-1: never).
      gram:        (n, cap, cap) float32 per-block Gram matrices
                   ``G[i, a, b] = <phi_a*, phi_b*>`` (paper Sec. 3.5), or
                   None when the layout does not keep them.  A slot's row
                   and column are refreshed when a plane lands in it.
      gap:         (n,) float32 per-block duality-gap estimates (Osokin
                   et al., arXiv:1605.09346), or None when the layout does
                   not track them.  The exact step writes the true block
                   gap, an approximate pass the cache's underestimate;
                   blocks never visited hold
                   :data:`repro_torch.cache.GAP_UNSEEN`.
    """

    planes: torch.Tensor
    valid: torch.Tensor
    last_active: torch.Tensor
    gram: Optional[torch.Tensor] = None
    gap: Optional[torch.Tensor] = None

    @property
    def occupancy(self) -> torch.Tensor:
        """() int32 total valid cached planes (a device value)."""
        return self.valid.sum().to(torch.int32)

    @property
    def nonempty_blocks(self) -> torch.Tensor:
        """() int32 blocks holding at least one valid plane."""
        return self.valid.any(dim=1).sum().to(torch.int32)


@dataclass(frozen=True)
class CacheLayout:
    """Plane-cache configuration.

    ``gram`` keeps the Sec-3.5 Gram blocks in the cache; ``axis`` names
    the mesh axis the block dimension is partitioned over (None: one
    device), read by :func:`repro_torch.cache.partition_specs` and the
    shard layout; ``track_gap`` keeps the ``(n,)`` per-block gap vector of
    the gap policies.  The reference's ``fold_scatter`` has no field: the
    port folds in place, so its two strategies are one program.
    """

    cap: int = 64
    dtype: Any = torch.float32
    gram: bool = False
    axis: Optional[str] = None
    track_gap: bool = False
