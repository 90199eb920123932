"""Value types of the device-resident plane cache (PyTorch port).

:class:`PlaneCache` owns the paper's cached working sets (Sec. 3.3-3.4):
the dense ``(n, cap, d+1)`` plane ring, the ``valid`` occupancy mask and
the ``last_active`` activity clock behind LRU eviction and the TTL rule.
:class:`CacheLayout` is its configuration.  The operations in
:mod:`repro_torch.cache.ops` update the tensors in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


class PlaneCache(NamedTuple):
    """Per-block working sets of cached oracle planes.

    Attributes:
      planes:      (n, cap, d+1) float32 stored planes (linear part + offset).
      valid:       (n, cap) bool slot occupancy.
      last_active: (n, cap) int32 outer iteration at which the slot's plane
                   was last returned by an oracle call (-1: never).
    """

    planes: torch.Tensor
    valid: torch.Tensor
    last_active: torch.Tensor

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

    ``gram`` (the Sec-3.5 Gram blocks) and ``track_gap`` (the per-block gap
    vector of the gap policies) are not ported yet; :func:`repro_torch
    .cache.ops.init` raises for them.
    """

    cap: int = 64
    dtype: Any = torch.float32
    gram: bool = False
    track_gap: bool = False
