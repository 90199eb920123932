"""Two-track weighted averaging of dual iterates (paper Sec. 3.6).

bar_phi^(k+1) = k/(k+2) bar_phi^(k) + 2/(k+2) phi^(k+1), kept twice: one
track after every exact oracle call, one after every approximate call.
Extraction returns the interpolation of the two with the best dual F.

A pass steps a track in place with :func:`average_step`, its weights
read from a :func:`weight_table` on the state's device (the host knows
``k``; a captured block step reads its row by index).
"""
from __future__ import annotations

import numpy as np
import torch

from .types import AveragingState


def init_averaging(d: int, device) -> AveragingState:
    z = torch.zeros((d + 1,), dtype=torch.float32, device=device)
    return AveragingState(bar_exact=z, bar_approx=z.clone(), k_exact=0,
                          k_approx=0)


def update_average(avg: AveragingState, phi: torch.Tensor, *,
                   exact: bool) -> AveragingState:
    """Incremental weighted-average update after one oracle call, as a new
    state (the reference's functional form; the passes step a track in
    place with :func:`average_step`).  Both weights are float32, computed
    from a float32 ``k`` as the reference computes them."""
    k = avg.k_exact if exact else avg.k_approx
    a, b = (float(x) for x in weight_table(k, 1)[0])  # exact in float32
    if exact:
        return avg._replace(bar_exact=a * avg.bar_exact + b * phi,
                            k_exact=k + 1)
    return avg._replace(bar_approx=a * avg.bar_approx + b * phi,
                        k_approx=k + 1)


def weight_table(k0: int, m: int, stride: int = 1) -> np.ndarray:
    """``(m, 2)`` float32: ``(k/(k+2), 2/(k+2))`` for ``k = k0 + stride
    t``, ``t = 0 .. m-1`` (the shard engine's ranks step by the rank
    count).

    The reference computes both from a float32 ``k``, in float32; the same
    roundings here give bit-equal weights."""
    kf = (k0 + stride * np.arange(m, dtype=np.int64)).astype(np.float32)
    two = np.float32(2.0)
    return np.stack([kf / (kf + two), two / (kf + two)], axis=1)


def average_step(bar: torch.Tensor, phi: torch.Tensor, ab: torch.Tensor,
                 scratch: torch.Tensor) -> None:
    """One averaging step after an oracle call: ``bar <- a bar + b phi`` in
    place, ``ab = (a, b)`` a (2,) float32 tensor (a row of
    :func:`weight_table`, on the state's device).  Each product is
    rounded, then the sum, as the reference's expression says: ``b phi``
    goes to ``scratch``, then ``bar`` is scaled and the scratch added (a
    fused ``add_(alpha=)`` could round once)."""
    torch.mul(phi, ab[1], out=scratch)
    bar.mul_(ab[0]).add_(scratch)


def extract(avg: AveragingState, lam: float) -> torch.Tensor:
    """Best-F interpolation between the exact and approximate averages.

    maximize_beta F((1-beta) bar_exact + beta bar_approx), beta in [0,1];
    a track with no updates yet yields to the other.
    """
    a, b = avg.bar_exact, avg.bar_approx
    diff = b - a
    num = -torch.dot(a[:-1], diff[:-1]) + lam * diff[-1]
    den = torch.dot(diff[:-1], diff[:-1])
    beta = torch.clamp(torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                                   torch.zeros_like(num)), 0.0, 1.0)
    if avg.k_approx == 0:
        beta = torch.zeros_like(beta)
    if avg.k_exact == 0:
        beta = torch.ones_like(beta)
    return (1.0 - beta) * a + beta * b
