"""Two-track weighted averaging of dual iterates (paper Sec. 3.6).

bar_phi^(k+1) = k/(k+2) bar_phi^(k) + 2/(k+2) phi^(k+1), kept twice: one
track after every exact oracle call, one after every approximate call.
Extraction returns the interpolation of the two with the best dual F.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import AveragingState


def init_averaging(d: int, device) -> AveragingState:
    z = torch.zeros((d + 1,), dtype=torch.float32, device=device)
    return AveragingState(bar_exact=z, bar_approx=z.clone(), k_exact=0,
                          k_approx=0)


def _weights(k: int):
    # The reference computes k/(k+2) and 2/(k+2) from a float32 k, in
    # float32; the same two roundings here give bit-equal weights.
    kf = np.float32(k)
    return float(kf / (kf + np.float32(2.0))), float(np.float32(2.0)
                                                     / (kf + np.float32(2.0)))


def update_average(avg: AveragingState, phi: torch.Tensor,
                   *, exact: bool) -> AveragingState:
    """Incremental weighted-average update after one oracle call."""
    if exact:
        a, b = _weights(avg.k_exact)
        return avg._replace(bar_exact=a * avg.bar_exact + b * phi,
                            k_exact=avg.k_exact + 1)
    a, b = _weights(avg.k_approx)
    return avg._replace(bar_approx=a * avg.bar_approx + b * phi,
                        k_approx=avg.k_approx + 1)


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
