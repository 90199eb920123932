"""The block-coordinate Frank-Wolfe step (paper Alg. 2, steps 5-7)."""
from __future__ import annotations

from typing import Tuple

import torch

from .types import BCFWState, row_of, set_row


def line_search_gamma(phi: torch.Tensor, phi_i: torch.Tensor,
                      phi_hat: torch.Tensor, lam: float) -> torch.Tensor:
    """Closed-form exact line search (paper Alg. 2 step 6).

    gamma = [<phi_i* - phi_hat*, phi*> - lam (phi_i o - phi_hat o)]
            / ||phi_i* - phi_hat*||^2,  clipped to [0, 1]; 0 when the
    denominator is 0.
    """
    diff = phi_i - phi_hat
    num = torch.dot(diff[:-1], phi[:-1]) - lam * diff[-1]
    den = torch.dot(diff[:-1], diff[:-1])
    gamma = torch.where(den > 0.0, num / torch.clamp_min(den, 1e-30),
                        torch.zeros_like(num))
    return torch.clamp(gamma, 0.0, 1.0)


def block_update(state: BCFWState, i, phi_hat: torch.Tensor,
                 lam: float) -> Tuple[BCFWState, torch.Tensor]:
    """One BCFW step on block ``i`` (a host int, or a (1,) int64 tensor on
    the state's device) with candidate plane ``phi_hat``.

    Updates ``state.phi_i[i]`` and ``state.phi`` in place and returns the
    state and gamma.  Monotone in F: exact line search, gamma = 0 allowed.
    """
    phi_i = row_of(state.phi_i, i)
    gamma = line_search_gamma(state.phi, phi_i, phi_hat, lam)
    new_phi_i = (1.0 - gamma) * phi_i + gamma * phi_hat
    state.phi.add_(new_phi_i - phi_i)
    set_row(state.phi_i, i, new_phi_i)
    return state, gamma
