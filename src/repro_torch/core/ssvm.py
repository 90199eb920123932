"""SSVM objective helpers: dual bound F, primal objective, weights.

The SSVM primal (paper eq. 1/4) is

    P(w) = lam/2 ||w||^2 + sum_i H_i(w),
    H_i(w) = max_y <phi^{iy}, [w 1]>,

and any feasible dual vector ``phi = sum_i phi_i`` yields the lower bound

    F(phi) = -||phi_star||^2 / (2 lam) + phi_circ.            (paper eq. 5)
"""
from __future__ import annotations

import torch

from .types import BCFWState, SSVMProblem


def dual_value(phi: torch.Tensor, lam: float) -> torch.Tensor:
    """F(phi) (paper eq. 5), a () float32 tensor."""
    return -torch.dot(phi[:-1], phi[:-1]) / (2.0 * lam) + phi[-1]


def weights_of(phi: torch.Tensor, lam: float) -> torch.Tensor:
    """Primal weights induced by a dual vector: w = -phi_star / lam."""
    return -phi[:-1] / lam


def plane_score(phi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """<phi, [w 1]> = <phi_star, w> + phi_circ."""
    return torch.dot(phi[:-1], w) + phi[-1]


def batched_oracle(problem: SSVMProblem, w: torch.Tensor) -> torch.Tensor:
    """The max-oracle of every example at the same ``w``: (n, d+1) planes."""
    return problem.oracle(w, problem.data)


def primal_value(problem: SSVMProblem, w: torch.Tensor,
                 lam: float) -> torch.Tensor:
    """P(w) = lam/2 ||w||^2 + sum_i H_i(w).  Costs n oracle calls."""
    planes = batched_oracle(problem, w)
    hinge = torch.sum(planes[:, :-1] @ w + planes[:, -1])
    return 0.5 * lam * torch.dot(w, w) + hinge


def init_state(problem: SSVMProblem, device) -> BCFWState:
    """Start from the ground-truth planes phi^{i y_i} = 0 (so w = 0)."""
    return BCFWState(
        phi_i=torch.zeros((problem.n, problem.d + 1), dtype=torch.float32,
                          device=device),
        phi=torch.zeros((problem.d + 1,), dtype=torch.float32, device=device),
        n_exact=0, n_approx=0)
