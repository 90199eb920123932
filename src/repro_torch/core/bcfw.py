"""Frank-Wolfe and Block-Coordinate Frank-Wolfe (paper Alg. 1 and 2).

The reference expresses both as jitted ``lax.scan`` passes.  Here the BCFW
pass is one block step per block of the host permutation, the block read
on the device (:func:`block_step`): a plain loop on the CPU, one replay of
the step's captured CUDA graph per block on the card
(:mod:`repro_torch.core.graphs`).  MP-BCFW's exact step
(:func:`repro_torch.core.mpbcfw.exact_step`) is the same body plus the
cache insert.  The FW pass is one batched oracle over all n examples at
the same ``w`` and a closed-form line search.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .averaging import average_step
from .graphs import StepControl, StepGraphs, load_control
from .ssvm import weights_of
from .types import AveragingState, BCFWState, SSVMProblem, row_of, set_row


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


def plane_score(plane: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``<plane, [w 1]>``: the plane's value at ``w``, () float32."""
    return torch.dot(plane[:-1], w) + plane[-1]


def block_step(problem: SSVMProblem, st: BCFWState, bar: torch.Tensor,
               ctl: StepControl, lam: float, *, with_gap: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Optional[torch.Tensor]]:
    """One exact BCFW block step, in place, with the block read on the
    device: the spec's oracle at ``w = -phi*/lam`` on block
    ``ctl.ids[cursor]``, the line search and an exact-track averaging step
    of ``bar`` with the pass's weights.  Returns the block id ((1,) int64),
    its oracle plane and, ``with_gap``, the block's duality gap at the
    step's ``w`` (the oracle plane's score minus that of ``phi_i``'s row
    before the update, () float32; else None).  The caller advances the
    cursor."""
    i = ctl.block()
    example = {k: v.index_select(0, i) for k, v in problem.data.items()}
    w = weights_of(st.phi, lam)
    phi_hat = problem.oracle(w, example)[0]
    gap = (plane_score(phi_hat, w) - plane_score(row_of(st.phi_i, i), w)
           if with_gap else None)
    block_update(st, i, phi_hat, lam)
    average_step(bar, st.phi, ctl.weight(), ctl.scratch)
    return i, phi_hat, gap


def exact_step(problem: SSVMProblem, st: BCFWState, bar: torch.Tensor,
               ctl: StepControl, lam: float) -> None:
    """:func:`block_step`, then the cursor advances: the body of
    :func:`exact_pass`'s loop, and of its captured graph on CUDA."""
    block_step(problem, st, bar, ctl, lam)
    ctl.cursor.add_(1)


def exact_pass(problem: SSVMProblem, st: BCFWState, avg: AveragingState,
               perm, lam: float, *, graphs: StepGraphs
               ) -> Tuple[BCFWState, AveragingState]:
    """One BCFW pass over the blocks of the host permutation ``perm``
    (exact oracle calls), in place: one :func:`exact_step` per block, a
    plain loop on the CPU and one replay of the step's captured graph per
    block on CUDA, kept in ``graphs``.  The host counters ``n_exact`` and
    ``k_exact`` advance by the pass's length."""
    ids = np.asarray(  # repro: allow[R004] host permutation
        perm, np.int64).reshape(-1)
    ctl = graphs.control(
        "bcfw", (st.phi, st.phi_i, avg.bar_exact) + tuple(
            problem.data.values()), (lam, problem.oracle), len(ids),
        problem.d)
    load_control(ctl, ids, k0=avg.k_exact, it=0)
    graphs.run("bcfw", "exact",
               lambda: exact_step(problem, st, avg.bar_exact, ctl, lam),
               len(ids))
    return (st._replace(n_exact=st.n_exact + len(ids)),
            avg._replace(k_exact=avg.k_exact + len(ids)))


def fw_pass(problem: SSVMProblem, phi: torch.Tensor,
            lam: float) -> torch.Tensor:
    """One iteration of batch Frank-Wolfe (paper Alg. 1): the oracle of
    all n examples at the same ``w`` in one batched call (on a chain
    problem one Viterbi launch at B = n), their summed plane as the FW
    vertex of the product domain, and the closed-form line search."""
    w = weights_of(phi, lam)
    phi_hat = problem.oracle(w, problem.data).sum(dim=0)
    diff = phi - phi_hat
    num = torch.dot(diff[:-1], phi[:-1]) - lam * diff[-1]
    den = torch.dot(diff[:-1], diff[:-1])
    gamma = torch.clamp(torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                                    torch.zeros_like(num)), 0.0, 1.0)
    return (1.0 - gamma) * phi + gamma * phi_hat
