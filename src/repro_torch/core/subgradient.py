"""Pegasos-style stochastic subgradient baseline (paper Sec. 2.1, [19,22]),
PyTorch port of ``repro/core/subgradient.py``.

At step t, pick a block i, call its oracle at the current w, and take

    w <- (1 - 1/t) w - (1/(lam t)) * n * phi_hat_star

(the n factor undoes the 1/n folded into the planes).  No line search, no
dual certificate.  The step counter ``t`` lives on the device, an ()
int32 tensor as the reference's ``t_ctr``, and the step is one block step
with the block read on the device: a plain loop on the CPU, one replay of
its captured CUDA graph per block on the card
(:mod:`repro_torch.core.graphs`).  ``w`` and ``t`` are updated in place.
"""
from __future__ import annotations

import numpy as np
import torch

from .graphs import StepControl, StepGraphs, load_control
from .types import SSVMProblem


def ssg_step(problem: SSVMProblem, w: torch.Tensor, t: torch.Tensor,
             ctl: StepControl, lam: float) -> None:
    """One subgradient step on block ``ctl.ids[cursor]``, in place, in the
    reference's order of roundings: ``step = 1/(lam t)`` in float32, then
    ``(1 - 1/t) w - step n phi_hat*``.  Advances ``t`` and the cursor."""
    i = ctl.block()
    example = {k: v.index_select(0, i) for k, v in problem.data.items()}
    phi_hat = problem.oracle(w, example)[0]
    tf = t.to(torch.float32)
    step = 1.0 / (lam * tf)
    w.copy_((1.0 - 1.0 / tf) * w - step * problem.n * phi_hat[:-1])
    t.add_(1)
    ctl.cursor.add_(1)


def ssg_pass(problem: SSVMProblem, w: torch.Tensor, t: torch.Tensor, perm,
             lam: float, *, graphs: StepGraphs) -> None:
    """One pass of stochastic subgradient over the blocks of the host
    permutation ``perm``, in place on ``w`` (d,) and the step counter
    ``t`` (an () int32 tensor on ``w``'s device): one :func:`ssg_step` per
    block, its captured graph kept in ``graphs`` on CUDA."""
    ids = np.asarray(perm, np.int64).reshape(-1)
    ctl = graphs.control("ssg", (w, t) + tuple(problem.data.values()),
                         (lam, problem.oracle, problem.n), len(ids),
                         problem.d)
    load_control(ctl, ids, k0=0, it=0)
    graphs.run("ssg", "step", lambda: ssg_step(problem, w, t, ctl, lam),
               len(ids))
