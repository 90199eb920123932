"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function computes exactly its kernel's contract.  The kernel
wrappers in :mod:`repro_torch.kernels.ops` use them for CPU tensors; the
tests and ``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

import torch


def plane_scores_ref(planes: torch.Tensor, w: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """``scores[r] = <planes[r], w> + offsets[r]``.

    A product and a per-row sum, not ``planes @ w``: the CPU's matrix-vector
    routine can round two equal rows differently, and then an argmax over
    duplicate cached planes no longer picks the first one.  Each row here
    is reduced the same way, as in the kernel.
    """
    return (planes * w).sum(dim=1) + offsets


def viterbi_step_ref(m: torch.Tensor, trans: torch.Tensor):
    """One max-plus step: ``m (B, C)``, ``trans (C, C)`` or ``(B, C, C)``.

    Returns ``(max_c' m[b, c'] + trans[c', c], first argmax c')`` as
    ``((B, C) float32, (B, C) int32)``.
    """
    cand = m[:, :, None] + trans
    return cand.amax(dim=1), cand.argmax(dim=1).to(torch.int32)


def viterbi_decode_ref(unary: torch.Tensor, trans: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked Viterbi decode of a batch of chains, step by step.

    ``unary (B, L, C)``, ``trans (C, C)``, ``mask (B, L)`` bool.  Each row
    is ``repro/core/oracles/chain.py::viterbi_decode``: unaries at padded
    positions are zeroed, and a step into a padded position uses zero
    transitions, so ``cand[c', c] = m[c'] + 0.0``.  Returns ``(B, L)``
    int32 labels.
    """
    B, L, C = unary.shape
    u = torch.where(mask[:, :, None], unary, 0.0)
    m = u[:, 0]
    backs = []
    for l in range(1, L):
        t = torch.where(mask[:, l, None, None], trans, 0.0)   # (B, C, C)
        best, back = viterbi_step_ref(m, t)
        m = best + u[:, l]
        backs.append(back)
    labels = torch.empty((B, L), dtype=torch.int32, device=unary.device)
    y = m.argmax(dim=1)
    labels[:, L - 1] = y.to(torch.int32)
    for l in range(L - 2, -1, -1):
        y = backs[l].gather(1, y[:, None].long())[:, 0].long()
        labels[:, l] = y.to(torch.int32)
    return labels
