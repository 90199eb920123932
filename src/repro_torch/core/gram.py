"""Inner-product recurrences for repeated approximate steps (paper Sec. 3.5).

A port of ``repro/core/gram.py``.  When the approximate oracle is applied
to the same block several times in a row (the paper repeats it 10 times),
every quantity the BCFW line search needs follows from scalar recurrences
over the block's cached Gram products ``<phi_a*, phi_b*>``, so each inner
step costs Theta(|W_i|) instead of Theta(|W_i| d).  The Gram blocks live
in the plane cache (``CacheLayout(gram=True)``), refreshed row by row by
:func:`repro_torch.cache.ops.insert`.

Recurrences (phi' = phi + g(phi_h - phi_i); phi_i' = (1-g) phi_i + g phi_h):
    a_j = <phi_j*, phi*>   ->  a_j + g (G[j,h] - b_j)
    b_j = <phi_j*, phi_i*> -> (1-g) b_j + g G[j,h]
    c   = <phi_i*, phi_i*> -> (1-g)^2 c + 2g(1-g) b_h + g^2 G[h,h]
    e   = <phi_i*, phi*>   -> (1-g)(e + g(b_h - c)) + g(a_h + g(G[h,h]-b_h))
with h the argmax plane.  phi_i' is materialized from the convex-combination
coefficients with one (cap, d+1) product, and phi' - phi_i' = phi - phi_i.

The reference scans the steps inside one XLA program.  Here
:func:`multi_step_block_update` is a Python loop of device operations (the
argmax stays a (1,) index tensor and every scalar a 0-d tensor, so a block
enqueues its work without blocking the host); it is the block step of the
``approx_pass`` kernel's plain version
(:func:`repro_torch.core.mpbcfw.eager_pass`), and on CUDA a whole pass of
it is one launch of that kernel (:func:`repro_torch.core.mpbcfw.run_pass`
with ``steps``).  ``a`` and ``b`` come from :func:`repro_torch.cache.
row_dots` (the ``plane_scores`` kernel on CUDA), which reduces equal rows
alike, so duplicate cached planes tie and the first one wins; the kernel
scores in the same order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import cache as plane_cache
from ..cache import NEG_INF


def multi_step_block_update(planes_i: torch.Tensor, valid_i: torch.Tensor,
                            gram_i: torch.Tensor, phi: torch.Tensor,
                            phi_i: torch.Tensor, lam: float, steps: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``steps`` repeated approximate BCFW updates on one block, O(cap) each.

    ``planes_i (cap, d+1)``, ``valid_i (cap,)``, ``gram_i (cap, cap)``,
    ``phi`` and ``phi_i (d+1,)``; nothing is written.  Returns ``(phi_i',
    phi', won)``, where ``won[j]`` marks the planes the approximate oracle
    returned at least once.
    """
    cap = planes_i.shape[0]
    dev = planes_i.device
    star, circ = planes_i[:, :-1], planes_i[:, -1]
    a = plane_cache.row_dots(star, phi[:-1])
    b = plane_cache.row_dots(star, phi_i[:-1])
    c = torch.dot(phi_i[:-1], phi_i[:-1])
    e = torch.dot(phi_i[:-1], phi[:-1])
    oi = phi_i[-1]
    # (The reference also carries phi's offset; nothing reads it.)
    lam_t = torch.full((), lam, dtype=torch.float32, device=dev)
    neg = torch.full((cap,), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    any_valid = valid_i.any()
    diag = gram_i.diagonal()

    # Convex-combination coefficients of phi_i over [phi_i_init, planes].
    beta0 = torch.ones((), dtype=torch.float32, device=dev)
    beta = torch.zeros((cap,), dtype=torch.float32, device=dev)
    won = torch.zeros((cap,), dtype=torch.bool, device=dev)
    for _ in range(steps):
        scores = torch.where(valid_i, circ - a / lam_t, neg)
        h = scores.argmax().reshape(1)
        gh = gram_i.index_select(1, h).reshape(cap)
        ah, bh, ch, ghh = torch.stack((a, b, circ, diag)).index_select(
            1, h).reshape(4).unbind()
        num = (e - ah) - lam * (oi - ch)
        den = c - 2.0 * bh + ghh
        g = torch.where(den > 0, num / den.clamp_min(1e-30), zero)
        g = torch.where(any_valid, g.clamp(0.0, 1.0), zero)
        omg = 1.0 - g
        e = omg * (e + g * (bh - c)) + g * (ah + g * (ghh - bh))
        a = a + g * (gh - b)
        b = omg * b + g * gh
        c = omg * omg * c + 2.0 * g * omg * bh + g * g * ghh
        oi = omg * oi + g * ch
        beta0 = omg * beta0
        beta = omg * beta
        beta.index_add_(0, h, g.reshape(1))
        won.index_copy_(0, h, any_valid.reshape(1))

    new_phi_i = beta0 * phi_i + beta @ planes_i
    new_phi = phi + (new_phi_i - phi_i)  # phi - phi_i is invariant
    return new_phi_i, new_phi, won
