"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function computes exactly its kernel's contract.  The kernel
wrappers in :mod:`repro_torch.kernels.ops` use them for CPU tensors; the
tests and ``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# The one invalid-slot score sentinel: loses every argmax, and is exactly
# representable in float32.  Re-exported as ``kernels.ops.INVALID_SCORE``.
INVALID_SCORE = -1e30  # repro: allow[R001] the port's own sentinel home


def plane_scores_ref(planes: torch.Tensor, w: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """``scores[r] = <planes[r], w> + offsets[r]``.

    A product and a per-row sum, not ``planes @ w``: the CPU's matrix-vector
    routine can round two equal rows differently, and then an argmax over
    duplicate cached planes no longer picks the first one.  Each row here
    is reduced the same way, as in the kernel.
    """
    return (planes * w).sum(dim=1) + offsets


def plane_select_ref(planes: torch.Tensor, w: torch.Tensor,
                     offsets: torch.Tensor, valid: torch.Tensor,
                     rows: Optional[torch.Tensor] = None,
                     neg: float = INVALID_SCORE):
    """Fused score-and-select: ``planes (n, cap, d)``, ``offsets`` and
    ``valid (n, cap)``, over the rows ``rows`` (int64, default all).

    Returns ``(best (k,) float32, idx (k,) int32)``: the best valid slot's
    score and the first slot attaining it; a row with no valid slot gives
    ``(neg, 0)`` (``repro/kernels/ref.py::plane_select_ref``).  Scores go
    through :func:`plane_scores_ref` on the flattened ``(k*cap, d)`` rows,
    so they are bit-equal to the per-block approximate oracle's.
    """
    if rows is not None:
        planes, offsets, valid = planes[rows], offsets[rows], valid[rows]
    k, cap, d = planes.shape
    scores = plane_scores_ref(planes.reshape(k * cap, d), w,
                              offsets.reshape(k * cap)).reshape(k, cap)
    masked = torch.where(valid, scores, torch.full_like(scores, neg))
    return masked.amax(dim=1), masked.argmax(dim=1).to(torch.int32)


def gram_ref(planes: torch.Tensor) -> torch.Tensor:
    """``G[a, b] = <planes[a], planes[b]>`` for ``(N, d)`` planes
    (``repro/kernels/ref.py::gram_ref``)."""
    return planes @ planes.T


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


def mask_of(window: int = 0, causal: bool = True) -> str:
    """The mask an attention call asks for, checked once for the kernel,
    its plain version and the function whose gradient the kernel takes:
    ``"bidirectional"`` without ``causal`` (which takes no window),
    ``"window"`` for a causal window of ``window`` >= 1 keys, else
    ``"causal"``."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not causal:
        if window:
            raise ValueError("flash_attention: a window is causal")
        return "bidirectional"
    return "window" if window else "causal"


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None, window: int = 0,
                        causal: bool = True,
                        score_dtype: str = "f32") -> torch.Tensor:
    """Softmax attention over ``(BH, S, D)`` q, k and ``(BH, S, Dv)`` v
    (``repro/kernels/ref.py::flash_attention_ref``): scores in the input
    type, then float32 with masked entries at :data:`INVALID_SCORE`, scaled
    by ``D ** -0.5`` unless ``sm_scale`` is given; the output in q's type.
    The mask is causal, causal within the last ``window`` keys (``window``
    > 0: key j seen by row i for i - window < j <= i, as
    ``chunked_causal_attention``'s ``sliding_window``), or none
    (``causal`` false: bidirectional).  A ``(B, S, H, D)`` q with ``(B, S,
    K, D)`` k and ``(B, S, K, Dv)`` v (grouped kv heads, K divides H) runs
    as ``(B*H, S, .)`` with each kv head repeated H/K times, and returns
    ``(B, S, H, Dv)``."""
    if q.dim() == 4:
        B, S, H, _ = q.shape
        rep = H // k.shape[2]

        def heads(t, r):
            return (t.repeat_interleave(r, dim=2).transpose(1, 2)
                    .reshape(B * H, S, t.shape[-1]))
        o = flash_attention_ref(heads(q, 1), heads(k, rep), heads(v, rep),
                                sm_scale, window, causal, score_dtype)
        return o.reshape(B, H, S, -1).transpose(1, 2).contiguous()
    mask = mask_of(window, causal)
    bh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if score_dtype == "bf16":
        if mask == "bidirectional":
            raise ValueError("flash_attention: bf16 scores are causal or "
                             "windowed")
        qb, kb = q.bfloat16(), k.bfloat16()
        scale = torch.full((), sm_scale, dtype=torch.bfloat16,
                           device=q.device)
        scores = (torch.bmm(qb, kb.transpose(1, 2)) * scale).float()
    elif score_dtype == "f32":
        scores = torch.bmm(q, k.transpose(1, 2)).float() * sm_scale
    else:
        raise ValueError(f"flash_attention: score dtype {score_dtype!r}")
    if causal:
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(s, device=q.device)[None, :]
        mask = row >= col
        if window > 0:
            mask &= col > row - window
        scores = torch.where(mask, scores,
                             torch.full_like(scores, INVALID_SCORE))
    p = torch.softmax(scores, dim=-1)
    if score_dtype == "bf16":
        v = v.bfloat16()
    return torch.bmm(p, v.float()).to(q.dtype)


def moe_ffn_ref(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU expert FFN (``repro/kernels/ref.py::moe_ffn_ref``):
    ``xs (E, C, D)``, ``wg``/``wu (E, D, F)``, ``wd (E, F, D)``; products
    in the input type, as the reference's einsums."""
    g = torch.bmm(xs, wg)
    u = torch.bmm(xs, wu)
    return torch.bmm(F.silu(g) * u, wd).to(xs.dtype)
