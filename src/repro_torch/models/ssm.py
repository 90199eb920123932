"""Mamba2 (SSD) blocks, PyTorch port of ``repro/models/ssm.py``: training
and prefill through the chunked SSD algorithm, decode through the state
recurrence.  Used by zamba2 (the hybrid family).

Chunked SSD (Dao & Gu 2024), ngroups=1: within a chunk the output is an
attention-like (Q x Q) masked product; across chunks a (H, N, p) state is
carried by a loop over the chunks, each chunk taking the state from before
its own update (the reference's ``lax.scan`` emits it so).  Every sum keeps
the reference's order where it is a loop (the depthwise conv's K shifted
products, the chunk loop); the einsums are torch's.  The intra-chunk decay
masks before its exp (:func:`_masked_exp`): the reference's values, with a
finite gradient where the reference's is NaN.  No kernel: the reference
computes SSD with einsums and a scan, outside any Pallas kernel.

The intra-chunk step makes (B, nc, Q, Q, H) float32 slabs: the segment
sums, their masked copy, the decay L, the scores and the einsum's
permuted copy of them; at zamba2-7b's prefill_32k one is 7.5 GB a rank.
An eager step frees a tensor only when its last reference goes, whereas
the reference's XLA program frees each buffer after its last use, so each
slab here is dropped right after its last use and no op of a no-grad step
sees more than two live.  Under autograd each op still saves what its
backward needs.  Only lifetimes differ from a step that keeps every slab
as a local to its end: the same ops on the same operands in the same
order, so the values are its values, bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..launch.trace_analysis import loop
from .common import ModelConfig, ParamSpec, batch_local, merge_heads

HEADDIM = 64


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // HEADDIM
    return d_inner, nheads, cfg.ssm_state


def ssm_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape)
    d_inner, nheads, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "in_proj": ParamSpec(
            prefix_shape + (cfg.d_model, 2 * d_inner + 2 * N + nheads),
            ax + ("embed", "mlp"), cfg.dtype),
        "conv_w": ParamSpec(prefix_shape + (cfg.ssm_conv, conv_dim),
                            ax + (None, "conv"), cfg.dtype),
        "conv_b": ParamSpec(prefix_shape + (conv_dim,), ax + ("conv",),
                            cfg.dtype, scale=0.0),
        "A_log": ParamSpec(prefix_shape + (nheads,), ax + (None,),
                           torch.float32, scale=1.0),
        "D": ParamSpec(prefix_shape + (nheads,), ax + (None,), torch.float32,
                       scale=1.0),
        "dt_bias": ParamSpec(prefix_shape + (nheads,), ax + (None,),
                             torch.float32, scale=0.0),
        "norm": ParamSpec(prefix_shape + (d_inner,), ax + (None,),
                          cfg.dtype, scale=1.0),
        "out_proj": ParamSpec(prefix_shape + (d_inner, cfg.d_model),
                              ax + ("mlp", "embed"), cfg.dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (K, C); the K shifted products
    summed in index order, then ``silu(out + b)``."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b)


def _split_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    d_inner, nheads, N = ssm_dims(cfg)
    zxbcdt = torch.matmul(x, p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt = zxbcdt[..., -nheads:]
    return z, xBC, dt


def _gated_norm(y: torch.Tensor, scale: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The grouped RMSNorm over all of ``d_inner``, in float32, cast back
    to ``y``'s dtype."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)


def _masked_exp(seg: torch.Tensor, Q: int) -> torch.Tensor:
    """``exp(seg)`` on the causal (q >= s) entries of a (B, nc, Q, Q, H)
    segment-sum tensor, 0 above the diagonal.  The mask goes in before the
    exp: the reference takes ``where(causal, exp(seg), 0)``, the same
    values, but above the diagonal seg is a sum of -a > 0 that overflows
    to inf over a long chunk, and the gradient through the discarded inf
    is 0 * inf = NaN (reduced zamba2 at a 32-token chunk; ROADMAP's
    quirks).  Here those entries are exp(-inf) = 0 with a zero gradient,
    so the gradient equals the reference's wherever that is finite.

    ``seg`` is dropped once its masked copy exists, so the ``exp`` sees two
    slabs live (the masked copy and its output) where the caller passes
    ``seg`` unnamed (:func:`ssd_forward`); a caller that keeps ``seg``
    named keeps it live."""
    qi = torch.arange(Q, device=seg.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    masked = seg.masked_fill(~causal, float("-inf"))
    del seg
    return torch.exp(masked)


def ssd_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) via chunked SSD.

    The intra-chunk slabs (B, nc, Q, Q, H) live no longer than they are
    used: the segment sums go to :func:`_masked_exp` unnamed, L is dropped
    once ``cb * L`` exists, that product once ``* dt`` exists, the scores
    after the ``y_intra`` einsum.  So at most two are live at any op of a
    no-grad step (the module docstring says why); the values are those of
    the same ops with the slabs kept to the end, bit for bit."""
    Bsz, S, _ = x.shape
    d_inner, H, N = ssm_dims(cfg)
    pdim = HEADDIM
    Q = min(cfg.ssm_chunk, S)
    pad = -S % Q
    z, xBC, dt = _split_proj(p, x, cfg)
    xBC = batch_local(_causal_conv, xBC, p["conv_w"], p["conv_b"])
    if pad:   # after the conv; dt padded with zeros before the softplus
        xBC, dt = (batch_local(lambda t: F.pad(t, (0, 0, 0, pad)), t)
                   for t in (xBC, dt))
    Sp = xBC.shape[1]
    nc = Sp // Q
    xs = xBC[..., :d_inner].reshape(Bsz, nc, Q, H, pdim).float()
    Bm = xBC[..., d_inner:d_inner + N].reshape(Bsz, nc, Q, N).float()
    Cm = xBC[..., d_inner + N:].reshape(Bsz, nc, Q, N).float()
    dt = F.softplus(dt.float() + p["dt_bias"]).reshape(Bsz, nc, Q, H)
    A = -torch.exp(p["A_log"])                                # (H,)
    a = dt * A                                                # (B,nc,Q,H)
    cum = batch_local(lambda t: torch.cumsum(t, dim=2), a)    # (B,nc,Q,H)

    # intra-chunk: L[q,s] = exp(cum_q - cum_s) for s <= q, else 0; each
    # (B,nc,Q,Q,H) slab dropped after its last use
    L = _masked_exp(cum[:, :, :, None, :] - cum[:, :, None, :, :], Q)
    cb = torch.einsum("bcqn,bcsn->bcqs", Cm, Bm)
    scores = cb[..., None] * L
    del L
    scores = scores * dt[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xs)
    del scores

    # chunk summaries: S_c = sum_s exp(cum_Q - cum_s) dt_s B_s x_s^T
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,Q,H)
    sc = torch.einsum("bcsh,bcsn,bcshp->bchnp", dt * decay_out, Bm, xs)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    # The inter-chunk recurrence: chunk c reads the state before its own
    # update.
    state = torch.zeros((Bsz, H, N, pdim), dtype=torch.float32,
                        device=x.device)
    states = []
    for c in loop("ssm.ssd_chunks", nc):
        states.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    states = torch.stack(states, dim=1)                       # (B,nc,H,N,p)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cm, torch.exp(cum),
                           states)
    y = (y_intra + y_inter).reshape(Bsz, Sp, H, pdim)[:, :S]
    y = y + p["D"][None, None, :, None] * \
        xBC[..., :d_inner].reshape(Bsz, Sp, H, pdim)[:, :S]
    y = merge_heads(y).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg)
    return torch.matmul(y, p["out_proj"])


def init_ssm_cache(cfg: ModelConfig, batch: int, layers: int,
                   device=None) -> dict:
    d_inner, H, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "state": torch.zeros((layers, batch, H, N, HEADDIM),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
    }


def ssd_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token decode.  x: (B, 1, D); cache: {'state', 'conv'} of one
    layer.  Returns ``(out, new cache)``; the cache given is not written."""
    Bsz = x.shape[0]
    d_inner, H, N = ssm_dims(cfg)
    pdim = HEADDIM
    z, xBC, dt = _split_proj(p, x, cfg)
    # rolling conv buffer
    hist = torch.cat([cache["conv"], xBC], dim=1)         # (B, K, conv_dim)
    out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    xBC1 = F.silu(out)[:, None, :]
    new_conv = hist[:, 1:]
    xs = xBC1[..., :d_inner].reshape(Bsz, H, pdim).float()
    Bm = xBC1[..., d_inner:d_inner + N].reshape(Bsz, N).float()
    Cm = xBC1[..., d_inner + N:].reshape(Bsz, N).float()
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dtv * A)                                  # (B, H)
    state = cache["state"] * dec[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dtv, Bm, xs)
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype) * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg)
    return torch.matmul(y, p["out_proj"]), {"state": state, "conv": new_conv}
