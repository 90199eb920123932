"""Common neural layers: norms, RoPE, SwiGLU MLP, embeddings and the token
cross entropy (PyTorch port of ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import (ModelConfig, ParamSpec, as_replicated, batch_local,
                     gather_fsdp, is_dtensor, replicate_dims)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  Split halves (not
    interleaved), computed in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W_g) * (x W_u)) W_d; weights (D,F),(D,F),(F,D)."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              prefix_shape=()) -> dict:
    f = d_ff or cfg.d_ff
    ax = ("layers",) * len(prefix_shape)
    return {
        "gate": ParamSpec(prefix_shape + (cfg.d_model, f),
                          ax + ("embed", "mlp"), cfg.dtype),
        "up": ParamSpec(prefix_shape + (cfg.d_model, f),
                        ax + ("embed", "mlp"), cfg.dtype),
        "down": ParamSpec(prefix_shape + (f, cfg.d_model),
                          ax + ("mlp", "embed"), cfg.dtype),
    }


def embed_specs(cfg: ModelConfig) -> dict:
    out = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), cfg.dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), cfg.dtype)
    return out


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    w = gather_fsdp(params["embedding"])
    if is_dtensor(w):   # the rows of each rank's tokens, from the whole table
        return batch_local(lambda t, e: e[t.long()],
                           as_replicated(tokens, w), w)
    return w[tokens.long()]


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    head = gather_fsdp(params["embedding"].T if cfg.tie_embeddings
                       else params["lm_head"])
    return torch.matmul(x, head)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy; logits (..., V), labels (...).  The
    log-sum-exp in float32; with ``mask``, the mean over the masked-in
    tokens (at least one).  A DTensor's vocab shards are gathered for the
    gold logit's lookup."""
    logits = replicate_dims(logits, -1).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
