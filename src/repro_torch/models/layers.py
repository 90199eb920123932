"""Common neural layers: norms, RoPE, SwiGLU MLP, embeddings and the token
cross entropy (PyTorch port of ``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import (ModelConfig, ParamSpec, _replicate_where, as_replicated,
                     batch_local, gather_fsdp, is_dtensor, local_fn,
                     local_region)


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
    if is_dtensor(w):
        return _sharded_lookup(w, tokens)
    return w[tokens.long()]


def _vocab_dims(t: torch.Tensor, dim: int) -> list:
    """The mesh dims whose placement shards DTensor ``t``'s vocab dim."""
    return [i for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim % t.ndim]


def _rows_of(x: torch.Tensor, like: torch.Tensor, vocab: list):
    """``x`` (token ids, labels or a mask; plain or DTensor) placed as
    ``like``'s batch rows: sharded on the mesh dims that shard ``like``'s
    leading dim, whole on the rest (the ``vocab`` dims among them)."""
    from torch.distributed.tensor import Replicate
    plc = tuple(p if p.is_shard() and p.dim == 0 and i not in vocab
                else Replicate() for i, p in enumerate(like.placements))
    x = as_replicated(x, like)
    return plc, (x if tuple(x.placements) == plc
                 else x.redistribute(like.device_mesh, plc))


def _sharded_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens`` from a DTensor table ``w (V, D)``.  A table
    whose vocab is sharded stays on its shards: each rank looks up the
    tokens of its local rows that fall in its own vocab rows, zeros for
    the rest, and the sum over the vocab's mesh dims (one all-reduce of
    the activations) is the lookup; the table's gradient stays a shard of
    the vocab (a partial sum over the batch's mesh dims only).  A table
    the rules replicate is looked up whole on the local rows."""
    vocab = _vocab_dims(w, 0)
    if not vocab:
        return batch_local(lambda t, e: e[t.long()],
                           as_replicated(tokens, w), w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = _replicate_where(w, lambda n, p: p.is_partial() or (
        p.is_shard() and p.dim != 0))
    mesh = w.device_mesh
    rows, tokens = _rows_of(tokens, tokens if is_dtensor(tokens) else w,
                            vocab)
    w_plc = tuple(w.placements)
    out_plc = [Partial() if i in vocab else p for i, p in enumerate(rows)]
    grad_plc = tuple(Shard(0) if i in vocab else
                     Partial() if p.is_shard() else Replicate()
                     for i, p in enumerate(rows))
    (n, _), (off, _) = local_region(w.shape, mesh, w_plc)

    def look(t, e):
        idx = t.long() - off
        inside = (idx >= 0) & (idx < n)
        return e[idx.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)

    out = local_map(local_fn(look), out_placements=out_plc,
                    in_placements=(rows, w_plc),
                    in_grad_placements=(rows, grad_plc),
                    device_mesh=mesh)(tokens, w)
    return _replicate_where(out, lambda n, p: p.is_partial())


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    head = gather_fsdp(params["embedding"].T if cfg.tie_embeddings
                       else params["lm_head"])
    return torch.matmul(x, head)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy; logits (..., V), labels (...).  The
    log-sum-exp in float32; with ``mask``, the mean over the masked-in
    tokens (at least one).  DTensor logits stay on their shards
    (:func:`_sharded_nll`)."""
    if is_dtensor(logits):
        nll = _sharded_nll(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)


def _sharded_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp - gold`` of DTensor logits, run through
    ``local_map`` on each rank's own (batch rows, vocab columns) block
    (:class:`_VocabParallelNLL`): the vocab is never gathered and no
    tensor is replicated over the batch.  The result is placed as the
    logits' batch rows, whole over the vocab's mesh dims."""
    from torch.distributed.tensor.experimental import local_map
    last = logits.ndim - 1
    logits = _replicate_where(logits, lambda n, p: p.is_partial() or (
        p.is_shard() and p.dim not in (0, last)))
    mesh = logits.device_mesh
    plc = tuple(logits.placements)
    vocab = _vocab_dims(logits, last)
    rows, labels = _rows_of(labels, logits, vocab)
    offset = local_region(logits.shape, mesh, plc)[1][last]
    groups = [(mesh, i) for i in vocab]
    return local_map(
        local_fn(lambda x, t: _VocabParallelNLL.apply(x, t, offset, groups)),
        out_placements=list(rows), in_placements=(plc, rows),
        device_mesh=mesh)(logits, labels)


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, op, g)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _VocabParallelNLL(torch.autograd.Function):
    """Vocab-parallel cross entropy on one rank's block ``x (..., V_r)``
    of the logits, whose columns start at vocab index ``offset``, against
    the block's ``labels (...)``; ``groups`` are the mesh dims the vocab
    is sharded over (none: the whole vocab is local).

    The max over the vocab (detached, as ``jax.nn.logsumexp``'s is) is a
    local max reduced by max; ``sum exp(x - max)`` and the gold logit (a
    local lookup at ``label - offset``, clamped, zero where the label is
    another rank's column) are local sums reduced by sum, in one
    all-reduce.  The backward is ``softmax - onehot`` on the local block
    alone: no collective, nothing beyond the block."""

    @staticmethod
    def forward(ctx, x, labels, offset, groups):
        n = x.shape[-1]
        xf = x.float()
        m = _all_reduce(xf.amax(-1), "max", groups)
        idx = labels.long() - offset
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        z = xf - m[..., None]
        gold = torch.gather(z, -1, idx[..., None])[..., 0]
        sums = _all_reduce(torch.stack(
            [torch.exp(z).sum(-1), gold.masked_fill(~inside, 0)], -1),
            "sum", groups)
        lse = torch.log(sums[..., 0])
        ctx.save_for_backward(x, lse + m, idx, inside)
        return lse - sums[..., 1]

    @staticmethod
    def backward(ctx, grad):
        x, lse, idx, inside = ctx.saved_tensors
        p = torch.exp(x.float() - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -inside.to(p.dtype)[..., None])
        return (p * grad[..., None]).to(x.dtype), None, None, None
