"""xLSTM blocks, PyTorch port of ``repro/models/xlstm.py``: mLSTM (matrix
memory, chunk-parallel) and sLSTM (scalar memory, recurrent) --
arXiv:2405.04517, as the reference adapts it.

mLSTM trains with the chunked decay-linear-attention scheme of SSD: per
head a state in R^{hd x hd} with a per-token sigmoid forget gate and
input gate; a masked quadratic product within a chunk, a loop over the
chunks across them (each chunk reads the state from before its update).
sLSTM mixes each head's previous output into its gates (``R h_{t-1}``), so
it runs as a loop over time; ``h`` is rounded to the input's dtype at
every step, as the reference's scan carries it.  The gates are the
reference's bounded sigmoid forms, split ``(i, f, z, o)`` along each
head's ``4 hd``.  No kernel: the reference computes both with einsums and
``lax.scan``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..launch.trace_analysis import loop
from .common import (ModelConfig, ParamSpec, batch_local,
                     grad_placed_as_input, is_dtensor, merge_heads,
                     per_shard, row_input, split_heads)
from .layers import rms_norm
from .ssm import _masked_exp

PROJ_FACTOR = 2  # mLSTM up-projection factor


def mlstm_dims(cfg: ModelConfig):
    d_inner = PROJ_FACTOR * cfg.d_model
    hd = d_inner // cfg.num_heads
    return d_inner, cfg.num_heads, hd


def mlstm_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape)
    d_inner, H, hd = mlstm_dims(cfg)
    return {
        "up": ParamSpec(prefix_shape + (cfg.d_model, 2 * d_inner),
                        ax + ("embed", "mlp"), cfg.dtype),
        "wq": ParamSpec(prefix_shape + (d_inner, d_inner),
                        ax + (None, "heads"), cfg.dtype),
        "wk": ParamSpec(prefix_shape + (d_inner, d_inner),
                        ax + (None, "heads"), cfg.dtype),
        "wv": ParamSpec(prefix_shape + (d_inner, d_inner),
                        ax + (None, "heads"), cfg.dtype),
        "wif": ParamSpec(prefix_shape + (d_inner, 2 * H),
                         ax + (None, None), cfg.dtype),
        "norm": ParamSpec(prefix_shape + (d_inner,), ax + (None,),
                          cfg.dtype, scale=1.0),
        "down": ParamSpec(prefix_shape + (d_inner, cfg.d_model),
                          ax + ("mlp", "embed"), cfg.dtype),
    }


def _mlstm_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """(q, k / sqrt(hd), v) as (B, S, H, hd), the gates (i, f) (B, S, H)
    in float32, and the output gate's input z."""
    d_inner, H, hd = mlstm_dims(cfg)
    # On DTensors the gradients of ``up`` and of the gates come back
    # placed as these products' outputs were: left to DTensor, they can
    # arrive reduce-scattered onto the sequence, whose shards the weight
    # gradients' products cannot contract (xlstm-125m on 512 ranks).
    up = grad_placed_as_input(torch.matmul(x, p["up"]))
    u, z = up[..., :d_inner], up[..., d_inner:]
    q = split_heads(torch.matmul(u, p["wq"]), H, hd)
    k = split_heads(torch.matmul(u, p["wk"]), H, hd) / hd ** 0.5
    v = split_heads(torch.matmul(u, p["wv"]), H, hd)
    gif = grad_placed_as_input(torch.matmul(u, p["wif"])).float()
    i_g = torch.sigmoid(gif[..., :H])
    f_g = torch.sigmoid(gif[..., H:] + 2.0)
    return q, k, v, i_g, f_g, z


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 128) -> torch.Tensor:
    """On DTensors the chunked recurrence runs per (batch, head) on each
    rank's shard (:func:`common.per_shard`: over the model axis by heads
    or by (batch, head) pairs), its merged output placed for ``down``'s
    row-parallel product before the gate and the norm."""
    q, k, v, i_g, f_g, z = _mlstm_proj(p, x, cfg)
    if is_dtensor(q):
        y = per_shard(lambda *t: _mlstm_heads(
            *t[:3], t[3][..., 0], t[4][..., 0], chunk), q, q, k, v,
            i_g[..., None], f_g[..., None])
        y = row_input(merge_heads(y), p["down"])
    else:
        y = merge_heads(_mlstm_heads(q, k, v, i_g, f_g, chunk))
    y = y.to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["down"])


def _mlstm_heads(q, k, v, i_g, f_g, chunk: int) -> torch.Tensor:
    """The mLSTM's chunked recurrence, each (batch, head) on its own:
    q, k, v ``(B, S, H, hd)``, the gates ``(B, S, H)`` -> ``(B, S, H,
    hd)`` float32."""
    B, S, H, hd = q.shape
    Q = min(chunk, S)
    pad = -S % Q

    def chunks(a):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B, a.shape[1] // Q, Q) + a.shape[2:])
    qc, kc, vc = (chunks(t).float() for t in (q, k, v))
    ic, fc = chunks(i_g), chunks(f_g)
    nc = qc.shape[1]
    Sp = nc * Q

    logf = torch.log(torch.clamp_min(fc, 1e-6))
    cum = batch_local(lambda t: torch.cumsum(t, dim=2), logf)  # (B,nc,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = _masked_exp(seg, Q)              # masked before the exp, as SSD's
    qk = torch.einsum("bcqhd,bcshd->bcqsh", qc, kc)
    scores = qk * L * ic[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshd->bcqhd", scores, vc)

    dec_out = torch.exp(cum[:, :, -1:, :] - cum)           # (B,nc,Q,H)
    sc = torch.einsum("bcsh,bcshd,bcshe->bchde", ic * dec_out, kc, vc)
    cdec = torch.exp(cum[:, :, -1, :])

    state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                        device=q.device)
    states = []
    for c in loop("xlstm.mlstm_chunks", nc):
        states.append(state)
        state = state * cdec[:, c, :, None, None] + sc[:, c]
    states = torch.stack(states, dim=1)                    # (B,nc,H,hd,hd)
    y_inter = torch.einsum("bcqhd,bcqh,bchde->bcqhe", qc, torch.exp(cum),
                           states)
    return (y_intra + y_inter).reshape(B, Sp, H, hd)[:, :S]


def init_mlstm_cache(cfg: ModelConfig, batch: int, layers: int,
                     device=None) -> torch.Tensor:
    _, H, hd = mlstm_dims(cfg)
    return torch.zeros((layers, batch, H, hd, hd), dtype=torch.float32,
                       device=device)


def mlstm_decode(p: dict, x: torch.Tensor, state: torch.Tensor,
                 cfg: ModelConfig):
    """x: (B, 1, D); state: (B, H, hd, hd).  Returns ``(out, new state)``;
    the state given is not written."""
    B = x.shape[0]
    d_inner, H, hd = mlstm_dims(cfg)
    q, k, v, i_g, f_g, z = _mlstm_proj(p, x, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))
    i_g, f_g = i_g[:, 0], f_g[:, 0]
    state = state * f_g[..., None, None] + torch.einsum(
        "bh,bhd,bhe->bhde", i_g, k, v)
    y = torch.einsum("bhd,bhde->bhe", q, state)
    y = y.reshape(B, 1, d_inner).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["down"]), state


# ---------------------------------------------------------------------------
# sLSTM


def slstm_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape)
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    return {
        "wx": ParamSpec(prefix_shape + (D, 4 * D), ax + ("embed", "mlp"),
                        cfg.dtype),
        "rh": ParamSpec(prefix_shape + (H, hd, 4 * hd),
                        ax + (None, None, None), cfg.dtype),
        "norm": ParamSpec(prefix_shape + (D,), ax + (None,), cfg.dtype,
                          scale=1.0),
        "down": ParamSpec(prefix_shape + (D, cfg.d_model),
                          ax + ("mlp", "embed"), cfg.dtype),
    }


def _slstm_cell(g: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                dtype: torch.dtype):
    """One sLSTM step from its gate pre-activations g (B, H, 4 hd): the
    new (h in ``dtype``, c, n)."""
    gi, gf, gz, go = torch.chunk(g.float(), 4, dim=-1)
    i_t = torch.exp(torch.clamp_max(gi, 8.0))
    f_t = torch.sigmoid(gf)
    z_t = torch.tanh(gz)
    o_t = torch.sigmoid(go)
    c = f_t * c + i_t * z_t
    n = f_t * n + i_t
    h = (o_t * c / torch.clamp_min(torch.abs(n), 1.0)).to(dtype)
    return h, c, n


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The recurrent sLSTM over the sequence, a loop over time.  On
    DTensors the loop runs on each rank's local batch rows
    (:func:`batch_local`: the gate pre-activations' columns gathered once,
    the recurrent weight whole on every rank), so each step is a few
    local ops, not DTensor dispatches."""
    H = cfg.num_heads
    hd = x.shape[-1] // H
    gx = split_heads(torch.matmul(x, p["wx"]), H, 4 * hd)
    hs = batch_local(functools.partial(_slstm_steps, dtype=x.dtype), gx,
                     p["rh"])
    y = merge_heads(hs)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["down"])


def _slstm_steps(gx: torch.Tensor, rh: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The sLSTM's time loop from the gate pre-activations ``gx (B, S, H,
    4 hd)`` and the recurrent weight ``rh (H, hd, 4 hd)``: every step's
    ``h`` stacked, (B, S, H, hd) in ``dtype``."""
    B, S, H = gx.shape[:3]
    hd = rh.shape[1]
    h = torch.zeros((B, H, hd), dtype=dtype, device=gx.device)
    c = torch.zeros((B, H, hd), dtype=torch.float32, device=gx.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=gx.device)
    hs = []
    for t in loop("xlstm.slstm_steps", S):
        g = gx[:, t] + torch.einsum("bhd,hdk->bhk", h, rh)
        h, c, n = _slstm_cell(g, c, n, dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def init_slstm_cache(cfg: ModelConfig, batch: int, layers: int,
                     device=None) -> dict:
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {
        "h": torch.zeros((layers, batch, H, hd), dtype=cfg.dtype,
                         device=device),
        "c": torch.zeros((layers, batch, H, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((layers, batch, H, hd), dtype=torch.float32,
                         device=device),
    }


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, D); cache: {'h', 'c', 'n'} of one layer.  Returns ``(out,
    new cache)``; the cache given is not written."""
    B = x.shape[0]
    H = cfg.num_heads
    hd = cfg.d_model // H
    g_t = split_heads(torch.matmul(x, p["wx"])[:, 0], H, 4 * hd)
    g = g_t + torch.einsum("bhd,hdk->bhk", cache["h"], p["rh"])
    h, c, n = _slstm_cell(g, cache["c"], cache["n"], x.dtype)
    y = rms_norm(h.reshape(B, 1, -1), p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["down"]), {"h": h, "c": c, "n": n}
