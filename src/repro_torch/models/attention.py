"""Grouped-query attention (GQA), PyTorch port of the GQA half of
``repro/models/attention.py``.

Prefill (``gqa_forward``) on a CUDA tensor runs the hand-written causal
flash-attention kernel (:func:`repro_torch.kernels.ops.flash_attention`,
which reads the grouped kv heads in place); on a CPU tensor it runs
:func:`chunked_causal_attention`, the function the JAX model computes.
Decode (``gqa_decode``) takes a one-token query against a preallocated KV
cache, which it updates in place.  The MLA half (deepseek-v3) is not
ported yet (ROADMAP §A item 8).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops as kops
from ..kernels.ref import INVALID_SCORE
from .common import ModelConfig, ParamSpec
from .layers import apply_rope


def _no_mla(cfg: ModelConfig) -> None:
    if cfg.mla:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP §A item 8)")


def attn_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    _no_mla(cfg)
    ax = ("layers",) * len(prefix_shape)
    hd = cfg.hd
    s = {
        "wq": ParamSpec(prefix_shape + (cfg.d_model, cfg.num_heads * hd),
                        ax + ("embed", "heads"), cfg.dtype),
        "wk": ParamSpec(prefix_shape + (cfg.d_model, cfg.num_kv_heads * hd),
                        ax + ("embed", "kv"), cfg.dtype),
        "wv": ParamSpec(prefix_shape + (cfg.d_model, cfg.num_kv_heads * hd),
                        ax + ("embed", "kv"), cfg.dtype),
        "wo": ParamSpec(prefix_shape + (cfg.num_heads * hd, cfg.d_model),
                        ax + ("heads", "embed"), cfg.dtype),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(prefix_shape + (cfg.num_heads * hd,),
                            ax + ("heads",), cfg.dtype, scale=0.0)
        s["bk"] = ParamSpec(prefix_shape + (cfg.num_kv_heads * hd,),
                            ax + ("kv",), cfg.dtype, scale=0.0)
        s["bv"] = ParamSpec(prefix_shape + (cfg.num_kv_heads * hd,),
                            ax + ("kv",), cfg.dtype, scale=0.0)
    return s


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, chunk: int,
                             sliding_window: int = 0,
                             score_dtype: str = "f32") -> torch.Tensor:
    """q, k, v: (B, S, H, hd), kv already repeated to H heads.

    A loop over S/chunk query blocks; each block sees keys [0, block_end)
    (optionally windowed), so peak score memory is (B, H, chunk, S).
    ``score_dtype='bf16'`` keeps the score slab in bf16 through the
    softmax, as the reference's perf knob."""
    B, S, H, hd = q.shape
    sdt = torch.bfloat16 if score_dtype == "bf16" else torch.float32
    # Filled on the device: a tensor built from a host value would be a
    # blocking upload in the training backward, which recomputes this.
    scale = torch.full((), hd ** -0.5, dtype=sdt, device=q.device)
    chunk = min(chunk, S)
    kT = k.permute(0, 2, 3, 1).to(sdt)       # (B, H, hd, S)
    vT = v.permute(0, 2, 1, 3).to(sdt)       # (B, H, S, vd)
    col = torch.arange(S, device=q.device)
    outs = []
    for start in range(0, S, chunk):
        qb = q[:, start:start + chunk]        # (B, c, H, hd)
        row = torch.arange(start, start + qb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bhdk->bhqk", qb.to(sdt), kT) * scale
        mask = row[:, None] >= col[None, :]
        if sliding_window > 0:
            mask &= col[None, :] > row[:, None] - sliding_window
        s = s.masked_fill(~mask, INVALID_SCORE)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bqhd", p, vT).to(q.dtype))
    return torch.cat(outs, dim=1)


def repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    K = x.shape[2]
    if K == num_heads:
        return x
    return x.repeat_interleave(num_heads // K, dim=2)


def _kernel_config(cfg: ModelConfig) -> None:
    """Raise for a config the flash-attention kernel does not compute."""
    unsupported = [f"{name}={val!r}" for name, val, ok in (
        ("sliding_window", cfg.sliding_window, cfg.sliding_window == 0),
        ("attn_score_dtype", cfg.attn_score_dtype,
         cfg.attn_score_dtype == "f32"),
        ("attn_impl", cfg.attn_impl, cfg.attn_impl == "chunked")) if not ok]
    if unsupported:
        raise NotImplementedError(
            f"the CUDA flash-attention path does not compute "
            f"{', '.join(unsupported)} (ROADMAP §A item 8)")


def _qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.hd
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, cfg.num_heads, hd), positions,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, cfg.num_kv_heads, hd), positions,
                   cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.num_kv_heads, hd)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    if x.device.type == "cuda":
        _kernel_config(cfg)
        o = kops.flash_attention(q, k, v)
    else:
        k = repeat_kv(k, cfg.num_heads)
        v = repeat_kv(v, cfg.num_heads)
        if cfg.attn_impl == "stub":
            o = v + 0.0 * q  # ablation probe: projections kept, no S^2 slab
        else:
            o = chunked_causal_attention(q, k, v, cfg.attn_chunk,
                                         cfg.sliding_window,
                                         score_dtype=cfg.attn_score_dtype)
    return torch.matmul(o.reshape(B, S, -1), p["wo"])


def gqa_decode(p: dict, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: int,
               cfg: ModelConfig):
    """x: (B, 1, D); cache: (k, v) each (B, Smax, K, hd), written in place
    at ``pos``; pos: a host int."""
    B = x.shape[0]
    hd = cfg.hd
    ck, cv = cache
    Smax = ck.shape[1]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, posv, cfg)
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    kk = repeat_kv(ck, cfg.num_heads)
    vv = repeat_kv(cv, cfg.num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * hd ** -0.5
    idx = torch.arange(Smax, device=x.device)
    valid = idx <= pos
    if cfg.sliding_window > 0:
        valid &= idx > pos - cfg.sliding_window
    s = s.masked_fill(~valid, INVALID_SCORE)
    pw = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pw, vv.float())
    o = o.to(x.dtype).reshape(B, 1, -1)
    return torch.matmul(o, p["wo"]), (ck, cv)


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, layers: int,
                   device=None):
    shape = (layers, batch, seq, cfg.num_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
