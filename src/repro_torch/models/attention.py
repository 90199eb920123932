"""Attention: grouped-query (GQA) and multi-head latent (MLA,
deepseek-v3), PyTorch port of ``repro/models/attention.py``.

Prefill (``gqa_forward``, ``mla_forward``) on a CUDA tensor runs the
hand-written flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, which reads grouped kv
heads in place and takes a value head dim of its own: MLA's q/k heads are
``qk_nope_dim + qk_rope_dim`` wide, its v heads ``v_head_dim``), its
window build under ``cfg.sliding_window``, its bf16-score builds under
``cfg.attn_score_dtype = "bf16"``; on a CPU tensor it runs
:func:`chunked_causal_attention`, the function the JAX model computes.
:func:`bidirectional_attention` is the encoder's unmasked attention
(``repro/models/encdec.py::_bidir_attention``'s), which the kernel's
bidirectional build computes on the card.  Decode takes a one-token query against a preallocated
cache, which it updates in place: GQA's holds k and v, MLA's the
compressed ``(c_kv, k_rope)`` stream, which the absorbed decode scores
against directly.  ``attn_impl="stub"`` is the reference's ablation
probe (the value plus zero times the query, no attention) on either
device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops as kops
from ..kernels.ref import INVALID_SCORE
from ..launch.trace_analysis import loop
from .common import (ModelConfig, ParamSpec, cache_write, is_dtensor,
                     merge_heads, per_shard, replicate_dims, row_input,
                     split_heads)
from .layers import apply_rope, rms_norm


def attn_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape)
    if cfg.mla:
        qk_hd = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wq_a": ParamSpec(prefix_shape + (cfg.d_model, cfg.q_lora_rank),
                              ax + ("embed", None), cfg.dtype),
            "q_norm": ParamSpec(prefix_shape + (cfg.q_lora_rank,),
                                ax + (None,), cfg.dtype, scale=1.0),
            "wq_b": ParamSpec(
                prefix_shape + (cfg.q_lora_rank, cfg.num_heads * qk_hd),
                ax + (None, "heads"), cfg.dtype),
            "wkv_a": ParamSpec(
                prefix_shape + (cfg.d_model,
                                cfg.kv_lora_rank + cfg.qk_rope_dim),
                ax + ("embed", None), cfg.dtype),
            "kv_norm": ParamSpec(prefix_shape + (cfg.kv_lora_rank,),
                                 ax + (None,), cfg.dtype, scale=1.0),
            "wkv_b": ParamSpec(
                prefix_shape + (cfg.kv_lora_rank,
                                cfg.num_heads * (cfg.qk_nope_dim
                                                 + cfg.v_head_dim)),
                ax + (None, "heads"), cfg.dtype),
            "wo": ParamSpec(
                prefix_shape + (cfg.num_heads * cfg.v_head_dim, cfg.d_model),
                ax + ("heads", "embed"), cfg.dtype),
        }
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
    """q, k: (B, S, H, hd), v: (B, S, H, vd), kv already repeated to H
    heads (MLA: vd differs from hd; the scale is hd's).

    A loop over S/chunk query blocks; each block sees keys [0, block_end)
    (optionally windowed), so peak score memory is (B, H, chunk, S).
    ``score_dtype='bf16'`` keeps the score slab in bf16 through the
    softmax, as the reference's perf knob."""
    if is_dtensor(q):       # each (batch, head) alone: on the local shards
        return per_shard(lambda *t: chunked_causal_attention(
            *t, chunk, sliding_window, score_dtype), q, q, k, v)
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
    for ci in loop("attention.q_chunks", -(-S // chunk)):
        start = ci * chunk
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


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Unmasked softmax attention in float32 (the reference's encoder and
    cross-attention): q (B, S, H, hd) over k, v (B, T, H, hd), kv already
    repeated to H heads, T free; the output in q's dtype."""
    if is_dtensor(q):       # each (batch, head) alone: on the local shards
        return per_shard(bidirectional_attention, q, q, k, v)
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    pw = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pw, v.float()).to(q.dtype)


def repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    K = x.shape[2]
    if K == num_heads:
        return x
    return x.repeat_interleave(num_heads // K, dim=2)


def _kernel_config(cfg: ModelConfig) -> None:
    """Raise for a config the flash-attention kernel does not compute:
    an ``attn_impl`` other than the chunked attention (the stub is taken
    before), a score dtype other than ``"f32"`` or ``"bf16"``."""
    if cfg.attn_impl != "chunked" or cfg.attn_score_dtype not in (
            "f32", "bf16"):
        raise NotImplementedError(
            f"the CUDA flash-attention path does not compute attn_impl="
            f"{cfg.attn_impl!r}, attn_score_dtype={cfg.attn_score_dtype!r}")


def _qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.hd
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(split_heads(q, cfg.num_heads, hd), positions,
                   cfg.rope_theta)
    k = apply_rope(split_heads(k, cfg.num_kv_heads, hd), positions,
                   cfg.rope_theta)
    return q, k, split_heads(v, cfg.num_kv_heads, hd)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    if cfg.attn_impl == "stub":
        # ablation probe: projections kept, no S^2 slab
        o = repeat_kv(v, cfg.num_heads) + 0.0 * q
    elif x.device.type == "cuda":
        _kernel_config(cfg)
        o = kops.flash_attention(q, k, v, window=cfg.sliding_window,
                                 score_dtype=cfg.attn_score_dtype)
    else:
        o = chunked_causal_attention(q, repeat_kv(k, cfg.num_heads),
                                     repeat_kv(v, cfg.num_heads),
                                     cfg.attn_chunk, cfg.sliding_window,
                                     score_dtype=cfg.attn_score_dtype)
    return torch.matmul(row_input(merge_heads(o), p["wo"]), p["wo"])


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
    cache_write(ck, k[:, 0].to(ck.dtype), 1, pos)
    cache_write(cv, v[:, 0].to(cv.dtype), 1, pos)
    kk = repeat_kv(ck, cfg.num_heads)
    vv = repeat_kv(cv, cfg.num_heads)
    # DTensors: the query's heads whole (the cache's sequence holds the
    # model axis), so the softmax's partials reduce over the sequence.
    q = replicate_dims(q, 2)
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


def _mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Project to q (nope + rope heads) and the compressed kv stream:
    ``(q (B, S, H, nope + rope), c_kv (B, S, kv_lora_rank), k_rope (B, S,
    rope))``, k_rope before its rotation."""
    B, S, _ = x.shape
    qk_hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    ql = rms_norm(torch.matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = split_heads(torch.matmul(ql, p["wq_b"]), cfg.num_heads, qk_hd)
    kv = torch.matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    return q, c_kv, kv[..., cfg.kv_lora_rank:]


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """MLA prefill: the kv stream expanded per head through ``wkv_b``,
    then causal attention over q = [q_nope ; q_rope], k = [k_nope ;
    k_rope] (one rope key shared by all heads) and v, at q's head dim's
    scale.  On a CUDA tensor the flash kernel's MLA build computes it, v
    read in place as a view of the expansion."""
    B, S, _ = x.shape
    H, nope, rope = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q, c_kv, k_rope = _mla_qkv(p, x, cfg)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                    # (B, S, 1, rope)
    kv = split_heads(torch.matmul(c_kv, p["wkv_b"]), H,
                     nope + cfg.v_head_dim)
    v = kv[..., nope:]
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rope)], dim=-1)
    qq = torch.cat([q[..., :nope], q_rope], dim=-1)
    if cfg.attn_impl == "stub":
        o = v + 0.0 * qq.sum(dim=-1, keepdim=True)
    elif x.device.type == "cuda":
        _kernel_config(cfg)
        o = kops.flash_attention(qq, k, v, score_dtype=cfg.attn_score_dtype)
    else:
        o = chunked_causal_attention(qq, k, v, cfg.attn_chunk,
                                     score_dtype=cfg.attn_score_dtype)
    return torch.matmul(row_input(merge_heads(o), p["wo"]), p["wo"])


def mla_decode(p: dict, x: torch.Tensor, cache, pos: int,
               cfg: ModelConfig):
    """Absorbed MLA decode.  x: (B, 1, D); cache: ``(c_kv (B, Smax,
    kv_lora_rank), k_rope (B, Smax, rope))``, written in place at
    ``pos``, a host int.

    q_nope is absorbed through ``wkv_b``'s key half, so the scores are
    taken against the compressed cache directly; the value path
    re-expands after the softmax.  A token costs kv_lora_rank + rope
    cache entries, not 2 H hd."""
    B = x.shape[0]
    H, nope = cfg.num_heads, cfg.qk_nope_dim
    cc, cr = cache
    Smax = cc.shape[1]
    q, c_kv, k_rope = _mla_qkv(p, x, cfg)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q[..., nope:], posv, cfg.rope_theta)  # (B,1,H,r)
    k_rope = apply_rope(k_rope[:, :, None, :], posv, cfg.rope_theta)
    cache_write(cc, c_kv[:, 0].to(cc.dtype), 1, pos)
    cache_write(cr, k_rope[:, 0, 0].to(cr.dtype), 1, pos)
    kvb = p["wkv_b"].reshape(cfg.kv_lora_rank, H, nope + cfg.v_head_dim)
    # Absorb: q_eff[b, h, r] = sum_k q_nope[b, h, k] kvb_k[r, h, k]
    q_eff = torch.einsum("bqhk,rhk->bqhr", q[..., :nope], kvb[..., :nope])
    s = (torch.einsum("bqhr,bkr->bhqk", q_eff.float(), cc.float())
         + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), cr.float()))
    s = s * (nope + cfg.qk_rope_dim) ** -0.5
    valid = torch.arange(Smax, device=x.device) <= pos
    s = s.masked_fill(~valid, INVALID_SCORE)
    pw = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhqk,bkr->bqhr", pw, cc.float())
    o = torch.einsum("bqhr,rhk->bqhk", o_c.to(x.dtype), kvb[..., nope:])
    return torch.matmul(o.reshape(B, 1, -1), p["wo"]), (cc, cr)


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, layers: int,
                   device=None):
    shape = (layers, batch, seq, cfg.num_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, layers: int,
                   device=None):
    return (torch.zeros((layers, batch, seq, cfg.kv_lora_rank),
                        dtype=cfg.dtype, device=device),
            torch.zeros((layers, batch, seq, cfg.qk_rope_dim),
                        dtype=cfg.dtype, device=device))
