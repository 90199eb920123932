"""Decoder-only transformer LM (dense, MoE, MLA, VLM backbone), PyTorch
port of ``repro/models/transformer.py``.

Layers stay stacked (leading L axis, as the reference's parameter tree)
and run in a Python loop over ``l``; a layer's parameters are views of
the stacked tensors.  Entry points:

  * ``param_specs(cfg)``                       tree of ParamSpec
  * ``loss_fn(params, cfg, batch)``            mean-token CE (training;
    autograd differentiates it, the kernels included)
  * ``backbone(params, cfg, x, positions)``    final hidden states
  * ``prefill(params, cfg, batch)``            last-position logits
  * ``init_cache(cfg, batch, seq, device)``
  * ``decode_step(params, cfg, cache, tokens, pos)``  one-token step; the
    cache is updated in place and returned

MoE models may lead with dense layers (deepseek-v3: two layer groups).
``cfg.mtp`` adds the multi-token-prediction block to the loss;
``cfg.vision_tokens`` replaces the first positions' embeddings by the
projected patch embeddings ``batch["vision_embeds"]`` (the VLM stub).  In
training each block runs under ``cfg.remat_policy`` (``torch.utils
.checkpoint``, as the reference's ``jax.checkpoint``): memory, not values.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from ..core.oracles.chain import resolve_device
from . import attention as attn
from . import moe as moe_mod
from .common import (ModelConfig, ParamSpec, cache_at, gather_fsdp,
                     layer_input, layer_loop, remat_half, remat_wrap,
                     residual_add, unstack)
from .layers import cross_entropy, embed_specs, embed_tokens, lm_logits, \
    mlp_specs, rms_norm, swiglu


def _block_specs(cfg: ModelConfig, kind: str, n_layers: int) -> dict:
    pre = (n_layers,)
    s = {
        "ln1": ParamSpec(pre + (cfg.d_model,), ("layers", None), cfg.dtype,
                         scale=1.0),
        "ln2": ParamSpec(pre + (cfg.d_model,), ("layers", None), cfg.dtype,
                         scale=1.0),
        "attn": attn.attn_specs(cfg, pre),
    }
    if kind == "moe":
        s["moe"] = moe_mod.moe_specs(cfg, pre)
    else:
        s["mlp"] = mlp_specs(cfg, prefix_shape=pre)
    return s


def _layer_groups(cfg: ModelConfig):
    """[(name, kind, n_layers)]; MoE models may lead with dense layers."""
    if cfg.moe:
        groups = []
        if cfg.first_dense_layers:
            groups.append(("dense_layers", "dense", cfg.first_dense_layers))
        groups.append(("moe_layers", "moe",
                       cfg.num_layers - cfg.first_dense_layers))
        return groups
    return [("layers", "dense", cfg.num_layers)]


def param_specs(cfg: ModelConfig) -> dict:
    s: Dict[str, Any] = dict(embed_specs(cfg))
    for name, kind, n in _layer_groups(cfg):
        s[name] = _block_specs(cfg, kind, n)
    s["final_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype,
                                scale=1.0)
    if cfg.vision_tokens:
        # stub frontend: a single projection from precomputed patch embeds
        s["vision_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                     ("embed", None), cfg.dtype)
    if cfg.mtp:
        s["mtp"] = {**_block_specs(cfg, "dense", 1),
                    "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                      ("embed", None), cfg.dtype)}
    return s


def _layer(tree, l: int):
    """Layer ``l``'s parameters: views of the stacked tensors; DTensor
    ones with their FSDP shards all-gathered (:func:`common.gather_fsdp`),
    at the layer's start, as FSDP does."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return gather_fsdp(tree[l])


def _ffn(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor):
    if kind == "moe":
        return moe_mod.moe_forward(p["moe"], h, cfg)
    return swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])


def _attn_half(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    forward = attn.mla_forward if cfg.mla else attn.gqa_forward
    return forward(p["attn"], h, positions, cfg)


def _ffn_half(cfg: ModelConfig, kind: str, p: dict,
              x: torch.Tensor) -> torch.Tensor:
    return _ffn(cfg, kind, p, rms_norm(x, p["ln2"], cfg.norm_eps))


def _block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
           positions: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """One block; with ``remat``, under ``remat_policy="selective"`` each
    half checkpointed on its own (its output, the reference's
    ``attn_out`` / ``ffn_out``, is what the backward keeps).  Each half's
    output joins the stream reduced (:func:`common.residual_add`)."""
    half = (lambda fn: remat_half(cfg, fn)) if remat else (lambda fn: fn)
    x = residual_add(x, half(_attn_half)(cfg, p, x, positions))
    return residual_add(x, half(_ffn_half)(cfg, kind, p, x))


def backbone(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Final hidden states; differentiable (callers that extract features
    run it under ``torch.no_grad()``).  In training each block runs under
    ``cfg.remat_policy`` (:func:`common.remat_wrap`)."""
    for name, kind, n in _layer_groups(cfg):
        body = remat_wrap(cfg, functools.partial(_block, cfg, kind,
                                                 remat=True), halves=True)
        layers = unstack(params[name])
        for l in layer_loop(f"transformer.{name}", n):
            x = body(_layer(layers, l), layer_input(x), positions)
    return rms_norm(layer_input(x), params["final_norm"], cfg.norm_eps)


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict):
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.vision_tokens:
        ve = torch.matmul(batch["vision_embeds"].float(),
                          gather_fsdp(params["vision_proj"]).float()
                          ).to(x.dtype)
        x = torch.cat([ve, x[:, cfg.vision_tokens:]], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean-token cross entropy of ``batch`` (``tokens``, ``labels`` (B, S)
    int, optional ``mask``; ``vision_embeds`` (B, P, D) for the VLM stub):
    the logits at positions 0..S-2 against the labels at 1..S-1, as the
    reference shifts them.  With ``cfg.mtp``, plus 0.3 x the
    multi-token-prediction block's loss: one dense block on ``[h_t ;
    emb(labels_t)] @ proj`` predicts the labels two ahead (deepseek-v3's
    single MTP module)."""
    x, positions = _embed_inputs(params, cfg, batch)
    h = backbone(params, cfg, x, positions)
    logits = lm_logits(params, h, cfg)
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         batch.get("mask", None))
    if cfg.mtp:
        emb_next = embed_tokens(params, batch["labels"], cfg)
        h2_in = torch.matmul(torch.cat([h, emb_next], dim=-1),
                             gather_fsdp(params["mtp"]["proj"]))
        block = _layer({k: v for k, v in params["mtp"].items()
                        if k != "proj"}, 0)
        h2 = _block(cfg, "dense", block, h2_in, positions)
        logits2 = lm_logits(params, h2, cfg)
        loss = loss + 0.3 * cross_entropy(logits2[:, :-2],
                                          batch["labels"][:, 2:])
    return loss


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence forward; logits of the last position only."""
    x, positions = _embed_inputs(params, cfg, batch)
    h = backbone(params, cfg, x, positions)
    return lm_logits(params, h[:, -1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """Zeroed caches per layer group, on ``device`` (CUDA by default):
    ``(k, v)`` for GQA, the compressed ``(c_kv, k_rope)`` for MLA."""
    dev = resolve_device(device)
    make = attn.init_mla_cache if cfg.mla else attn.init_gqa_cache
    return {name: make(cfg, batch, seq, n, dev)
            for name, _, n in _layer_groups(cfg)}


def _decode_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  cache, pos: int):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    decode = attn.mla_decode if cfg.mla else attn.gqa_decode
    a, cache = decode(p["attn"], h, cache, pos, cfg)
    x = residual_add(x, a)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return residual_add(x, _ffn(cfg, kind, p, h)), cache


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1); pos: a host int.  Returns (logits (B, 1, V), cache),
    the cache written in place at ``pos``."""
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    for name, kind, n in _layer_groups(cfg):
        c0, c1 = cache[name]
        for l in layer_loop(f"transformer.decode.{name}", n):
            x, _ = _decode_block(cfg, kind, _layer(params[name], l), x,
                                 (cache_at(c0, l), cache_at(c1, l)), pos)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg), cache
