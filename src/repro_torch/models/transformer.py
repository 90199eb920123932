"""Decoder-only transformer LM (dense and MoE), PyTorch port of
``repro/models/transformer.py``.

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

Multi-token prediction and the vision stub are not ported (ROADMAP §A
item 8); a config that asks for either raises.  The reference runs each
block under ``jax.checkpoint``; that changes memory, not values, and the
port keeps a block's activations for the backward.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.oracles.chain import resolve_device
from . import attention as attn
from . import moe as moe_mod
from .common import ModelConfig, ParamSpec
from .layers import cross_entropy, embed_specs, embed_tokens, lm_logits, \
    mlp_specs, rms_norm, swiglu


def _not_ported(cfg: ModelConfig) -> None:
    for name in ("mtp", "vision_tokens"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet "
                                      "(ROADMAP §A item 8)")


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
    _not_ported(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    for name, kind, n in _layer_groups(cfg):
        s[name] = _block_specs(cfg, kind, n)
    s["final_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype,
                                scale=1.0)
    return s


def _layer(tree, l: int):
    """Layer ``l``'s parameters: views of the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _ffn(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor):
    if kind == "moe":
        return moe_mod.moe_forward(p["moe"], h, cfg)
    return swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])


def _block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], h, positions, cfg)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, kind, p, h)


def backbone(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Final hidden states; differentiable (callers that extract features
    run it under ``torch.no_grad()``)."""
    for name, kind, n in _layer_groups(cfg):
        for l in range(n):
            x = _block(cfg, kind, _layer(params[name], l), x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict):
    _not_ported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean-token cross entropy of ``batch`` (``tokens``, ``labels`` (B, S)
    int, optional ``mask``): the logits at positions 0..S-2 against the
    labels at 1..S-1, as the reference shifts them."""
    x, positions = _embed_inputs(params, cfg, batch)
    h = backbone(params, cfg, x, positions)
    logits = lm_logits(params, h, cfg)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         batch.get("mask", None))


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence forward; logits of the last position only."""
    x, positions = _embed_inputs(params, cfg, batch)
    h = backbone(params, cfg, x, positions)
    return lm_logits(params, h[:, -1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """Zeroed KV caches per layer group, on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    return {name: attn.init_gqa_cache(cfg, batch, seq, n, dev)
            for name, _, n in _layer_groups(cfg)}


def _decode_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  cache, pos: int):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, kind, p, h), cache


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1); pos: a host int.  Returns (logits (B, 1, V), cache),
    the cache written in place at ``pos``."""
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    for name, kind, n in _layer_groups(cfg):
        ck, cv = cache[name]
        for l in range(n):
            x, _ = _decode_block(cfg, kind, _layer(params[name], l), x,
                                 (ck[l], cv[l]), pos)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg), cache
