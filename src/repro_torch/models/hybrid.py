"""Zamba2-style hybrid, PyTorch port of ``repro/models/hybrid.py``: a
Mamba2 backbone and one *shared* attention block applied after every
``attn_every`` Mamba2 layers (its parameters reused at each invocation,
each invocation with a KV cache of its own).

The layers run in groups of ``attn_every`` Mamba2 layers, each group
followed by the shared block; the ``num_layers % attn_every`` trailing
layers run as a tail without attention (zamba2-7b: 81 = 13 x 6 + 3).  The
shared block's attention is ``attention.gqa_forward``: on a CUDA tensor
the flash kernel, its window build under ``cfg.sliding_window`` (the
long-context override).  Entry points as ``transformer``'s; the decode
writes the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.oracles.chain import resolve_device
from . import attention as attn
from . import ssm
from .common import (ModelConfig, ParamSpec, cache_at, cache_write,
                     gather_fsdp, layer_input, layer_loop, remat_wrap,
                     residual_add, unstack)
from .layers import (cross_entropy, embed_specs, embed_tokens, lm_logits,
                     mlp_specs, rms_norm, swiglu)
from .transformer import _layer


def _groups(cfg: ModelConfig):
    k = cfg.attn_every
    n_groups = cfg.num_layers // k
    tail = cfg.num_layers - n_groups * k
    return n_groups, k, tail


def param_specs(cfg: ModelConfig) -> dict:
    n_groups, k, tail = _groups(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["mamba_groups"] = ssm.ssm_specs(cfg, prefix_shape=(n_groups, k))
    if tail:
        s["mamba_tail"] = ssm.ssm_specs(cfg, prefix_shape=(tail,))
    s["shared_attn"] = {
        "ln1": ParamSpec((cfg.d_model,), (None,), cfg.dtype, scale=1.0),
        "attn": attn.attn_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), (None,), cfg.dtype, scale=1.0),
        "mlp": mlp_specs(cfg),
    }
    s["norm_in"] = ParamSpec((cfg.num_layers, cfg.d_model),
                             ("layers", None), cfg.dtype, scale=1.0)
    s["final_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype,
                                scale=1.0)
    return s


def _shared_attn(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = residual_add(x, attn.gqa_forward(p["attn"], h, positions, cfg))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return residual_add(x, swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                                  p["mlp"]["down"]))


def _forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    x = embed_tokens(params, tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    n_groups, k, tail = _groups(cfg)

    groups = unstack(params["mamba_groups"], 2)
    tail_layers = unstack(params["mamba_tail"]) if tail else ()
    norms = unstack(params["norm_in"])

    def mamba(x, lp, nrm):
        x = layer_input(x)
        return residual_add(x, ssm.ssd_forward(
            lp, rms_norm(x, nrm, cfg.norm_eps), cfg))

    def group(x, g):
        for l in layer_loop("hybrid.group_layers", k):
            x = mamba(x, _layer(groups, g * k + l), norms[g * k + l])
        return _shared_attn(cfg, gather_fsdp(params["shared_attn"]),
                            layer_input(x), positions)

    group = remat_wrap(cfg, group)    # the groups, not the tail
    for g in layer_loop("hybrid.groups", n_groups):
        x = group(x, g)
    for t in layer_loop("hybrid.tail", tail):
        x = mamba(x, _layer(tail_layers, t), norms[n_groups * k + t])
    return rms_norm(layer_input(x), params["final_norm"], cfg.norm_eps)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    h = _forward(params, cfg, batch["tokens"])
    logits = lm_logits(params, h, cfg)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    h = _forward(params, cfg, batch["tokens"])
    return lm_logits(params, h[:, -1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """The reference's cache tree, zeroed on ``device`` (CUDA by default):
    the groups' SSM caches ``(n_groups, k, ...)``, the tail's (None
    without a tail), and one KV cache per shared-block invocation,
    ``attn_k``/``attn_v`` of shape ``(n_groups, B, seq, K, hd)``."""
    dev = resolve_device(device)
    n_groups, k, tail = _groups(cfg)
    kv_shape = (n_groups, batch, seq, cfg.num_kv_heads, cfg.hd)
    groups = ssm.init_ssm_cache(cfg, batch, n_groups * k, dev)
    return {
        "ssm_groups": {name: t.reshape((n_groups, k) + t.shape[1:])
                       for name, t in groups.items()},
        "ssm_tail": (ssm.init_ssm_cache(cfg, batch, tail, dev) if tail
                     else None),
        "attn_k": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
        "attn_v": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
    }


def _ssd_step(cfg: ModelConfig, lp: dict, nrm: torch.Tensor,
              x: torch.Tensor, cache: dict, idx) -> torch.Tensor:
    """One Mamba2 layer's decode, its cache entry ``idx`` written in
    place."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    layer_cache = {name: cache_at(t, *idx) for name, t in cache.items()}
    out, new = ssm.ssd_decode(lp, rms_norm(x, nrm, cfg.norm_eps),
                              layer_cache, cfg)
    for name, t in layer_cache.items():
        cache_write(t, new[name])
    return residual_add(x, out)


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1); pos: a host int.  Returns (logits (B, 1, V), cache),
    the cache written in place."""
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    n_groups, k, tail = _groups(cfg)
    p = gather_fsdp(params["shared_attn"])
    for g in layer_loop("hybrid.decode.groups", n_groups):
        for l in layer_loop("hybrid.decode.group_layers", k):
            x = _ssd_step(cfg, _layer(params["mamba_groups"], (g, l)),
                          params["norm_in"][g * k + l], x,
                          cache["ssm_groups"], (g, l))
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = attn.gqa_decode(p["attn"], h, (cache_at(cache["attn_k"], g),
                                              cache_at(cache["attn_v"], g)),
                               pos, cfg)
        x = residual_add(x, a)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = residual_add(x, swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                                   p["mlp"]["down"]))
    for t in layer_loop("hybrid.decode.tail", tail):
        x = _ssd_step(cfg, _layer(params["mamba_tail"], t),
                      params["norm_in"][n_groups * k + t], x,
                      cache["ssm_tail"], t)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg), cache
