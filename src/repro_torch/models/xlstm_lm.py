"""xLSTM language model, PyTorch port of ``repro/models/xlstm_lm.py``:
an interleaved mLSTM / sLSTM block stack.

Every ``slstm_every``-th block is an sLSTM and the rest are mLSTM: groups
of ``slstm_every - 1`` mLSTM blocks and one sLSTM, then a tail of
``num_layers % slstm_every`` mLSTM blocks.  Fully recurrent, so the decode
ignores ``pos``; it writes the recurrent state in place and returns the
cache.  No kernel runs on this path (the reference has none for it).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.oracles.chain import resolve_device
from . import xlstm
from .common import (ModelConfig, ParamSpec, cache_at, cache_write,
                     layer_input, layer_loop, remat_wrap, residual_add,
                     unstack)
from .layers import cross_entropy, embed_specs, embed_tokens, lm_logits, \
    rms_norm
from .transformer import _layer


def _groups(cfg: ModelConfig):
    k = cfg.slstm_every
    n_groups = cfg.num_layers // k
    tail = cfg.num_layers - n_groups * k
    return n_groups, k, tail


def param_specs(cfg: ModelConfig) -> dict:
    n_groups, k, tail = _groups(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["m_norm"] = ParamSpec((n_groups, k - 1, cfg.d_model),
                            ("layers", None, None), cfg.dtype, scale=1.0)
    s["mlstm"] = xlstm.mlstm_specs(cfg, prefix_shape=(n_groups, k - 1))
    s["s_norm"] = ParamSpec((n_groups, cfg.d_model), ("layers", None),
                            cfg.dtype, scale=1.0)
    s["slstm"] = xlstm.slstm_specs(cfg, prefix_shape=(n_groups,))
    if tail:
        s["tail_norm"] = ParamSpec((tail, cfg.d_model), ("layers", None),
                                   cfg.dtype, scale=1.0)
        s["mlstm_tail"] = xlstm.mlstm_specs(cfg, prefix_shape=(tail,))
    s["final_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype,
                                scale=1.0)
    return s


def _forward(params: dict, cfg: ModelConfig, x: torch.Tensor):
    n_groups, k, tail = _groups(cfg)
    eps = cfg.norm_eps

    m_layers, m_norms = (unstack(params[n], 2) for n in ("mlstm", "m_norm"))
    s_layers, s_norms = (unstack(params[n]) for n in ("slstm", "s_norm"))
    if tail:
        t_layers, t_norms = (unstack(params[n])
                             for n in ("mlstm_tail", "tail_norm"))

    def mlstm(x, lp, nrm):
        x = layer_input(x)
        return residual_add(x, xlstm.mlstm_forward(
            lp, rms_norm(x, nrm, eps), cfg))

    def group(x, g):
        for l in layer_loop("xlstm.group_layers", k - 1):
            i = g * (k - 1) + l
            x = mlstm(x, _layer(m_layers, i), m_norms[i])
        x = layer_input(x)
        return residual_add(x, xlstm.slstm_forward(
            _layer(s_layers, g), rms_norm(x, s_norms[g], eps), cfg))

    group = remat_wrap(cfg, group)    # the groups, not the tail
    for g in layer_loop("xlstm.groups", n_groups):
        x = group(x, g)
    for t in layer_loop("xlstm.tail", tail):
        x = mlstm(x, _layer(t_layers, t), t_norms[t])
    return rms_norm(layer_input(x), params["final_norm"], eps)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = embed_tokens(params, batch["tokens"], cfg)
    logits = lm_logits(params, _forward(params, cfg, x), cfg)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = embed_tokens(params, batch["tokens"], cfg)
    h = _forward(params, cfg, x)
    return lm_logits(params, h[:, -1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """The reference's cache tree, zeroed on ``device`` (CUDA by default):
    the mLSTM states ``(n_groups, k - 1, B, H, hd, hd)``, the sLSTM's
    ``h``, ``c``, ``n`` ``(n_groups, B, H, hd)`` and the tail's mLSTM
    states (None without a tail).  ``seq`` is unused: the state does not
    grow."""
    dev = resolve_device(device)
    n_groups, k, tail = _groups(cfg)
    mc = xlstm.init_mlstm_cache(cfg, batch, n_groups * (k - 1), dev)
    return {
        "mlstm": mc.reshape((n_groups, k - 1) + mc.shape[1:]),
        "slstm": xlstm.init_slstm_cache(cfg, batch, n_groups, dev),
        "mlstm_tail": (xlstm.init_mlstm_cache(cfg, batch, tail, dev)
                       if tail else None),
    }


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1); ``pos`` is unused (recurrent).  Returns (logits (B,
    1, V), cache), the states written in place."""
    del pos
    x = embed_tokens(params, tokens, cfg)
    n_groups, k, tail = _groups(cfg)
    eps = cfg.norm_eps

    def mlstm_step(x, lp, nrm, state):
        out, new = xlstm.mlstm_decode(lp, rms_norm(x, nrm, eps), state, cfg)
        cache_write(state, new)
        return residual_add(x, out)

    for g in layer_loop("xlstm.decode.groups", n_groups):
        for l in layer_loop("xlstm.decode.group_layers", k - 1):
            x = mlstm_step(x, _layer(params["mlstm"], (g, l)),
                           params["m_norm"][g, l],
                           cache_at(cache["mlstm"], g, l))
        sc = {name: cache_at(t, g) for name, t in cache["slstm"].items()}
        out, new = xlstm.slstm_decode(
            _layer(params["slstm"], g),
            rms_norm(x, params["s_norm"][g], eps), sc, cfg)
        for name, t in sc.items():
            cache_write(t, new[name])
        x = residual_add(x, out)
    for t in layer_loop("xlstm.decode.tail", tail):
        x = mlstm_step(x, _layer(params["mlstm_tail"], t),
                       params["tail_norm"][t],
                       cache_at(cache["mlstm_tail"], t))
    h = rms_norm(x, params["final_norm"], eps)
    return lm_logits(params, h[:, -1:], cfg), cache
