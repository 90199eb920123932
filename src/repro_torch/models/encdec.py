"""Whisper-style encoder-decoder backbone, PyTorch port of
``repro/models/encdec.py`` (the audio frontend stubbed: ``batch["frames"]``
holds precomputed frame embeddings (B, encoder_seq, d_model)).

A bidirectional encoder over the frames and a causal decoder with
cross-attention.  On a CUDA tensor the encoder's attention runs the flash
kernel's bidirectional build and the decoder's self-attention its causal
build (``attention.gqa_forward``); on a CPU tensor both run the plain
attention the reference computes.  The cross-attention and the decode's
one-token cross step stay plain torch, as the reference computes them
outside any kernel (their query and key lengths differ).  The decode
attends to the cross-attention cache of ``init_cache``, which is zero and
which ``prefill`` never fills, as in the reference (ROADMAP notes the
quirk).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.oracles.chain import resolve_device
from ..kernels import ops as kops
from . import attention as attn
from .common import (ModelConfig, ParamSpec, cache_at, layer_input,
                     layer_loop, merge_heads, remat_wrap, residual_add,
                     row_input, split_heads, unstack)
from .layers import (cross_entropy, embed_specs, embed_tokens, lm_logits,
                     mlp_specs, rms_norm, swiglu)
from .transformer import _layer


def _xattn_specs(cfg: ModelConfig, pre=()) -> dict:
    ax = ("layers",) * len(pre)
    hd = cfg.hd
    return {
        "wq": ParamSpec(pre + (cfg.d_model, cfg.num_heads * hd),
                        ax + ("embed", "heads"), cfg.dtype),
        "wk": ParamSpec(pre + (cfg.d_model, cfg.num_heads * hd),
                        ax + ("embed", "heads"), cfg.dtype),
        "wv": ParamSpec(pre + (cfg.d_model, cfg.num_heads * hd),
                        ax + ("embed", "heads"), cfg.dtype),
        "wo": ParamSpec(pre + (cfg.num_heads * hd, cfg.d_model),
                        ax + ("heads", "embed"), cfg.dtype),
    }


def param_specs(cfg: ModelConfig) -> dict:
    enc_n, dec_n = cfg.encoder_layers, cfg.num_layers
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["enc_layers"] = {
        "ln1": ParamSpec((enc_n, cfg.d_model), ("layers", None), cfg.dtype,
                         scale=1.0),
        "attn": attn.attn_specs(cfg, (enc_n,)),
        "ln2": ParamSpec((enc_n, cfg.d_model), ("layers", None), cfg.dtype,
                         scale=1.0),
        "mlp": mlp_specs(cfg, prefix_shape=(enc_n,)),
    }
    s["dec_layers"] = {
        "ln1": ParamSpec((dec_n, cfg.d_model), ("layers", None), cfg.dtype,
                         scale=1.0),
        "self_attn": attn.attn_specs(cfg, (dec_n,)),
        "lnx": ParamSpec((dec_n, cfg.d_model), ("layers", None), cfg.dtype,
                         scale=1.0),
        "cross_attn": _xattn_specs(cfg, (dec_n,)),
        "ln2": ParamSpec((dec_n, cfg.d_model), ("layers", None), cfg.dtype,
                         scale=1.0),
        "mlp": mlp_specs(cfg, prefix_shape=(dec_n,)),
    }
    s["enc_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype, scale=1.0)
    s["final_norm"] = ParamSpec((cfg.d_model,), (None,), cfg.dtype,
                                scale=1.0)
    return s


def _heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, n hd) -> (B, S, n, hd)."""
    return split_heads(t, t.shape[-1] // hd, hd)


def _bidir_attention(p: dict, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Full bidirectional attention (the encoder's): the flash kernel's
    bidirectional build on a CUDA tensor (kv heads read in place), the
    plain float32 softmax on a CPU tensor."""
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = (_heads(torch.matmul(x, p[w]), hd) for w in ("wq", "wk", "wv"))
    if x.device.type == "cuda":
        o = kops.flash_attention(q, k, v, causal=False)
    else:
        o = attn.bidirectional_attention(q, attn.repeat_kv(k, cfg.num_heads),
                                         attn.repeat_kv(v, cfg.num_heads))
    return torch.matmul(row_input(merge_heads(o), p["wo"]), p["wo"])


def _cross_attention(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    hd = cfg.hd
    q = _heads(torch.matmul(x, p["wq"]), hd)
    k = _heads(torch.matmul(enc_out, p["wk"]), hd)
    v = _heads(torch.matmul(enc_out, p["wv"]), hd)
    o = attn.bidirectional_attention(q, k, v)
    return torch.matmul(row_input(merge_heads(o), p["wo"]), p["wo"])


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    x = frames.to(cfg.dtype)
    eps = cfg.norm_eps
    layers = unstack(params["enc_layers"])
    for l in layer_loop("encdec.encoder", cfg.encoder_layers):
        lp = _layer(layers, l)
        x = layer_input(x)
        x = residual_add(x, _bidir_attention(
            lp["attn"], rms_norm(x, lp["ln1"], eps), cfg))
        m = lp["mlp"]
        x = residual_add(x, swiglu(rms_norm(x, lp["ln2"], eps), m["gate"],
                                   m["up"], m["down"]))
    return rms_norm(layer_input(x), params["enc_norm"], eps)


def _decoder(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, enc_out: torch.Tensor):
    eps = cfg.norm_eps

    def body(lp, x):
        x = layer_input(x)
        x = residual_add(x, attn.gqa_forward(
            lp["self_attn"], rms_norm(x, lp["ln1"], eps), positions, cfg))
        x = residual_add(x, _cross_attention(
            lp["cross_attn"], rms_norm(x, lp["lnx"], eps), enc_out, cfg))
        m = lp["mlp"]
        return residual_add(x, swiglu(rms_norm(x, lp["ln2"], eps),
                                      m["gate"], m["up"], m["down"]))

    body = remat_wrap(cfg, body)      # the decoder's layers, as the reference
    layers = unstack(params["dec_layers"])
    for l in layer_loop("encdec.decoder", cfg.num_layers):
        x = body(_layer(layers, l), x)
    return rms_norm(layer_input(x), params["final_norm"], eps)


def _hidden(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    enc_out = encode(params, cfg, batch["frames"])
    x = embed_tokens(params, batch["tokens"], cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return _decoder(params, cfg, x, positions, enc_out)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean-token cross entropy of ``batch`` (``frames``, ``tokens``,
    ``labels``)."""
    logits = lm_logits(params, _hidden(params, cfg, batch), cfg)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    h = _hidden(params, cfg, batch)
    return lm_logits(params, h[:, -1:], cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """Zeroed on ``device`` (CUDA by default): the decoder's self-attention
    ``(k, v)`` and the cross-attention's ``cross_k``/``cross_v`` ``(L, B,
    encoder_seq, H, hd)``, as the reference's (which nothing fills)."""
    dev = resolve_device(device)
    n, hd = cfg.num_layers, cfg.hd
    shape = (n, batch, cfg.encoder_seq, cfg.num_heads, hd)
    return {
        "self": attn.init_gqa_cache(cfg, batch, seq, n, dev),
        "cross_k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "cross_v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1); pos: a host int.  Returns (logits (B, 1, V), cache),
    the self-attention cache written in place at ``pos``."""
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    B, eps = x.shape[0], cfg.norm_eps
    ck, cv = cache["self"]
    # The cross-attention's k and v come from the cache: its wk and wv
    # are left out of each layer's weights, so no rank gathers them.
    dec = params["dec_layers"]
    dec = dict(dec, cross_attn={k: dec["cross_attn"][k] for k in ("wq",
                                                                 "wo")})
    for l in layer_loop("encdec.decode", cfg.num_layers):
        lp = _layer(dec, l)
        a, _ = attn.gqa_decode(lp["self_attn"], rms_norm(x, lp["ln1"], eps),
                               (cache_at(ck, l), cache_at(cv, l)), pos, cfg)
        x = residual_add(x, a)
        h = rms_norm(x, lp["lnx"], eps)
        q = _heads(torch.matmul(h, lp["cross_attn"]["wq"]), cfg.hd)
        o = attn.bidirectional_attention(q, cache_at(cache["cross_k"], l),
                                         cache_at(cache["cross_v"], l))
        x = residual_add(x, torch.matmul(o.reshape(B, 1, -1),
                                         lp["cross_attn"]["wo"]))
        m = lp["mlp"]
        x = residual_add(x, swiglu(rms_norm(x, lp["ln2"], eps), m["gate"],
                                   m["up"], m["down"]))
    h = rms_norm(x, params["final_norm"], eps)
    return lm_logits(params, h, cfg), cache
