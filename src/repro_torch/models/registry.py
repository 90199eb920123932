"""Family registry: dispatches the model entry points by ``cfg.family``
(PyTorch port of ``repro/models/registry.py``): ``dense``, ``moe`` and
``vlm`` to the transformer, ``hybrid`` to zamba2's Mamba2 + shared
attention, ``ssm`` to the xLSTM stack, ``audio`` to the encoder-decoder."""
from __future__ import annotations

import numpy as np
import torch

from . import encdec, hybrid, transformer, xlstm_lm
from .common import ModelConfig

_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "hybrid": hybrid,
    "ssm": xlstm_lm,
    "audio": encdec,
}


def module_for(cfg: ModelConfig):
    return _MODULES[cfg.family]


def param_specs(cfg: ModelConfig):
    return module_for(cfg).param_specs(cfg)


def loss_fn(params, cfg: ModelConfig, batch):
    return module_for(cfg).loss_fn(params, cfg, batch)


def prefill(params, cfg: ModelConfig, batch):
    return module_for(cfg).prefill(params, cfg, batch)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    return module_for(cfg).decode_step(params, cfg, cache, tokens, pos)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None):
    return module_for(cfg).init_cache(cfg, batch, seq, device)


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, rng) -> dict:
    """A random batch, ``{"tokens", "labels"}`` (B, S) int32 CPU tensors,
    labels equal to tokens, and for a VLM ``vision_embeds`` (B,
    vision_tokens, D) float32, for the audio family ``frames`` (B,
    encoder_seq, D) float32, drawn after the tokens: the reference's
    draws from ``numpy.random.RandomState(rng)``."""
    r = np.random.RandomState(rng)
    tokens = torch.from_numpy(
        r.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.from_numpy(
            r.randn(batch, cfg.vision_tokens, cfg.d_model)
            .astype(np.float32))
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(
            r.randn(batch, cfg.encoder_seq, cfg.d_model).astype(np.float32))
    return out
