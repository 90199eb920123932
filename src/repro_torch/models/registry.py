"""Family registry: dispatches the model entry points by ``cfg.family``
(PyTorch port of ``repro/models/registry.py``): ``dense``, ``moe`` and
``vlm`` to the transformer, ``hybrid`` to zamba2's Mamba2 + shared
attention, ``ssm`` to the xLSTM stack, ``audio`` to the encoder-decoder.

The entry points take plain or DTensor parameters (``common
.shard_params``).  With DTensors they run under DTensor's
``implicit_replication``: the plain tensors the models make (positions,
masks, rope tables, scales; the same on every rank) count as replicated.
``train_input_specs`` / ``decode_input_specs`` give the dry-run's inputs
as tensors that hold no data (``meta``, or fake under a
``FakeTensorMode``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from . import encdec, hybrid, transformer, xlstm_lm
from .common import ModelConfig, is_dtensor, leaves

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


def sharded(params):
    """DTensor's ``implicit_replication`` when ``params`` hold DTensors
    and it is not on already (it does not nest: its exit turns it off),
    else nothing."""
    if any(is_dtensor(t) for t in leaves(params)):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        if not DTensor._op_dispatcher._allow_implicit_replication:
            return implicit_replication()
    return contextlib.nullcontext()


def loss_fn(params, cfg: ModelConfig, batch):
    with sharded(params):
        return module_for(cfg).loss_fn(params, cfg, batch)


def prefill(params, cfg: ModelConfig, batch):
    with sharded(params):
        return module_for(cfg).prefill(params, cfg, batch)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    with sharded(params):
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


# ---------------------------------------------------------------------------
# Input specs (tensors that hold no data)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int,
                      device="meta") -> Dict[str, Any]:
    """The reference's train/prefill inputs as empty tensors on
    ``device`` (``meta``; fake CPU tensors under a ``FakeTensorMode`` with
    ``device="cpu"``): ``tokens``, ``labels`` (B, S) int32, a VLM's
    ``vision_embeds``, the audio family's ``frames`` (float32)."""
    tok = torch.empty((batch, seq), dtype=torch.int32, device=device)
    specs = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        specs["vision_embeds"] = torch.empty(
            (batch, cfg.vision_tokens, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.family == "audio":
        specs["frames"] = torch.empty(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
            device=device)
    return specs


def decode_input_specs(cfg: ModelConfig, batch: int, seq: int,
                       device="meta"):
    """(tokens (B, 1) int32, pos () int32, the cache of a seq-long
    context) for one serve step, as empty tensors on ``device``."""
    cache = init_cache(cfg, batch, seq, device)
    tokens = torch.empty((batch, 1), dtype=torch.int32, device=device)
    pos = torch.empty((), dtype=torch.int32, device=device)
    return tokens, pos, cache
