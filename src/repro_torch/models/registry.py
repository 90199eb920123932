"""Family registry: dispatches the model entry points by ``cfg.family``
(PyTorch port of ``repro/models/registry.py``).  The ``dense`` and ``moe``
families are ported; the others raise, naming ROADMAP A13."""
from __future__ import annotations

from . import transformer
from .common import ModelConfig

_MODULES = {"dense": transformer, "moe": transformer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _MODULES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  "ported yet (ROADMAP A13)")
    return _MODULES[cfg.family]


def param_specs(cfg: ModelConfig):
    return module_for(cfg).param_specs(cfg)


def prefill(params, cfg: ModelConfig, batch):
    return module_for(cfg).prefill(params, cfg, batch)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    return module_for(cfg).decode_step(params, cfg, cache, tokens, pos)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None):
    return module_for(cfg).init_cache(cfg, batch, seq, device)
