"""SSVM-head training: a chain-CRF head trained with MP-BCFW on the token
features of a frozen LM backbone (PyTorch port of
``repro/trainer/ssvm_head.py::backbone_chain_problem``).

The backbone forward is the expensive feature extractor, run once; the
SSVM objective is convex in the head weights given those features, and the
max-oracle is loss-augmented Viterbi over the tag space.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.oracles import chain
from ..core.oracles.chain import resolve_device
from ..core.types import SSVMProblem
from ..models import registry


def tagging_task(vocab_size: int, n: int, L: int, tags: int = 5,
                 seed: int = 0):
    """The synthetic tagging task of ``examples/ssvm_head.py``: tokens
    drawn uniformly by ``numpy.random.RandomState(seed)``, gold tag =
    token id mod ``tags``, every position valid.  Returns ``(tokens (n, L)
    int32, tags (n, L) int32, mask (n, L) bool)`` as numpy arrays."""
    tokens = np.random.RandomState(seed).randint(0, vocab_size, (n, L))
    tokens = tokens.astype(np.int32)
    return tokens, (tokens % tags).astype(np.int32), np.ones((n, L), bool)


def backbone_chain_problem(cfg, params: dict, tokens, tags, mask,
                           num_tags: int, feature_dim: Optional[int] = None,
                           device: Optional[Any] = None) -> SSVMProblem:
    """Chain SSVM over backbone token features.

    tokens, tags: (n, L) int; mask: (n, L) bool, as numpy arrays or
    tensors.  ``params`` must already live on ``device`` (CUDA by
    default).  The features are the backbone's final hidden states,
    computed in one forward over all n sequences, as the reference's jitted
    ``features``: MoE capacity is taken over the whole batch, so a split
    batch would drop other tokens.  They go to
    :func:`repro_torch.core.oracles.chain.make_problem` in float32,
    cut to the first ``feature_dim`` dims if given.
    """
    dev = resolve_device(device)
    where = params["embedding"].device
    if where.type != dev.type:
        raise ValueError(f"backbone_chain_problem: parameters on {where}, "
                         f"device {dev}")
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    tokens = tokens.to(device=where, dtype=torch.int64)
    model = registry.module_for(cfg)
    x, positions = model._embed_inputs(params, cfg, {"tokens": tokens})
    feats = model.backbone(params, cfg, x, positions)
    del x
    if feature_dim is not None and feature_dim < feats.shape[-1]:
        feats = feats[..., :feature_dim]
    return chain.make_problem(feats.float(), tags, mask, num_tags,
                              device=where)
