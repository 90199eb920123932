"""SSVM-head training: a chain-CRF head trained with MP-BCFW on the token
features of a frozen LM backbone (PyTorch port of
``repro/trainer/ssvm_head.py``).

The backbone forward is the expensive feature extractor, run once; the
SSVM objective is convex in the head weights given those features, and the
max-oracle is loss-augmented Viterbi over the tag space.

:func:`build_problem` also builds the paper's three scenarios (multiclass,
chain, graph) from the synthetic data, for the trainer's ``--trainer
ssvm`` mode and the benchmarks.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..api.oracle import build_problem as build_from_spec
from ..core.oracles import chain
from ..core.oracles.chain import ChainSpec, resolve_device, to_device
from ..core.oracles.graph import GraphSpec
from ..core.oracles.multiclass import MulticlassSpec
from ..core.types import SSVMProblem
from ..data import synthetic
from ..models import registry


def scenario_spec_and_data(sc, device: Optional[Any] = None):
    """``(OracleSpec, data)`` for one of the paper's scenarios (a
    :class:`repro_torch.configs.paper.SSVMScenario`): the reference's
    synthetic arrays as tensors on ``device`` (CUDA by default), the
    declarative form :func:`repro_torch.api.build_problem` takes."""
    dev = resolve_device(device)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    if sc.kind == "multiclass":
        x, y = synthetic.usps_like(n=sc.n, f=sc.f,
                                   num_classes=sc.num_classes)
        return MulticlassSpec(sc.num_classes), {
            "x": to_device(x, f32, dev), "y": to_device(y, i32, dev)}
    if sc.kind == "chain":
        X, Y, M = synthetic.ocr_like(n=sc.n, f=sc.f,
                                     num_labels=sc.num_classes,
                                     mean_len=sc.mean_len,
                                     max_len=sc.max_len)
        return ChainSpec(sc.num_classes), {
            "x": to_device(X, f32, dev), "y": to_device(Y, i32, dev),
            "mask": to_device(M, b, dev)}
    if sc.kind == "graph":
        Xg, Yg, Mg, Eg, EMg, Cg = synthetic.horseseg_like(
            n=sc.n, grid=sc.grid, f=sc.f)
        return GraphSpec(num_sweeps=sc.oracle_sweeps), {
            "x": to_device(Xg, f32, dev), "y": to_device(Yg, i32, dev),
            "mask": to_device(Mg, b, dev), "edges": to_device(Eg, i32, dev),
            "edge_mask": to_device(EMg, b, dev),
            "color": to_device(Cg, i32, dev)}
    raise ValueError(sc.kind)


def build_problem(sc, device: Optional[Any] = None) -> SSVMProblem:
    """One of the paper's scenarios as a problem on ``device`` (CUDA by
    default)."""
    spec, data = scenario_spec_and_data(sc, device)
    return build_from_spec(spec, data)


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
    with torch.no_grad():
        x, positions = model._embed_inputs(params, cfg, {"tokens": tokens})
        feats = model.backbone(params, cfg, x, positions)
    del x
    if feature_dim is not None and feature_dim < feats.shape[-1]:
        feats = feats[..., :feature_dim]
    return chain.make_problem(feats.float(), tags, mask, num_tags,
                              device=where)
