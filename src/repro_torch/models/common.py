"""Shared model plumbing: the config and parameter specs, PyTorch port.

A copy of ``repro/models/common.py``'s :class:`ModelConfig` and
:class:`ParamSpec`, with ``dtype`` a ``torch.dtype``.  Parameters are a
nested dict of tensors with the reference's tree and shapes: layers stay
*stacked* with a leading L axis, so a reference parameter tree converts
one to one (:mod:`repro_torch.convert`), and the layer loops index ``l``.

Left out: the mesh and sharding rules (ROADMAP §A item 8), ``remat_wrap``
and the scan probe; a port on one card needs none of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..core.oracles.chain import resolve_device


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False               # multi-token-prediction auxiliary head
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0             # zamba2: shared attn block period
    # --- xLSTM ---
    xlstm: bool = False
    slstm_every: int = 4            # every k-th block is sLSTM
    # --- enc-dec (whisper) ---
    encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0            # audio frame count from the stub frontend
    # --- VLM ---
    vision_tokens: int = 0          # patch embeddings prepended (stub)
    # --- attention ---
    sliding_window: int = 0
    subquadratic: bool = False      # can run the long_500k cell
    attn_chunk: int = 1024          # q-chunk of the plain chunked attention
    attn_score_dtype: str = "f32"
    attn_impl: str = "chunked"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def param_count(self) -> int:
        from . import registry
        return int(sum(math.prod(s.shape)
                       for s in leaves(registry.param_specs(self))))


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == ndim)
    dtype: Any = torch.bfloat16
    scale: float = 0.02              # init stddev (0 => zeros, 1.0 => ones)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaves(tree) -> list:
    """The leaves of a nested dict, keys in sorted order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(specs, generator: torch.Generator, device=None) -> dict:
    """Tensors for a tree of specs, by the reference's rule
    (``repro/models/common.py:133``): zeros for scale 0, ones for a 1-D
    scale-1 spec, else ``normal * scale`` drawn in float32 and cast.

    ``device`` defaults to CUDA; ``generator`` must live on it.  The draws
    come from ``generator`` in the reference's leaf order, so one seed gives
    one set of weights (not the reference's: a torch generator cannot
    reproduce ``jax.random``)."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"parameters on {dev}")

    def make(s: ParamSpec) -> torch.Tensor:
        if s.scale == 0.0:
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.scale == 1.0 and len(s.shape) <= 1:
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(s.scale).to(s.dtype)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return make(tree)

    return build(specs)
