"""Mixture-of-Experts layer with capacity-based routing, PyTorch port of
``repro/models/moe.py``.

Routing is expert-choice over the token-choice gate: each token's top-k
experts define the gate weights (softmax over the selected experts), and
each expert then takes its top-C tokens by gate score with
``C = max(1, int(T * k * capacity_factor) // E)``.  Dropped slots fall
through to the residual path.  The expert FFN runs through
:func:`repro_torch.kernels.ops.moe_ffn`: the hand-written kernel on a CUDA
tensor, the reference's einsums on a CPU tensor.

Both top-k selections keep ``jax.lax.top_k``'s order: among equal values
the lower index comes first (a stable descending sort), so tokens with
equal gates (two sequences that share a first token) are kept and dropped
as in the reference.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .common import ModelConfig, ParamSpec, local_call, placed_like
from .layers import mlp_specs, swiglu


def moe_specs(cfg: ModelConfig, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    s = {
        "router": ParamSpec(prefix_shape + (D, E), ax + ("embed", None),
                            torch.float32),
        "w_gate": ParamSpec(prefix_shape + (E, D, F),
                            ax + ("experts", "embed", "mlp"), cfg.dtype),
        "w_up": ParamSpec(prefix_shape + (E, D, F),
                          ax + ("experts", "embed", "mlp"), cfg.dtype),
        "w_down": ParamSpec(prefix_shape + (E, F, D),
                            ax + ("experts", "mlp", "embed"), cfg.dtype),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(
            cfg, d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
            prefix_shape=prefix_shape)
    return s


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, T: int) -> int:
    return max(1, int(T * cfg.experts_per_token * cfg.capacity_factor)
               // cfg.num_experts)


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """Expert-choice routing of ``xf (T, D)``: ``(ev, ei)``, each expert's
    top-C gate values and token ids, ``(E, C)``; ``ev == 0`` marks a
    dropped slot."""
    T, E = xf.shape[0], cfg.num_experts
    logits = torch.matmul(xf.float(), p["router"])
    # token-choice top-k gate, normalized over the chosen experts
    topv, topi = top_k(logits, cfg.experts_per_token)     # (T, k)
    gates = torch.zeros((T, E), dtype=torch.float32, device=xf.device)
    gates.scatter_(1, topi, torch.softmax(topv, dim=-1))  # (T, E)
    # expert-choice: each expert takes its top-C tokens by gate score
    return top_k(gates.T, capacity(cfg, T))


def _combine(idx: torch.Tensor, src: torch.Tensor, T: int) -> torch.Tensor:
    """The experts' weighted rows summed back into their tokens' rows."""
    out = torch.zeros((T, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, idx, src)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  On DTensors the routing and the combine
    run on every rank's replicated copy of the tokens (``local_call``), the
    expert FFN expert-parallel over the experts' shards."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    ev, ei = local_call(lambda r, t: route({"router": r}, t, cfg),
                        p["router"], xf, n_out=2)          # (E, C)
    keep = ev > 0.0                                        # dropped slots
    xs = local_call(lambda t, i: t.index_select(0, i.reshape(-1)).view(
        *i.shape, D), xf, ei)                              # (E, C, D)
    y = kops.moe_ffn(xs, p["w_gate"], p["w_up"], p["w_down"])
    w = (ev * keep).to(y.dtype)[..., None]                 # (E, C, 1)
    out = local_call(lambda i, t: _combine(i, t, B * S), ei.reshape(-1),
                     (y * w).reshape(-1, D))
    if cfg.num_shared_experts:
        sh = p["shared"]
        out = out + swiglu(xf, sh["gate"], sh["up"], sh["down"])
    # DTensors: back to the tokens' placements before the batch unflattens.
    return placed_like(out, xf).reshape(B, S, D).to(x.dtype)
