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
from .common import (ModelConfig, ParamSpec, is_dtensor, layer_input,
                     local_call, local_fn, local_region, placed_like)
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
    return route_logits(torch.matmul(xf.float(), p["router"]), cfg)


def route_logits(logits: torch.Tensor, cfg: ModelConfig):
    """:func:`route` from the router's logits ``(T, E)``, float32."""
    T, E = logits.shape
    # token-choice top-k gate, normalized over the chosen experts
    topv, topi = top_k(logits, cfg.experts_per_token)     # (T, k)
    gates = torch.zeros((T, E), dtype=torch.float32, device=logits.device)
    gates.scatter_(1, topi, torch.softmax(topv, dim=-1))  # (T, E)
    # expert-choice: each expert takes its top-C tokens by gate score
    return top_k(gates.T, capacity(cfg, T))


def _combine(idx: torch.Tensor, src: torch.Tensor, T: int) -> torch.Tensor:
    """The experts' weighted rows summed back into their tokens' rows."""
    out = torch.zeros((T, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, idx, src)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  On DTensors, :func:`_sharded_experts`:
    a partial sum over the model axis, which the caller reduces as it
    joins the residual stream."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    if is_dtensor(xf):
        out = _sharded_experts(p, xf, cfg)
    else:
        ev, ei = route(p, xf, cfg)                         # (E, C)
        keep = ev > 0.0                                    # dropped slots
        xs = xf.index_select(0, ei.reshape(-1)).view(*ei.shape, D)
        y = kops.moe_ffn(xs, p["w_gate"], p["w_up"], p["w_down"])
        w = (ev * keep).to(y.dtype)[..., None]             # (E, C, 1)
        out = _combine(ei.reshape(-1), (y * w).reshape(-1, D), B * S)
    if cfg.num_shared_experts:
        sh = p["shared"]
        out = out + swiglu(xf, sh["gate"], sh["up"], sh["down"])
    return out.reshape(B, S, D).to(x.dtype)


def _sharded_experts(p: dict, xf: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The routed experts on DTensor tokens ``xf (T, D)`` (their rows over
    the batch axes): each rank runs its local experts on its batch
    share of their capacity rows, and the tokens never gather whole.

      * routing: the router's logits on the local rows, all-gathered
        (``(T, E)`` float32, the only whole-T tensor) and routed on every
        rank as the unsharded run routes, so the global capacity order,
        choices and drops are the unsharded ones;
      * dispatch: each rank writes the rows of its own tokens into its
        experts' ``(E_local, C, D)`` slots, zero elsewhere, and the
        partial sums are reduce-scattered over the batch axes along C;
      * the expert FFN (:func:`kernels.ops.moe_ffn`) on ``(E_local,
        C / batch ways, D)``;
      * combine: the weighted rows all-gathered along C over the batch
        axes, each rank summing its own tokens' rows: a partial sum over
        the model axis (each rank's experts).

    Dispatch and combine are one another's transposes, so their
    backwards are the same two collectives the other way round."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    xf = layer_input(xf)
    mesh = xf.device_mesh
    T, D = xf.shape
    wg = p["w_gate"]
    tok = [q.is_shard() for q in xf.placements]         # batch axes
    exp = ([q.is_shard() and q.dim == 0 for q in wg.placements]
           if is_dtensor(wg) else [False] * mesh.ndim)     # expert axes
    (T_l, _), (t0, _) = local_region((T, D), mesh, xf.placements)
    E = cfg.num_experts
    eplc = [Shard(0) if e else Replicate() for e in exp]
    (E_l, _), (e0, _) = local_region((E, D), mesh, eplc)

    logits = torch.matmul(xf.float(), p["router"])       # (T, E)
    ev, ei = local_call(lambda lg: route_logits(lg, cfg), logits, n_out=2)
    C = ev.shape[1]

    def own(ids):
        """This rank's experts' slots: local token rows, and which are
        this rank's tokens."""
        e = ids[e0:e0 + E_l]
        mine = (e >= t0) & (e < t0 + T_l)
        return (e - t0).clamp(0, max(T_l - 1, 0)), mine

    def dispatch(xl, ids):
        rows, mine = own(ids)
        xs = xl.index_select(0, rows.reshape(-1)).view(E_l, C, D)
        return xs.masked_fill(~mine[..., None], 0)

    def combine(yl, ids):
        rows, mine = own(ids)
        src = yl.masked_fill(~mine[..., None], 0).reshape(-1, D)
        return _combine(rows.reshape(-1), src, T_l)

    rep = [Replicate()] * mesh.ndim
    xplc = list(xf.placements)
    # (E, C, D) slots summed over the batch axes (each rank's tokens)
    slots = [Partial() if t else q for t, q in zip(tok, eplc)]
    xgrad = [Partial() if e else q for e, q in zip(exp, xplc)]
    xs = local_map(local_fn(dispatch), out_placements=slots,
                   in_placements=(xplc, rep),
                   in_grad_placements=(xgrad, rep),
                   device_mesh=mesh)(xf, ei)              # (E, C, D)
    rows = [Shard(1) if t else q for t, q in zip(tok, eplc)]
    y = kops.moe_ffn(xs.redistribute(mesh, rows), wg, p["w_up"],
                     p["w_down"])                         # rows sharded
    keep = ev > 0.0
    w = placed_like((ev * keep).to(y.dtype)[..., None], y)
    out = [Partial() if e else q for e, q in zip(exp, xplc)]
    return local_map(local_fn(combine), out_placements=out,
                     in_placements=(eplc, rep),
                     in_grad_placements=(slots, rep),
                     device_mesh=mesh)((y * w).redistribute(mesh, eplc), ei)
