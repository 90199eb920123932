"""AdamW with a configurable state dtype, PyTorch port of
``repro/optim/adamw.py``.

The reference's formula, step for step: the gradient clipped by its
float32 global norm, bias correction from the step counter, the decoupled
weight decay added to the step, and each update computed in float32 and
cast back to the parameter's dtype; the moments are kept in
``state_dtype``.  ``torch.optim.AdamW`` differs on two counts: its moments
take the parameter's dtype (bfloat16 here), and it applies the decay to
the parameter before the step.

Parameters, gradients and moments are nested dicts of tensors with one
tree (the port's parameter layout); the update is functional and returns
new tensors.  The step counter is a host int, so nothing here reads the
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from ..models.common import leaves


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32   # bf16 for the giant configs


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def tree_zip(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure, the first
    tree's keys; a new tree of the results."""
    if isinstance(trees[0], dict):
        return {k: tree_zip(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return AdamWState(step=0, m=tree_zip(zeros, params),
                      v=tree_zip(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over the leaves, summed leaf by
    leaf in the reference's order; a () device tensor."""
    total = 0
    for g in leaves(tree):
        g = g.float()
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr: Optional[Any] = None):
    """Returns ``(new_params, new_state, stats)``; ``stats["grad_norm"]``
    is the float32 global norm before clipping, a () device tensor.
    ``lr`` (a float or a float32 () tensor, e.g. a CPU one from
    :func:`repro_torch.optim.cosine_schedule`) defaults to ``cfg.lr``."""
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                             1.0)
             if cfg.grad_clip > 0 else 1.0)
    t = torch.tensor(step, dtype=torch.float32)
    bc1 = 1.0 - cfg.b1 ** t          # float32 () CPU tensors, as the
    bc2 = 1.0 - cfg.b2 ** t          # reference's from its step counter

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        newp = (p.float() - lr_t * delta).to(p.dtype)
        return newp, m32.to(cfg.state_dtype), v32.to(cfg.state_dtype)

    with torch.no_grad():
        out = tree_zip(upd, params, grads, state.m, state.v)
    newp, newm, newv = (tree_zip(lambda o, i=i: o[i], out)
                        for i in range(3))
    return newp, AdamWState(step=step, m=newm, v=newv), \
        {"grad_norm": gnorm}
