"""Error-feedback int8 gradient compression (opt-in distributed trick),
PyTorch port of ``repro/optim/compression.py``.

Each gradient leaf is quantized to int8 with a per-leaf scale before the
(all-)reduce; the quantization residual stays local and is added to the
next step's gradient (error feedback preserves convergence).  Trees are
nested dicts of tensors, as the port's parameters.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .adamw import tree_zip


def _quantize(g: torch.Tensor):
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return qi, scale, g - qi.float() * scale


def compress_grads(grads, residual: Optional[Any] = None
                   ) -> Tuple[Any, Any, Any]:
    """Returns (int8 payload, float32 () scales, new float32 residual)."""
    if residual is not None:
        grads = tree_zip(lambda g, r: g.float() + r, grads, residual)
    else:
        grads = tree_zip(lambda g: g.float(), grads)
    out = tree_zip(_quantize, grads)
    return tuple(tree_zip(lambda t, i=i: t[i], out) for i in range(3))


def decompress_grads(payload, scales):
    return tree_zip(lambda qi, s: qi.float() * s, payload, scales)
