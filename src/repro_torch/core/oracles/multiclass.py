"""Multiclass max-oracle (paper appendix A.1, USPS-style), PyTorch port.

Joint feature map: phi(x, y) = one_hot(y) (x) psi(x) (block layout,
d = C*f).  Loss: 0/1.  The oracle is an explicit argmax over the C class
scores, "trivially cheap": the regime where MP-BCFW must not lose to
BCFW.  A port of ``repro/core/oracles/multiclass.py``; the spec's methods
take a batch of examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ...api.oracle import OracleSpec, build_problem
from ..types import SSVMProblem
from .chain import resolve_device, to_device


@dataclass(frozen=True)
class MulticlassSpec(OracleSpec):
    """0/1-loss multiclass classification over ``data = {"x", "y"}``:
    ``x (n, f)`` float32, ``y (n,)`` int32."""

    num_classes: int

    def dim(self, data: Any) -> int:
        return self.num_classes * int(data["x"].shape[-1])

    def truth(self, ex: Dict[str, Any]):
        return ex["y"]

    def decode(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        return self.decode_scores(w, self.scores(w, ex), ex)

    def scores(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        """Loss-augmented class scores <w_c, x> + [c != y], (B, C)."""
        x, y = ex["x"], ex["y"]
        wc = w.reshape(self.num_classes, x.shape[-1])
        eye = torch.eye(self.num_classes, dtype=x.dtype, device=x.device)
        return x @ wc.T + (1.0 - eye[y.long()])

    def decode_scores(self, w: torch.Tensor, scores: torch.Tensor,
                      ex: Dict[str, Any]) -> torch.Tensor:
        """The first maximal class per row wins, as jnp.argmax."""
        return scores.argmax(dim=1).to(torch.int32)

    def features(self, ex: Dict[str, Any], y) -> torch.Tensor:
        x = ex["x"]
        B, f = x.shape
        out = torch.zeros((B, self.num_classes, f), dtype=x.dtype,
                          device=x.device)
        out.scatter_(1, y.long()[:, None, None].expand(B, 1, f),
                     x[:, None, :])
        return out.reshape(B, -1)

    def loss(self, ex: Dict[str, Any], y) -> torch.Tensor:
        return (y != ex["y"]).to(ex["x"].dtype)

    def meta(self, data: Any):
        return {"num_classes": self.num_classes,
                "f": int(data["x"].shape[-1])}


def make_problem(features, labels, num_classes: int, *,
                 device: Optional[Any] = None) -> SSVMProblem:
    """features: (n, f); labels: (n,) int, as numpy arrays or tensors.
    ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    data = {"x": to_device(features, torch.float32, dev),
            "y": to_device(labels, torch.int32, dev)}
    return build_problem(MulticlassSpec(num_classes), data)
