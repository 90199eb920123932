"""Sequence-labeling max-oracle (paper appendix A.2, OCR-style), PyTorch port.

Loss-augmented Viterbi over a chain CRF with unary features
phi_u(x,y) = sum_l onehot(y_l) (x) x_l and pairwise transition
indicators phi_p(x,y) = sum_l e_{y_l, y_{l+1}}; loss = normalized Hamming.
Sequences are padded to a fixed length L with a validity mask: padded
positions contribute zero score, zero features and zero loss.

:meth:`ChainSpec.decode` computes the unaries with one ``torch.matmul``
and runs the DP in the Viterbi kernel (:func:`repro_torch.kernels.ops
.viterbi_decode`): ``B = 1`` per exact-oracle call, ``B = n`` for the
evaluation sweep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...api.oracle import OracleSpec, build_problem
from ...kernels import ops as kops
from ..types import SSVMProblem


def _one_hot(y: torch.Tensor, C: int, dtype) -> torch.Tensor:
    return F.one_hot(y.long(), C).to(dtype)


@dataclass(frozen=True)
class ChainSpec(OracleSpec):
    """Chain-CRF sequence labeling over ``data = {"x", "y", "mask"}``:
    ``x (n, L, f)`` float32, ``y (n, L)`` int32, ``mask (n, L)`` bool."""

    num_labels: int

    def dim(self, data: Any) -> int:
        f = int(data["x"].shape[-1])
        return self.num_labels * f + self.num_labels * self.num_labels

    def truth(self, ex: Dict[str, Any]):
        return ex["y"]

    def _length(self, ex) -> torch.Tensor:
        return torch.clamp_min(ex["mask"].to(ex["x"].dtype).sum(dim=1), 1.0)

    def decode(self, w: torch.Tensor, ex: Dict[str, Any]) -> torch.Tensor:
        x, y, m = ex["x"], ex["y"], ex["mask"]
        C, f = self.num_labels, x.shape[-1]
        wu = w[: C * f].reshape(C, f)
        wp = w[C * f:].reshape(C, C)
        length = self._length(ex)
        # Loss-augmented unaries: <w_c, x_l> + [c != y_l] / L_i.
        unary = (torch.matmul(x, wu.T)
                 + (1.0 - _one_hot(y, C, x.dtype)) / length[:, None, None])
        return kops.viterbi_decode(unary.contiguous(), wp.contiguous(),
                                   m.contiguous())

    def features(self, ex: Dict[str, Any], y) -> torch.Tensor:
        x, mask = ex["x"], ex["mask"]
        B, C = x.shape[0], self.num_labels
        m = mask.to(x.dtype)
        # Unary part: sum_l onehot(y_l) (x) x_l, masked.
        oh = _one_hot(y, C, x.dtype) * m[:, :, None]              # (B, L, C)
        unary = torch.matmul(oh.transpose(1, 2), x).reshape(B, -1)
        # Pairwise part: transition indicators over valid adjacent pairs.
        pm = (mask[:, :-1] & mask[:, 1:]).to(x.dtype)
        pair = torch.matmul(
            _one_hot(y[:, :-1], C, x.dtype).transpose(1, 2),
            _one_hot(y[:, 1:], C, x.dtype) * pm[:, :, None]).reshape(B, -1)
        return torch.cat([unary, pair], dim=1)

    def loss(self, ex: Dict[str, Any], y) -> torch.Tensor:
        m = ex["mask"].to(ex["x"].dtype)
        return torch.sum((y != ex["y"]) * m, dim=1) / self._length(ex)

    def meta(self, data: Any):
        return {"num_labels": self.num_labels,
                "f": int(data["x"].shape[-1]),
                "L": int(data["x"].shape[-2])}


def resolve_device(device: Optional[Any]) -> torch.device:
    """The caller's device, or CUDA; raises when CUDA is asked for (or
    defaulted to) on a host without it.  Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path")
    return dev


def make_problem(features, labels, mask, num_labels: int, *,
                 device: Optional[Any] = None) -> SSVMProblem:
    """features: (n, L, f); labels: (n, L) int; mask: (n, L) bool, as numpy
    arrays or tensors.  ``device`` defaults to CUDA."""
    dev = resolve_device(device)

    def put(a, dtype):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=dev, dtype=dtype).contiguous()

    data = {"x": put(features, torch.float32),
            "y": put(labels, torch.int32),
            "mask": put(mask, torch.bool)}
    return build_problem(ChainSpec(num_labels), data)
